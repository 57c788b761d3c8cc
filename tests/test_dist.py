"""Sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ugrt.core import camera as cam
from ugrt.diff import render_grad
from ugrt.dist import mesh as dmesh


def _inputs(cfg, scene, camera_spec, light_spec):
    aspect = cfg.screen_width / cfg.screen_height
    cc = jnp.asarray(cam.camcoords_from_spec(camera_spec, cfg.fovy_deg,
                                             aspect))
    lcc = jnp.asarray(cam.camcoords_from_spec(light_spec, cfg.fovy_deg,
                                              aspect))[None]
    lp = jnp.asarray(np.asarray(light_spec.eye, dtype=np.float32))
    return (jnp.asarray(scene.vertices), jnp.asarray(scene.materials),
            jnp.asarray(scene.faces), jnp.asarray(scene.mat_index),
            cc, lcc, lp)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must set 8 host devices"
    return dmesh.make_mesh()


def test_sharded_render_matches_single_device(small_cfg, cornell,
                                              generic_camera,
                                              generic_light, mesh8):
    cfg = small_cfg
    verts, mats, faces, mat_index, cc, lcc, lp = _inputs(
        cfg, cornell, generic_camera, generic_light)
    cap = cfg.pair_capacity(cornell.num_faces)

    single, _ = render_grad.render_color(
        verts, mats, faces, mat_index, cc, lcc, lp, cfg=cfg, capacity=cap,
        num_lights=1, use_spot=True)

    render = dmesh.sharded_render(mesh8, cfg=cfg, capacity=cap,
                                  num_lights=1, use_spot=True)
    sharded, overflow = render(verts, mats, faces, mat_index, cc, lcc, lp)

    assert not bool(overflow)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-5, atol=1e-5)


def test_sharded_grads_match_single_device(tiny_cfg, cornell,
                                           generic_camera, generic_light,
                                           mesh8):
    cfg = tiny_cfg
    verts, mats, faces, mat_index, cc, lcc, lp = _inputs(
        cfg, cornell, generic_camera, generic_light)
    cap = cfg.pair_capacity(cornell.num_faces)

    target, _ = render_grad.render_color(
        verts, mats * 0.7, faces, mat_index, cc, lcc, lp, cfg=cfg,
        capacity=cap, num_lights=1, use_spot=False)

    # Single-device reference grads.
    def loss_fn(v, m):
        color, _ = render_grad.render_color(
            v, m, faces, mat_index, cc, lcc, lp, cfg=cfg, capacity=cap,
            num_lights=1, use_spot=False)
        return jnp.sum((color - target) ** 2) / (3.0 * cfg.image_size)

    loss1, (gv1, gm1) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        verts, mats)

    step = dmesh.sharded_train_step(mesh8, cfg=cfg, capacity=cap,
                                    num_lights=1, use_spot=False)
    loss8, gv8, gm8, ovf8 = step(verts, mats, faces, mat_index, cc, lcc,
                                 lp, target)

    assert not bool(ovf8)
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gv8), np.asarray(gv1),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gm8), np.asarray(gm1),
                               rtol=1e-4, atol=1e-6)


def test_sharded_windowed_matches_single_device(tiny_cfg, cornell,
                                                generic_camera,
                                                generic_light, mesh8):
    """Windowed light-grid mode across the mesh: the per-strip angle
    windows reduce (pmin/pmax) to exactly the single-device window, so
    the sharded image must match the single-device windowed render."""
    import dataclasses

    cfg = dataclasses.replace(tiny_cfg, light_grid_mode="windowed")
    verts, mats, faces, mat_index, cc, lcc, lp = _inputs(
        cfg, cornell, generic_camera, generic_light)
    cap = cfg.pair_capacity(cornell.num_faces)

    single, ovf1 = render_grad.render_color(
        verts, mats, faces, mat_index, cc, lcc, lp, cfg=cfg, capacity=cap,
        num_lights=1, use_spot=True)
    render = dmesh.sharded_render(mesh8, cfg=cfg, capacity=cap,
                                  num_lights=1, use_spot=True)
    sharded, ovf8 = render(verts, mats, faces, mat_index, cc, lcc, lp)

    assert not bool(ovf1) and not bool(ovf8)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-5, atol=1e-5)


def test_sharded_pallas_matches_sharded_xla(tiny_cfg, cornell,
                                            generic_camera, generic_light,
                                            mesh8):
    """The multi-device path runs the fused kernel: sharded kernel
    (interpreted) render == sharded XLA render, bitwise."""
    cfg = tiny_cfg
    verts, mats, faces, mat_index, cc, lcc, lp = _inputs(
        cfg, cornell, generic_camera, generic_light)
    cap = cfg.pair_capacity(cornell.num_faces)

    r_x = dmesh.sharded_render(mesh8, cfg=cfg, capacity=cap,
                               num_lights=1, use_spot=True)
    r_p = dmesh.sharded_render(mesh8, cfg=cfg, capacity=cap,
                               num_lights=1, use_spot=True,
                               trace_backend="pallas", interpret=True)
    img_x = np.asarray(r_x(verts, mats, faces, mat_index, cc, lcc, lp)[0])
    img_p = np.asarray(r_p(verts, mats, faces, mat_index, cc, lcc, lp)[0])
    np.testing.assert_array_equal(img_p, img_x)
