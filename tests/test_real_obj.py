"""Real-OBJ end-to-end evidence.

Every other full-pipeline test feeds procedural arrays straight to the
renderer; the reference is file-driven (scene.h:141-334 + the custom
material file, scene.h:370-439).  These tests write a ~50k-triangle
interior scene to disk with the deterministic OBJ writer, load it back
through BOTH parsers (Python obj_loader and the native C++ fast path),
and push the file-loaded scene through the full 512^2 shadowed pipeline
against the CPU oracle.
"""

import dataclasses

import numpy as np
import pytest

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.ref import oracle
from ugrt.scene import model as smodel
from ugrt.scene import procedural


@pytest.fixture(scope="module")
def big_scene():
    sc = procedural.cathedral(num_faces_target=52000)
    assert sc.num_faces >= 50000   # ">= 50k tris" evidence bar
    return sc


@pytest.fixture(scope="module")
def obj_path(big_scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("objscene")
    p = str(d / "cath.obj")
    smodel.write_obj(p, big_scene)
    smodel.write_material_file(str(d / "cath.mat"), big_scene.materials)
    return p


def test_obj_roundtrip_python_parser(big_scene, obj_path):
    sc = smodel.load_scene(obj_path, prefer_native=False)
    assert sc.num_faces == big_scene.num_faces
    np.testing.assert_array_equal(sc.vertices, big_scene.vertices)
    np.testing.assert_array_equal(sc.faces, big_scene.faces)
    np.testing.assert_array_equal(sc.mat_index, big_scene.mat_index)
    np.testing.assert_allclose(sc.materials, big_scene.materials,
                               rtol=0, atol=0)


def test_obj_roundtrip_native_parser(big_scene, obj_path):
    from ugrt.scene import native
    assert native.available(), (
        "native parser not built — run make -C native")
    mat_path = obj_path.rsplit("/", 1)[0] + "/cath.mat"
    sc = smodel.load_scene(obj_path, material_path=mat_path,
                           prefer_native=True)
    np.testing.assert_array_equal(sc.vertices, big_scene.vertices)
    np.testing.assert_array_equal(sc.faces, big_scene.faces)
    np.testing.assert_array_equal(sc.mat_index, big_scene.mat_index)
    np.testing.assert_array_equal(sc.materials, big_scene.materials)


def test_real_obj_render_512_matches_oracle(obj_path):
    """File-loaded 50k-tri scene through the full 512^2 pipeline
    (perspective grid + primary + spherical-grid shadow pass + spot
    shade + /3 shadows), u8 image bitwise vs the CPU oracle.  This also
    exercises the shadow work-capacity factors (shadow.py) on a
    file-loaded geometry rather than in-memory procedural arrays."""
    import jax.numpy as jnp

    from ugrt.api.renderer import render_frame_device

    mat_path = obj_path.rsplit("/", 1)[0] + "/cath.mat"
    sc = smodel.load_scene(obj_path, material_path=mat_path)
    cfg = dataclasses.replace(RenderConfig(), screen_width=512,
                              screen_height=512, grid_x=64, grid_y=64)
    spec = cam.CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                          up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
    light = cam.CameraSpec(eye=(14.0, 13.0, 8.0),
                           look_at=(14.0, 13.0, 0.0),
                           up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
    cc = cam.camcoords_from_spec(spec, cfg.fovy_deg, 1.0)
    lcc = cam.camcoords_from_spec(light, cfg.fovy_deg, 1.0)
    lp = np.asarray(light.eye, dtype=np.float32)

    ores = oracle.render_frame(sc, spec, [light], lp, cfg, use_spot=True)

    cap = cfg.pair_capacity(sc.num_faces)
    out = render_frame_device(
        jnp.asarray(sc.vertices), jnp.asarray(sc.faces),
        jnp.asarray(sc.mat_index), jnp.asarray(sc.materials),
        jnp.asarray(cc), jnp.asarray(lcc)[None], jnp.asarray(lp),
        cfg=cfg, capacity=cap, num_lights=1, use_spot=True)
    assert not bool(out["overflow"]), "static capacity overflow at 512^2"
    np.testing.assert_array_equal(np.asarray(out["image"]), ores["image"])
    # The scene must actually produce hits and shadows at this scale.
    assert int(np.asarray(out["shadowed"]).sum()) > 1000
    assert (np.asarray(out["primary"]["face_id"]) >= 0).mean() > 0.5
