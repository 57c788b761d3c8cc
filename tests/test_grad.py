"""Gradient tests: autodiff through refinement + shading vs finite
differences (BASELINE north star: pixel-grad max abs err vs FD ≈ 0)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.diff import render_grad
from ugrt.scene import procedural


def _setup(cfg):
    # Tilted, non-axis-aligned triangle: all normal components nonzero so
    # the |normal| quirk (trace_kernel.cu:241-243) is locally smooth —
    # an axis-aligned triangle sits exactly on the abs() kink.
    sc = procedural.single_triangle()
    sc = dataclasses.replace(
        sc, vertices=np.asarray(
            [[-1.0, -1.1, -3.1], [1.1, -0.9, -2.7], [0.05, 1.2, -3.4]],
            dtype=np.float32))
    spec = cam.CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0.0, 0.0, -1.0),
                          up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
    light = cam.CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0.0, 0.0, -3.0),
                           up=(0, 1, 0), near=0.1, far=100.0)
    aspect = cfg.screen_width / cfg.screen_height
    cc = jnp.asarray(cam.camcoords_from_spec(spec, cfg.fovy_deg, aspect))
    lcc = jnp.asarray(cam.camcoords_from_spec(light, cfg.fovy_deg,
                                              aspect))[None]
    lp = jnp.asarray(np.asarray(light.eye, dtype=np.float32))
    return sc, cc, lcc, lp


def _color_fn(sc, cc, lcc, lp, cfg, use_spot=False):
    cap = cfg.pair_capacity(sc.num_faces)
    faces = jnp.asarray(sc.faces)
    mat_index = jnp.asarray(sc.mat_index)

    def fn(verts, mats):
        return render_grad.render_color(
            verts, mats, faces, mat_index, cc, lcc, lp, cfg=cfg,
            capacity=cap, num_lights=1, use_spot=use_spot)[0]

    return fn


def test_material_gradient_matches_fd(tiny_cfg):
    """Color is linear in materials where unclamped — FD must match
    tightly."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _setup(cfg)
    fn = _color_fn(sc, cc, lcc, lp, cfg)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    loss = lambda m: jnp.sum(fn(verts, m))
    g = jax.grad(loss)(mats)

    eps = 1e-3
    g_np = np.asarray(g)
    for slot in range(6):
        m_p = mats.at[0, slot].add(eps)
        m_m = mats.at[0, slot].add(-eps)
        fd = (float(loss(m_p)) - float(loss(m_m))) / (2 * eps)
        assert abs(fd - g_np[0, slot]) < 1e-2 * max(1.0, abs(fd)), (
            f"slot {slot}: fd={fd} vs ad={g_np[0, slot]}")


def test_vertex_gradient_matches_fd(tiny_cfg):
    """Vertex z-translation changes t and shading smoothly over interior
    pixels; FD on a masked (interior-only) loss must match autodiff."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _setup(cfg)
    fn = _color_fn(sc, cc, lcc, lp, cfg)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    base = fn(verts, mats)
    # Interior mask: pixels that stay hits under ±2e-3 perturbations of
    # any coordinate (away from visibility edges).
    hit = np.asarray(base.sum(-1) > 0)
    from scipy import ndimage  # available? fall back to manual erosion
    try:
        interior = ndimage.binary_erosion(hit, iterations=3)
    except Exception:
        interior = hit
    mask = jnp.asarray(interior[..., None].astype(np.float32))

    loss = lambda v: jnp.sum(fn(v, mats) * mask)
    g = np.asarray(jax.grad(loss)(verts))

    eps = 1e-3
    checks = 0
    for vi in range(3):
        for axis in range(3):
            v_p = verts.at[vi, axis].add(eps)
            v_m = verts.at[vi, axis].add(-eps)
            fd = (float(loss(v_p)) - float(loss(v_m))) / (2 * eps)
            ad = g[vi, axis]
            # float32 render; FD noise scales with loss magnitude
            tol = max(2e-2 * abs(fd), 0.5)
            assert abs(fd - ad) < tol, (
                f"v{vi}.{axis}: fd={fd} ad={ad}")
            checks += 1
    assert checks == 9


def test_render_and_grad_step(tiny_cfg):
    """Full inverse-rendering step: loss decreases along -grad."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _setup(cfg)
    cap = cfg.pair_capacity(sc.num_faces)
    faces = jnp.asarray(sc.faces)
    mat_index = jnp.asarray(sc.mat_index)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    # Target: render with different materials.
    target, _ = render_grad.render_color(
        verts, mats * 0.5, faces, mat_index, cc, lcc, lp, cfg=cfg,
        capacity=cap, num_lights=1, use_spot=False)

    out = render_grad.render_and_grad(
        verts, mats, faces, mat_index, cc, lcc, lp, target, cfg=cfg,
        capacity=cap, num_lights=1, use_spot=False)
    assert float(out["loss"]) > 0
    assert np.abs(np.asarray(out["grad_materials"])).sum() > 0

    lr = 0.5
    mats2 = mats - lr * out["grad_materials"]
    out2 = render_grad.render_and_grad(
        verts, mats2, faces, mat_index, cc, lcc, lp, target, cfg=cfg,
        capacity=cap, num_lights=1, use_spot=False)
    assert float(out2["loss"]) < float(out["loss"])


def test_grad_zero_when_miss(tiny_cfg):
    """Pixels that miss contribute no vertex gradient."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _setup(cfg)
    fn = _color_fn(sc, cc, lcc, lp, cfg)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)
    base = fn(verts, mats)
    missmask = jnp.asarray(
        (np.asarray(base.sum(-1)) == 0)[..., None].astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(fn(v, mats) * missmask))(verts)
    assert float(jnp.abs(g).max()) == 0.0


def _cornell_setup(cfg):
    """Multi-face scene: winners differ across pixels.

    The box is rotated a few degrees so no face is axis-aligned: the
    reference's abs-normal / |N.L| quirks put axis-aligned geometry
    exactly on abs() kinks, where AD subgradients and FD legitimately
    disagree."""
    sc = procedural.cornell_box(subdiv=2)
    a, b = 0.11, 0.07
    rx = np.asarray([[1, 0, 0],
                     [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], dtype=np.float32)
    ry = np.asarray([[np.cos(b), 0, np.sin(b)],
                     [0, 1, 0],
                     [-np.sin(b), 0, np.cos(b)]], dtype=np.float32)
    sc = dataclasses.replace(
        sc, vertices=np.ascontiguousarray(sc.vertices @ (rx @ ry).T))
    spec = cam.CameraSpec(eye=(0.123, 0.071, 2.531),
                          look_at=(-0.037, 0.011, 0.0),
                          up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
    light = cam.CameraSpec(eye=(0.1, 0.85, 0.4),
                           look_at=(0.0, -1.0, 0.3),
                           up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
    aspect = cfg.screen_width / cfg.screen_height
    cc = jnp.asarray(cam.camcoords_from_spec(spec, cfg.fovy_deg, aspect))
    lcc = jnp.asarray(cam.camcoords_from_spec(light, cfg.fovy_deg,
                                              aspect))[None]
    lp = jnp.asarray(np.asarray(light.eye, dtype=np.float32))
    return sc, cc, lcc, lp


def _interior_mask(face_id):
    """Pixels whose winning face matches all neighbors within 3 px.

    Erodes BOTH the hit/miss boundary and face-to-face visibility edges:
    FD across a moving winner boundary measures the color jump (the
    boundary term the stop-grad design intentionally drops), so FD-vs-AD
    comparisons are only meaningful away from every winner edge."""
    fid = np.asarray(face_id)
    m = fid >= 0
    for _ in range(3):
        same = np.ones_like(m)
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            same &= np.roll(fid, sh, ax) == fid
            same &= np.roll(m, sh, ax)
        m = m & same
    return m


def test_cornell_material_gradient_matches_fd(tiny_cfg):
    """FD check where the winning face CHANGES across pixels: per-material
    gradients route through the per-pixel mat_index gather."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _cornell_setup(cfg)
    fn = _color_fn(sc, cc, lcc, lp, cfg)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    loss = lambda m: jnp.sum(fn(verts, m))
    g = np.asarray(jax.grad(loss)(mats))
    assert (np.abs(g).sum(axis=1) > 0).sum() >= 2, (
        "expected gradient flow into at least two materials")

    eps = 1e-3
    for mi in range(min(3, mats.shape[0])):
        for slot in (3, 4):
            fd = (float(loss(mats.at[mi, slot].add(eps)))
                  - float(loss(mats.at[mi, slot].add(-eps)))) / (2 * eps)
            ad = g[mi, slot]
            assert abs(fd - ad) < 5e-2 * max(1.0, abs(fd)), (
                f"mat {mi} slot {slot}: fd={fd} ad={ad}")


def test_cornell_vertex_gradient_matches_fd(tiny_cfg):
    """FD vertex check on the multi-face scene, interior pixels only."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _cornell_setup(cfg)
    fn = _color_fn(sc, cc, lcc, lp, cfg)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)
    from ugrt.grid import build as gbuild
    from ugrt.trace import primary as tprimary
    grid = gbuild.build_perspective_grid(
        verts, jnp.asarray(sc.faces), cc, cfg=cfg,
        capacity=cfg.pair_capacity(sc.num_faces))
    raw = tprimary.trace_primary(verts, jnp.asarray(sc.faces), cc, grid,
                                 cfg)
    mask = jnp.asarray(
        _interior_mask(raw["face_id"])[..., None].astype(np.float32))

    loss = lambda v: jnp.sum(fn(v, mats) * mask)
    g = np.asarray(jax.grad(loss)(verts))
    assert np.abs(g).max() > 0

    # Check the largest-|grad| coordinates, but only where FD itself is
    # converged: a vertex move can flip the winning face at mask pixels
    # (visibility is piecewise constant), and there FD measures the jump,
    # not the derivative.  FD stable across a 4x eps change ⇒ locally
    # smooth ⇒ AD must match.
    def fd_at(vi, axis, eps):
        return (float(loss(verts.at[vi, axis].add(eps)))
                - float(loss(verts.at[vi, axis].add(-eps)))) / (2 * eps)

    flat = np.abs(g).ravel()
    order = np.argsort(-flat)[:8]
    checked = 0
    for lin in order:
        vi, axis = divmod(int(lin), 3)
        fd1 = fd_at(vi, axis, 1e-3)
        fd2 = fd_at(vi, axis, 2.5e-4)
        if abs(fd1 - fd2) > 5e-2 * max(abs(fd1), 1.0):
            continue  # non-smooth point: FD not meaningful
        ad = g[vi, axis]
        tol = max(5e-2 * abs(fd1), 0.5)
        assert abs(fd1 - ad) < tol, f"v{vi}.{axis}: fd={fd1} ad={ad}"
        checked += 1
    assert checked >= 3, f"only {checked} FD-stable coordinates"


def test_shadowed_pixel_gradient_matches_fd(tiny_cfg):
    """FD through the shadow /3 modulation: the mask is stop-gradded
    (piecewise constant) but material gradients of shadowed pixels must
    carry the 1/3 factor."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _cornell_setup(cfg)
    cap = cfg.pair_capacity(sc.num_faces)
    faces = jnp.asarray(sc.faces)
    mat_index = jnp.asarray(sc.mat_index)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    from ugrt.api import renderer as rapi
    out = rapi.render_frame_device(
        verts, faces, mat_index, mats, cc, lcc[0][None], lp,
        cfg=cfg, capacity=cap, num_lights=1, use_spot=False)
    shmask = np.asarray(out["shadowed"]) == 1
    if shmask.sum() == 0:
        import pytest
        pytest.skip("scene produced no shadowed pixels")
    wm = jnp.asarray(shmask[..., None].astype(np.float32))

    def loss(m):
        color, _ = render_grad.render_color(
            verts, m, faces, mat_index, cc, lcc, lp, cfg=cfg,
            capacity=cap, num_lights=1, use_spot=False)
        return jnp.sum(color * wm)

    g = np.asarray(jax.grad(loss)(mats))
    assert np.abs(g).max() > 0
    eps = 1e-3
    flat = np.abs(g).ravel()
    order = np.argsort(-flat)[:3]
    for lin in order:
        mi, slot = divmod(int(lin), 6)
        fd = (float(loss(mats.at[mi, slot].add(eps)))
              - float(loss(mats.at[mi, slot].add(-eps)))) / (2 * eps)
        ad = g[mi, slot]
        assert abs(fd - ad) < 5e-2 * max(1.0, abs(fd)), (
            f"mat {mi} slot {slot}: fd={fd} ad={ad}")


def test_overflow_flag_reaches_caller(tiny_cfg):
    """An undersized pair capacity must surface overflow=True through the
    differentiable path (no silent truncation in training)."""
    cfg = tiny_cfg
    sc, cc, lcc, lp = _cornell_setup(cfg)
    faces = jnp.asarray(sc.faces)
    mat_index = jnp.asarray(sc.mat_index)
    verts = jnp.asarray(sc.vertices)
    mats = jnp.asarray(sc.materials)

    target = jnp.zeros((cfg.screen_height, cfg.screen_width, 3),
                       jnp.float32)
    out = render_grad.render_and_grad(
        verts, mats, faces, mat_index, cc, lcc, lp, target, cfg=cfg,
        capacity=128, num_lights=1, use_spot=False)
    assert bool(out["overflow"]), "tiny capacity must flag overflow"

    ok = render_grad.render_and_grad(
        verts, mats, faces, mat_index, cc, lcc, lp, target, cfg=cfg,
        capacity=cfg.pair_capacity(sc.num_faces), num_lights=1,
        use_spot=False)
    assert not bool(ok["overflow"])
