"""Fused range-sweep kernel tests (ugrt.trace.pallas_tracer).

On the CPU the kernel runs in the Pallas interpreter (interpret=True):
its parity with the XLA path, its wrapper's ranges and padding against
a NumPy reference, and the backend choice.  The compiled kernel is
checked on the card by the ``gpu``-marked test below and by
chip_smoke.py's parity phase.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.trace import pallas_tracer as pt
from ugrt.trace import primary as tprim
from ugrt.trace import shadow as tshadow


def _cc(spec, cfg):
    return jnp.asarray(cam.camcoords_from_spec(
        spec, cfg.fovy_deg, cfg.screen_width / cfg.screen_height))


def test_pallas_primary_matches_xla(small_cfg, cornell, generic_camera):
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    cap = cfg.pair_capacity(cornell.num_faces)
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    grid8 = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap,
                                          align=8)
    res_x = tprim.trace_primary(v, f, cc, grid8, cfg)
    res_p = tprim.trace_primary(v, f, cc, grid8, cfg, backend="pallas",
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(res_p["face_id"]),
                                  np.asarray(res_x["face_id"]))
    np.testing.assert_array_equal(np.asarray(res_p["t"]),
                                  np.asarray(res_x["t"]))


def test_aligned_grid_matches_unaligned_semantics(small_cfg, cornell,
                                                  generic_camera):
    """align=8 only relocates segments; per-cell real contents match."""
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    cap = cfg.pair_capacity(cornell.num_faces)
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    g1 = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    g8 = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap,
                                       align=8)
    np.testing.assert_array_equal(np.asarray(g1.cell_count),
                                  np.asarray(g8.cell_count))
    c1 = np.asarray(g1.cell_count)
    o1 = np.asarray(g1.cell_offset)
    o8 = np.asarray(g8.cell_offset)
    s1 = np.asarray(g1.sorted_faces)
    s8 = np.asarray(g8.sorted_faces)
    assert (o8 % 8 == 0).all()
    for c in range(0, cfg.num_cells, 37):  # sample cells
        n = c1[c]
        np.testing.assert_array_equal(s1[o1[c]:o1[c] + n],
                                      s8[o8[c]:o8[c] + n])


def test_pallas_heavy_primary_matches_xla(small_cfg, cornell):
    """The kernel's heavy range replicates ugrt.trace.heavy's op order
    exactly: results must be bitwise equal, exercised with a camera
    inside the box so behind-the-eye walls land in the heavy list."""
    cfg = small_cfg
    spec = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                          up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
    cc = _cc(spec, cfg)
    cap = cfg.pair_capacity(cornell.num_faces) * 16
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    # A mostly dead (default capacity) and a mostly live heavy table.
    for hcap in (cfg.heavy_capacity, 128):
        c = dataclasses.replace(cfg, heavy_capacity=hcap)
        grid = gbuild.build_perspective_grid(v, f, cc, cfg=c,
                                             capacity=cap,
                                             heavy_threshold=16)
        assert int(grid.heavy_count) > 0
        res_x = tprim.trace_primary(v, f, cc, grid, c)
        res_p = tprim.trace_primary(v, f, cc, grid, c, backend="pallas",
                                    interpret=True)
        np.testing.assert_array_equal(np.asarray(res_p["face_id"]),
                                      np.asarray(res_x["face_id"]))
        np.testing.assert_array_equal(np.asarray(res_p["t"]),
                                      np.asarray(res_x["t"]))


def test_pallas_heavy_shadow_matches_xla(small_cfg, cornell,
                                         generic_camera, generic_light):
    """Kernel heavy shadow occlusion == heavy_shadowed (XLA), exactly:
    the kernel's heavy range repeats heavy_shadowed's op order."""
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    lcc = _cc(generic_light, cfg)
    cap = cfg.pair_capacity(cornell.num_faces) * 16
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    prim = tprim.trace_primary(v, f, cc, grid, cfg)
    lg = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap,
                                     heavy_threshold=4)
    assert int(lg.heavy_count) > 0
    sh_x, _ = tshadow.trace_shadow(v, f, lcc, lg, prim, cc[:3], cfg)
    sh_p, _ = tshadow.trace_shadow(v, f, lcc, lg, prim, cc[:3], cfg,
                                   backend="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(sh_x), np.asarray(sh_p))


def test_pallas_multi_slab_matches_xla(cornell, generic_camera,
                                       generic_light):
    """NS=4 through both kernel sweeps: one program per (tile, slab) in
    the primary pass, one sweep per slab in the shadow pass.  Both must
    match XLA bitwise (identical op order per slab)."""
    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8,
                              num_slabs=4)
    cc = _cc(generic_camera, cfg)
    lcc = _cc(generic_light, cfg)
    cap = cfg.pair_capacity(cornell.num_faces)
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap,
                                         align=8)
    res_x = tprim.trace_primary(v, f, cc, grid, cfg)
    res_p = tprim.trace_primary(v, f, cc, grid, cfg, backend="pallas",
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(res_p["face_id"]),
                                  np.asarray(res_x["face_id"]))
    np.testing.assert_array_equal(np.asarray(res_p["t"]),
                                  np.asarray(res_x["t"]))
    # Slab binning actually spreads pairs across slabs on this scene.
    occupied = [
        int(np.asarray(grid.cell_count)[s::cfg.num_slabs].sum())
        for s in range(cfg.num_slabs)]
    assert sum(1 for o in occupied if o > 0) >= 2, occupied

    lg = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap,
                                     align=8)
    sh_x, _ = tshadow.trace_shadow(v, f, lcc, lg, res_x, cc[:3], cfg)
    sh_p, _ = tshadow.trace_shadow(v, f, lcc, lg, res_x, cc[:3], cfg,
                                   backend="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(sh_x), np.asarray(sh_p))


def test_pallas_shadow_matches_xla(small_cfg, cornell, generic_camera,
                                   generic_light):
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    lcc = _cc(generic_light, cfg)
    cap = cfg.pair_capacity(cornell.num_faces)
    v = jnp.asarray(cornell.vertices)
    f = jnp.asarray(cornell.faces)

    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    prim = tprim.trace_primary(v, f, cc, grid, cfg)

    lg1 = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap)
    sh_x, _ = tshadow.trace_shadow(v, f, lcc, lg1, prim, cc[:3], cfg)

    lg8 = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap,
                                      align=8)
    sh_p, _ = tshadow.trace_shadow(v, f, lcc, lg8, prim, cc[:3], cfg,
                                   backend="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(sh_x), np.asarray(sh_p))


def _np_direct_t(d, tri, eps=1e-21):
    """NumPy moller_trumbore_t for rays d [R, 3] and tri [9, K]."""
    tv, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    d = d[:, None, :]
    pv = np.cross(d, e2[None])
    det = (e1[None] * pv).sum(-1)
    with np.errstate(all="ignore"):
        inv = np.float32(1.0) / det
        u = (tv[None] * pv).sum(-1) * inv
        qv = np.cross(tv, e1)[None]
        v = (d * qv).sum(-1) * inv
        t = (e2[None] * qv).sum(-1) * inv
    reject = (np.abs(det) < eps) | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
    return np.where(reject, np.float32(0.0), t).astype(np.float32)


def _sweep_case(n_pairs, seed=0):
    """Random triangles in front of an origin at 0 and rays toward them."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_pairs, 3)).astype(np.float32)
    v0[:, 2] += 4.0
    e1 = rng.uniform(-1, 1, (n_pairs, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_pairs, 3)).astype(np.float32)
    tri = np.concatenate([-v0, e1, e2], axis=1).T.astype(np.float32)
    return rng, tri


# (ranges as (lo, hi) per program, number of pairs): an empty range
# (lo == hi), ranges spanning many CHUNK steps, a range ending at the
# table's last column (its last chunk reads the padding).
_RANGES = {
    "empty": ([(5, 5), (0, 0)], 40),
    "many_chunks": ([(0, 300), (17, 290)], 300),
    "table_end": ([(250, 300), (299, 300)], 300),
}


@pytest.mark.parametrize("case", sorted(_RANGES))
def test_primary_sweep_ranges_match_numpy(case):
    ranges, n_pairs = _RANGES[case]
    rng, tri = _sweep_case(n_pairs)
    g = len(ranges)
    d = rng.normal(0, 0.15, (g * pt.RAYS, 3)).astype(np.float32)
    d[:, 2] = 1.0
    faces = np.arange(n_pairs, dtype=np.int32)
    tags = np.stack([faces, np.zeros_like(faces)])
    table = (jnp.pad(jnp.asarray(tri), ((0, 0), (0, pt.CHUNK))),
             jnp.pad(jnp.asarray(tags), ((0, 0), (0, pt.CHUNK)),
                     constant_values=-1))
    rng_arr = np.zeros((4, g), np.int32)
    rng_arr[:2] = np.asarray(ranges).T
    cfg = RenderConfig()
    t, f = pt.primary_sweep(
        jnp.asarray(rng_arr), table, pt.pack_heavy(None), jnp.asarray(d.T),
        jnp.zeros((2, g * pt.RAYS), jnp.int32), cfg=cfg, interpret=True)
    t, f = np.asarray(t), np.asarray(f)
    for p, (lo, hi) in enumerate(ranges):
        rays = slice(p * pt.RAYS, (p + 1) * pt.RAYS)
        tt = np.abs(_np_direct_t(d[rays], tri[:, lo:hi]))
        tt = np.where(tt > 0, tt, np.float32(3e38))
        want_t = tt.min(axis=1) if hi > lo else np.full(pt.RAYS, 3e38)
        want_f = np.where(want_t < 3e38,
                          lo + (tt.argmin(axis=1) if hi > lo else 0),
                          2**31 - 1)
        np.testing.assert_array_equal(f[rays], want_f)
        np.testing.assert_allclose(t[rays], want_t, rtol=1e-5)
    if case != "empty":
        assert (f < 2**31 - 1).any(), "case exercises no hit"


def test_shadow_sweep_partial_block_matches_numpy():
    """A ray count that is not a multiple of RAYS: the wrapper pads the
    last block with rays that never hit and trims the result."""
    n_pairs, n = 200, pt.RAYS + 37
    rng, tri = _sweep_case(n_pairs, seed=1)
    d = rng.normal(0, 0.15, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(3.0, 6.0, n).astype(np.float32)
    key = rng.integers(0, 2, n).astype(np.int32)
    key[::9] = -1                                   # outside the grid
    pkey = rng.integers(0, 2, n_pairs).astype(np.int32)
    tags = np.stack([np.arange(n_pairs, dtype=np.int32), pkey])
    table = (jnp.pad(jnp.asarray(tri), ((0, 0), (0, pt.CHUNK))),
             jnp.pad(jnp.asarray(tags), ((0, 0), (0, pt.CHUNK)),
                     constant_values=-1))
    ranges = np.array([[0, 0], [n_pairs, 120], [0, 0], [0, 0]], np.int32)
    rays = np.concatenate([d, dist[:, None]], axis=1).T
    ray_int = np.stack([key, key * 0, key * 0])
    cfg = RenderConfig()
    sh = np.asarray(pt.shadow_sweep(
        jnp.asarray(ranges), table, pt.pack_heavy(None), jnp.asarray(rays),
        jnp.asarray(ray_int), jnp.zeros(3, jnp.float32), cfg=cfg,
        interpret=True))
    assert sh.shape == (n,)
    want = np.zeros(n, np.int32)
    for b, (lo, hi) in enumerate(ranges[:2].T):
        r = slice(b * pt.RAYS, min((b + 1) * pt.RAYS, n))
        t = _np_direct_t(d[r], tri[:, lo:hi])
        occ = t[..., None] * d[r][:, None, :]
        dist_occ = np.sqrt((occ * occ).sum(-1))
        hit = ((t != 0) & (t < 999999.9) & (dist_occ + 1e-3 < dist[r, None])
               & (pkey[lo:hi][None] == key[r, None]))
        want[r] = hit.any(axis=1)
    np.testing.assert_array_equal(sh, want)
    assert 0 < want.sum() < n


@pytest.mark.parametrize("platform,want", [
    ("gpu", "pallas"), ("cpu", "xla"), ("rocm", None)])
def test_default_trace_backend(monkeypatch, platform, want):
    from ugrt.trace import default_trace_backend

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(RuntimeError):
            default_trace_backend()
    else:
        assert default_trace_backend() == want


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU target")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The kernel as compiled for the card against the XLA path at
    256^2 with the reference light grid (chip_smoke.py's parity phase
    runs the windowed flagship at 1024^2; at 256^2 / 8k faces the
    windowed light grid overflows its pair capacity)."""
    from ugrt.api import flagship

    cfg = flagship.config(size=256, light_grid_mode="reference")
    r = flagship.trace_both(cfg, flagship.inputs(cfg, num_faces=8000))
    assert not r["overflow"]
    np.testing.assert_array_equal(r["face_k"], r["face_x"])
    np.testing.assert_array_equal(r["t_k"], r["t_x"])
    flips = (r["shadow_k"] != r["shadow_x"]).sum()
    assert flips <= flagship.SHADOW_PX_BOUND
