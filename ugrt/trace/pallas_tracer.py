"""Fused range sweeps for the primary and shadow passes (Pallas, Triton).

The reference traces one CUDA block per 8x8 ray packet and streams the
packet's cell list through shared memory in 64-triangle batches
(the reference's trace_kernel.cu:147-215, light_kernel.cu:120-202).  The
kernels here keep that shape: one Triton program takes one block of
``RAYS`` rays and loops over its own triangle ranges ``CHUNK`` triangles
at a time, keeping the per-ray result in registers.  Every program has
two ranges:

  * ``[lo, hi)`` of a grid's cell-sorted pair table, in the direct
    Möller–Trumbore form (tvec, e1, e2 per pair).  A primary program is
    one cell (one 8x8 tile of one slab), so the range is exactly that
    cell's list.  A shadow program is a block of rays sorted by light
    cell: its cells are one contiguous key range, so its pairs are one
    contiguous range too, and a ray only accepts pairs of its own cell
    (key test).
  * ``[hlo, hhi)`` of the heavy-face table in the coefficient form of
    ugrt.trace.heavy, where the footprint-box test takes the place of
    the key test.

Primary programs keep the (t, face) lex-min, shadow programs the
occlusion OR.  Both forms repeat the operation order of the XLA path
(ugrt.trace.primary.moller_trumbore_t, the shadow chunk body,
ugrt.trace.heavy), so results agree with it.

Tables are component-major ([components, pairs]) so each component of a
chunk is one contiguous load, and are padded by ``CHUNK`` columns:
``pl.ds`` reads a fixed-size chunk, masked past ``hi``, and the padding
keeps that chunk inside the array (the interpreter clamps an
out-of-bounds slice instead of masking it).

The kernels are combinatorial forward only; gradients flow through
ugrt.trace.refine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ugrt.config import RenderConfig

_BIG = 3.0e38  # plain float: a jnp scalar would be a captured const
_MAXI = 2**31 - 1
RAYS = 64       # rays per program: one 8x8 tile
CHUNK = 32      # triangles per loop step
_PARAMS = plt.CompilerParams(num_warps=4, num_stages=2)


def _pad_cols(x, value):
    return jnp.pad(x, ((0, 0), (0, CHUNK)), constant_values=value)


def pack_pairs(vertices, faces, grid, origin):
    """(data f32 [9, P + CHUNK], tags int32 [2, P + CHUNK]) for a grid.

    data rows: tvec = origin - v0 (0:3), e1 (3:6), e2 (6:9) — the staging
    of trace_kernel.cu:149-175 (origin = eye) and light_kernel.cu:144-146
    (origin = light).  tags rows: face id, cell key.  Padding pairs
    (face -1) get zero data, so the determinant test rejects them.
    """
    fidx = jnp.clip(grid.sorted_faces, 0, faces.shape[0] - 1)
    fv = vertices[faces]                                   # [F, 3, 3]
    v0 = fv[:, 0]
    per_face = jnp.concatenate(
        [origin[None, :] - v0, fv[:, 1] - v0, fv[:, 2] - v0], axis=1)
    data = jnp.where((grid.sorted_faces >= 0)[None, :],
                     per_face.T[:, fidx], 0.0)             # [9, P]
    tags = jnp.stack([grid.sorted_faces, grid.sorted_keys])
    return _pad_cols(data, 0.0), _pad_cols(tags.astype(jnp.int32), -1)


def pack_heavy(co):
    """(data f32 [10, H + CHUNK], tags int32 [5, H + CHUNK]) for the
    heavy list (ugrt.trace.heavy.HeavyCoeffs; None: no heavy list).

    data rows: a (0:3), b (3:6), c (6:9), k (9).  tags rows: face id and
    the footprint box (gxmin, gxmax, gymin, gymax).  Only ``[0,
    heavy_count)`` is ever read, so dead slots need no masking here.
    """
    if co is None:
        data = jnp.zeros((10, 0), jnp.float32)
        tags = jnp.zeros((5, 0), jnp.int32)
    else:
        data = jnp.concatenate([co.a, co.b, co.c, co.k[:, None]],
                               axis=1).T
        tags = jnp.concatenate([co.face[:, None], co.ranges], axis=1).T
    return _pad_cols(data, 0.0), _pad_cols(tags.astype(jnp.int32), -1)


def _chunk(ref, rows, start, live, other):
    """Rows of a component-major table for one chunk, each [1, CHUNK]."""
    return [plt.load(ref.at[r, pl.ds(start, CHUNK)], mask=live,
                     other=other)[None, :] for r in rows]


def _loop(lo, hi, body, carry):
    """fori over the CHUNK-wide steps of [lo, hi); body(start, live, c)."""
    lane = jnp.arange(CHUNK, dtype=jnp.int32)

    def step(i, c):
        start = lo + i * CHUNK
        return body(start, start + lane < hi, c)

    n = jnp.maximum(hi - lo + (CHUNK - 1), 0) // CHUNK
    return jax.lax.fori_loop(0, n, step, carry)


def _direct_t(d, tri, cfg: RenderConfig, abs_t: bool):
    """moller_trumbore_t, op for op: t [RAYS, CHUNK], 0 where rejected."""
    dx, dy, dz = d
    tvx, tvy, tvz, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / det
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    if abs_t:
        t = jnp.abs(t)
    reject = ((jnp.abs(det) < jnp.float32(cfg.epsilon))
              | (u < 0) | (u > 1) | (v < 0) | (u + v > 1))
    return jnp.where(reject, jnp.float32(0.0), t)


def _coeff_t(d, co, cfg: RenderConfig):
    """ugrt.trace.heavy's coefficient form, op for op: (t, reject)."""
    dx, dy, dz = d
    a0, a1, a2, b0, b1, b2, c0, c1, c2, k = co
    det = dx * a0 + dy * a1 + dz * a2
    up = dx * b0 + dy * b1 + dz * b2
    vp = dx * c0 + dy * c1 + dz * c2
    det2 = det * det
    ud = up * det
    vd = vp * det
    inv = 1.0 / det
    t = k * inv
    reject = ((jnp.abs(det) < jnp.float32(cfg.epsilon))
              | (ud < 0) | (ud > det2) | (vd < 0) | (ud + vd > det2))
    return t, reject


def _in_box(gx, gy, box):
    x0, x1, y0, y1 = box
    return (gx >= x0) & (gx <= x1) & (gy >= y0) & (gy <= y1)


def _lexmin(carry, t, face):
    """Fold a [RAYS, CHUNK] candidate block into the (t, face) lex-min."""
    tbest, fbest = carry
    tmin = jnp.min(t, axis=1)
    fmin = jnp.min(jnp.where(t == tmin[:, None], face, _MAXI), axis=1)
    take = (tmin < tbest) | ((tmin == tbest) & (fmin < fbest))
    return jnp.where(take, tmin, tbest), jnp.where(take, fmin, fbest)


def _ray_rows(ref, rows, r0):
    return [ref[r, pl.ds(r0, RAYS)][:, None] for r in rows]


def _primary_kernel(rng_ref, pair_ref, ptag_ref, heavy_ref, htag_ref,
                    ray_ref, rgrid_ref, t_ref, f_ref, *,
                    cfg: RenderConfig, rep: int):
    g = pl.program_id(0)
    r0 = (g // rep) * RAYS
    d = _ray_rows(ray_ref, range(3), r0)
    gx, gy = _ray_rows(rgrid_ref, range(2), r0)

    def cell_body(start, live, c):
        tri = _chunk(pair_ref, range(9), start, live, 0.0)
        (face,) = _chunk(ptag_ref, [0], start, live, -1)
        t = _direct_t(d, tri, cfg, cfg.quirks.abs_t)
        t = jnp.where(live[None, :] & (t > 0), t, jnp.float32(_BIG))
        return _lexmin(c, t, face)

    def heavy_body(start, live, c):
        co = _chunk(heavy_ref, range(10), start, live, 0.0)
        face, *box = _chunk(htag_ref, range(5), start, live, -1)
        t, reject = _coeff_t(d, co, cfg)
        if cfg.quirks.abs_t:
            t = jnp.abs(t)
        reject = (reject | (t <= 0) | ~live[None, :]
                  | ~_in_box(gx, gy, box))
        return _lexmin(c, jnp.where(reject, jnp.float32(_BIG), t), face)

    best = (jnp.full((RAYS,), _BIG, jnp.float32),
            jnp.full((RAYS,), _MAXI, jnp.int32))
    best = _loop(rng_ref[0, g], rng_ref[1, g], cell_body, best)
    tbest, fbest = _loop(rng_ref[2, g], rng_ref[3, g], heavy_body, best)
    t_ref[pl.ds(g * RAYS, RAYS)] = tbest
    f_ref[pl.ds(g * RAYS, RAYS)] = jnp.where(tbest >= _BIG, _MAXI, fbest)


def _shadow_kernel(rng_ref, pair_ref, ptag_ref, heavy_ref, htag_ref,
                   ray_ref, rint_ref, org_ref, sh_ref, *,
                   cfg: RenderConfig):
    g = pl.program_id(0)
    r0 = g * RAYS
    d = _ray_rows(ray_ref, range(3), r0)
    (dist_pt,) = _ray_rows(ray_ref, [3], r0)
    key, gx, gy = _ray_rows(rint_ref, range(3), r0)
    lx, ly, lz = org_ref[0], org_ref[1], org_ref[2]
    eps = jnp.float32(cfg.shadow_epsilon)

    def accept(t):
        # intersectTri accept: nonzero t below 999999.9
        # (light_kernel.cu:43-47); negative t passes per quirk.
        hit = (t != 0) & (t < jnp.float32(999999.9))
        if not cfg.quirks.shadow_accept_negative_t:
            hit = hit & (t > 0)
        return hit

    def fold(acc, sh):
        return jnp.maximum(acc, jnp.max(sh.astype(jnp.int32), axis=1))

    def cell_body(start, live, acc):
        tri = _chunk(pair_ref, range(9), start, live, 0.0)
        (pkey,) = _chunk(ptag_ref, [1], start, live, -1)
        t = _direct_t(d, tri, cfg, abs_t=False)
        dlx = (lx + t * d[0]) - lx
        dly = (ly + t * d[1]) - ly
        dlz = (lz + t * d[2]) - lz
        dist_occ = jnp.sqrt(dlx * dlx + dly * dly + dlz * dlz)
        sh = (accept(t) & (dist_occ + eps < dist_pt)
              & live[None, :] & (pkey == key))
        return fold(acc, sh)

    def heavy_body(start, live, acc):
        co = _chunk(heavy_ref, range(10), start, live, 0.0)
        _, *box = _chunk(htag_ref, range(5), start, live, -1)
        t, reject = _coeff_t(d, co, cfg)
        ox, oy, oz = t * d[0], t * d[1], t * d[2]
        dist_occ = jnp.sqrt(ox * ox + oy * oy + oz * oz)
        sh = (~reject & accept(t) & (dist_occ + eps < dist_pt)
              & live[None, :] & (key >= 0) & _in_box(gx, gy, box))
        return fold(acc, sh)

    acc = jnp.zeros((RAYS,), jnp.int32)
    acc = _loop(rng_ref[0, g], rng_ref[1, g], cell_body, acc)
    acc = _loop(rng_ref[2, g], rng_ref[3, g], heavy_body, acc)
    sh_ref[pl.ds(r0, RAYS)] = acc


def _call(kernel, n_programs, out_shape, interpret, name, *args):
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(n_programs,),
        compiler_params=_PARAMS, interpret=interpret, name=name)(*args)


@functools.partial(jax.jit, static_argnames=("cfg", "rep", "interpret"))
def primary_sweep(ranges, pairs, heavy, rays, ray_grid, *,
                  cfg: RenderConfig, rep: int = 1,
                  interpret: bool = False):
    """Per-ray (min t, winner face) for every program's two ranges.

    ranges: int32 [4, G] rows lo, hi, hlo, hhi; program g sweeps pair
    columns [lo, hi) and heavy columns [hlo, hhi).  pairs / heavy: the
    (data, tags) tables of pack_pairs / pack_heavy.  rays: f32 [3,
    N] directions, program g reading rays [(g // rep) * RAYS, ... +
    RAYS) (rep = slabs per tile); ray_grid: int32 [2, N] the ray's own
    grid cell (gx, gy) for the footprint test.  Returns t f32 [G * RAYS]
    (3e38 where no hit) and face int32 [G * RAYS] (2^31 - 1 where none).
    """
    g = ranges.shape[1]
    assert rays.shape[1] * rep == g * RAYS, (rays.shape, g, rep)
    kernel = functools.partial(_primary_kernel, cfg=cfg, rep=rep)
    out = (jax.ShapeDtypeStruct((g * RAYS,), jnp.float32),
           jax.ShapeDtypeStruct((g * RAYS,), jnp.int32))
    return _call(kernel, g, out, interpret, "primary_sweep", ranges,
                 *pairs, *heavy, rays, ray_grid)


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def shadow_sweep(ranges, pairs, heavy, rays, ray_int, origin, *,
                 cfg: RenderConfig, interpret: bool = False):
    """Per-ray occlusion flags int32 [N] for consecutive blocks of RAYS
    rays (the last block may be partial).

    ranges, pairs, heavy: as primary_sweep, with pair tags row 1 (the
    cell key) tested against the ray's key; G = ceil(N / RAYS).  rays:
    f32 [4, N] (direction from the light, light-to-point distance);
    ray_int: int32 [3, N] (cell key, -1 for rays outside the light grid;
    gx; gy).  origin: f32 [3] light position.
    """
    g = ranges.shape[1]
    n = rays.shape[1]
    assert -(-n // RAYS) == g, (n, g)
    pad = g * RAYS - n
    rays = jnp.pad(rays, ((0, 0), (0, pad)))
    ray_int = jnp.pad(ray_int, ((0, 0), (0, pad)), constant_values=-1)
    kernel = functools.partial(_shadow_kernel, cfg=cfg)
    out = jax.ShapeDtypeStruct((g * RAYS,), jnp.int32)
    return _call(kernel, g, out, interpret, "shadow_sweep", ranges,
                 *pairs, *heavy, rays, ray_int, origin)[:n]
