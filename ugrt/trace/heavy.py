"""Dense sweep over the global heavy-face list (two-level grid).

Faces whose clip-space footprint covers >= cfg.heavy_threshold cells are
pulled out of the per-cell pair lists (ugrt.grid.build.DeviceGrid) and
swept densely for every ray here.  The candidate union per ray is
unchanged versus the reference, which duplicates these faces into every
cell's list (/root/reference/frustum_grid.h:254 reallocates the pair
buffer to fit); winner selection combines via (t, face-id) lex-min which
equals the reference's strict-< scan over its face-ascending merged cell
list (trace_kernel.cu:181-204 with CUDPP's stable sort).

Math: all primary rays share one origin (the eye), and all of
a light's shadow rays share the light position, so Möller–Trumbore
collapses to three dot products of the ray direction with per-face
constant vectors plus one per-face scalar:

    pvec = d x e2            det = e1.pvec = d.(e2 x e1)     = d.a
    u*det = tvec.pvec        = d.(e2 x tvec)                 = d.b
    qvec = tvec x e1         v*det = d.qvec                  = d.c
    t*det = e2.qvec          = k            (constant per face)

i.e. [det, u', v'] = d @ [a b c]^T — a rank-3 contraction (written as
broadcast multiply-adds) at ~1/3 the flops of the direct form.  v' and k are bitwise equal
to the reference's operation order; det and u are the same real-number
value with different f32 rounding (scalar triple-product reassociation),
so winners can differ only where two candidates are within an ulp —
documented divergence, exercised by the parity tests on scenes without
heavy faces (bitwise) and allclose tests on scenes with them.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core.vecmath import cross, dot

# numpy scalars, NOT jnp: module-level device arrays get hoisted as hidden
# executable parameters under jax 0.9 simplified-jaxpr-constants, and the
# pjit C++ fastpath then drops them on re-execution.
_BIG = np.float32(3.0e38)
_MAXF = np.int32(2**31 - 1)


class HeavyCoeffs(NamedTuple):
    """Per-heavy-face triple-product coefficients for one ray origin."""

    a: jax.Array      # [H, 3] e2 x e1      (det = d.a)
    b: jax.Array      # [H, 3] e2 x tvec    (u*det = d.b)
    c: jax.Array      # [H, 3] tvec x e1    (v*det = d.c; == qvec)
    k: jax.Array      # [H]    e2.qvec      (t*det)
    face: jax.Array   # [H] int32 face id (-1 pad)
    live: jax.Array   # [H] bool
    ranges: jax.Array  # [H, 4] int32 footprint (gxmin, gxmax, gymin, gymax)


def heavy_coeffs(vertices, faces, heavy_faces, heavy_count,
                 origin, heavy_ranges) -> HeavyCoeffs:
    """Precompute coefficients; origin = eye (primary) or light (shadow)."""
    H = heavy_faces.shape[0]
    fidx = jnp.clip(heavy_faces, 0, faces.shape[0] - 1)
    v = vertices[faces[fidx]]               # [H, 3, 3]
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    tvec = origin[None, :] - v0
    a = cross(e2, e1, xp=jnp)
    b = cross(e2, tvec, xp=jnp)
    c = cross(tvec, e1, xp=jnp)
    k = dot(e2, c)
    live = jnp.arange(H, dtype=jnp.int32) < heavy_count
    return HeavyCoeffs(a, b, c, k, heavy_faces.astype(jnp.int32), live,
                       heavy_ranges.astype(jnp.int32))


def _footprint_mask(co: HeavyCoeffs, gx, gy):
    """[..., H] bool: ray's cell inside the face's cell footprint —
    exactly the rays whose cell list would have contained the face."""
    r = co.ranges
    gx = gx[..., None]
    gy = gy[..., None]
    return ((gx >= r[:, 0]) & (gx <= r[:, 1])
            & (gy >= r[:, 2]) & (gy <= r[:, 3]))


def _det_uv(co: HeavyCoeffs, d):
    """d: [..., 3] -> det, u', v' each [..., H] (fused broadcasts)."""
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]

    def tri_dot(m):  # [H, 3] -> [..., H]
        return dx * m[:, 0] + dy * m[:, 1] + dz * m[:, 2]

    return tri_dot(co.a), tri_dot(co.b), tri_dot(co.c)


def heavy_min_t(co: HeavyCoeffs, ray_dirs, ray_gx, ray_gy,
                cfg: RenderConfig, chunk: int = 4096):
    """Per-ray (min |t|, winner face id) over the heavy list.

    ray_dirs: [N, 3]; ray_gx/ray_gy: [N] int32 grid-cell coordinates of
    each ray's own cell (footprint mask).  Returns (t [N] with _BIG for
    none, face [N] int32 with int32-max for none) — ready for lex-min
    combination with the cell-list winner.  Accept rule replicates
    intersectTriUV (trace_kernel.cu:4-45): |det| >= eps, 0<=u<=1, 0<=v,
    u+v<=1, |t|>0.
    """
    H = co.k.shape[0]
    if H == 0:
        n = ray_dirs.shape[0]
        return (jnp.full((n,), _BIG), jnp.full((n,), _MAXF, jnp.int32))

    def chunk_fn(args):
        d, gx, gy = args
        det, up, vp = _det_uv(co, d)                  # [C, H]
        det2 = det * det
        ud = up * det
        vd = vp * det
        inv = 1.0 / det
        t = co.k[None, :] * inv
        if cfg.quirks.abs_t:
            t = jnp.abs(t)
        reject = ((jnp.abs(det) < jnp.float32(cfg.epsilon))
                  | (ud < 0) | (ud > det2) | (vd < 0)
                  | (ud + vd > det2) | (t <= 0) | ~co.live[None, :]
                  | ~_footprint_mask(co, gx, gy))
        t = jnp.where(reject, _BIG, t)
        # lex-min (t, face): pick min t, then min face id among exact ties
        tmin = jnp.min(t, axis=-1)
        fcand = jnp.where(t == tmin[:, None], co.face[None, :], _MAXF)
        fmin = jnp.min(fcand, axis=-1)
        none = tmin >= _BIG
        return tmin, jnp.where(none, _MAXF, fmin)

    n = ray_dirs.shape[0]
    nc = -(-n // chunk)
    pad = nc * chunk - n
    d = jnp.pad(ray_dirs, ((0, pad), (0, 0))).reshape(nc, chunk, 3)
    gx = jnp.pad(ray_gx, (0, pad)).reshape(nc, chunk)
    gy = jnp.pad(ray_gy, (0, pad)).reshape(nc, chunk)
    t, f = jax.lax.map(chunk_fn, (d, gx, gy))
    return t.reshape(-1)[:n], f.reshape(-1)[:n]


def heavy_shadowed(co: HeavyCoeffs, ray_dirs, dist_pt, ray_gx, ray_gy,
                   cfg: RenderConfig, chunk: int = 8192):
    """Per-ray occlusion flag over the heavy list (shadow variant).

    ray_dirs: [N, 3] normalized light->point directions; dist_pt: [N]
    light-to-surface distances; ray_gx/ray_gy: the ray's own light-grid
    cell coordinates (footprint mask).  Accept rule replicates
    intersectTri + isSmaller (light_kernel.cu:13-50, :1-11): signed
    t != 0 below 999999.9 (negative t accepted per quirk), occluder
    strictly closer than the surface point by shadow_epsilon.
    """
    H = co.k.shape[0]
    n = ray_dirs.shape[0]
    if H == 0:
        return jnp.zeros((n,), jnp.int32)

    def chunk_fn(args):
        d, dp, gx, gy = args
        det, up, vp = _det_uv(co, d)
        det2 = det * det
        ud = up * det
        vd = vp * det
        inv = 1.0 / det
        t = co.k[None, :] * inv
        reject = ((jnp.abs(det) < jnp.float32(cfg.epsilon))
                  | (ud < 0) | (ud > det2) | (vd < 0)
                  | (ud + vd > det2) | ~co.live[None, :]
                  | ~_footprint_mask(co, gx, gy))
        hit = (~reject) & (t != 0) & (t < jnp.float32(999999.9))
        if not cfg.quirks.shadow_accept_negative_t:
            hit = hit & (t > 0)
        occ = t[..., None] * d[:, None, :]
        dist_occ = jnp.sqrt(dot(occ, occ))
        sh = hit & (dist_occ + jnp.float32(cfg.shadow_epsilon)
                    < dp[:, None])
        return jnp.any(sh, axis=-1).astype(jnp.int32)

    nc = -(-n // chunk)
    pad = nc * chunk - n
    d = jnp.pad(ray_dirs, ((0, pad), (0, 0))).reshape(nc, chunk, 3)
    dp = jnp.pad(dist_pt, (0, pad)).reshape(nc, chunk)
    gx = jnp.pad(ray_gx, (0, pad)).reshape(nc, chunk)
    gy = jnp.pad(ray_gy, (0, pad)).reshape(nc, chunk)
    sh = jax.lax.map(chunk_fn, (d, dp, gx, gy))
    return sh.reshape(-1)[:n]
