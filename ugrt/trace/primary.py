"""Primary-ray tracing over the perspective grid — XLA work-item design.

The reference's rckernel_alpha (/root/reference/trace_kernel.cu:84-270)
maps one CUDA block to one grid cell ≡ 8x8 pixel tile and streams the
cell's triangle list through shared memory in 64-triangle batches.  The
plain XLA formulation flattens the ragged CSR into dense *work items*
first:

    work item w = (cell c, triangle batch b)   — static capacity
    t[w, ray, tri] = Möller–Trumbore            — dense [64 x B] block
    per-cell result = segment-min over w        — XLA segment_min

Total compute is Σ_cells ceil(count/B)·64·B — the same arithmetic the
reference does, with no divergence and no atomics.  Work items are
processed in fixed-size chunks via lax.map to bound live memory; the
Pallas kernel in ugrt.trace.pallas_tracer implements the same contract
fused, one program per cell.

Semantics replicated exactly (quirks per RenderConfig.quirks):
  * |t| acceptance (trace_kernel.cu:35) with strict-< update, i.e. min
    with earliest-pair tie-break;
  * per-slab sequential accept with the isWithin reprojection check
    (trace_kernel.cu:56-82, :217-228) — a hit only counts if its MVP
    z-bin equals the slab being processed (done==2), otherwise the ray
    reports a miss;
  * outputs t=-1 / face_id=-2 / normal=-1 on miss, component-wise |normal|
    on hit (trace_kernel.cu:232-263).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.core.ragged import segment_ids_from_starts
from ugrt.core.vecmath import cross, dot, normalize, transform_point
from ugrt.grid.build import DeviceGrid

# numpy scalar, NOT jnp: a module-level device array gets hoisted as a
# hidden executable parameter under jax 0.9 simplified-jaxpr-constants,
# and the pjit C++ fastpath then drops it on re-execution
# ("Execution supplied N buffers but compiled program expected M").
_BIG = np.float32(3.0e38)


class WorkItems(NamedTuple):
    """Dense (cell, batch) work list with static capacity."""

    cell: jax.Array     # [Wcap] int32; num_cells for padding
    offset: jax.Array   # [Wcap] int32 into sorted pair arrays
    count: jax.Array    # [Wcap] int32 triangles in this batch (<= B)


def make_work_items(counts, offsets, batch: int, wcap: int) -> WorkItems:
    """Ragged CSR -> dense work items by segment-id expansion.

    counts/offsets: per-cell CSR arrays (may be a contiguous slice of the
    full grid when tracing a sharded strip).  Padding items get cell ==
    len(counts).
    """
    B = batch
    num_cells = counts.shape[0]
    nb = (counts + (B - 1)) // B
    incl = jnp.cumsum(nb)

    w = jnp.arange(wcap, dtype=jnp.int32)
    cell_c = segment_ids_from_starts(incl - nb, wcap)
    valid = w < incl[-1]

    b = w - (incl - nb)[cell_c]
    offset = offsets[cell_c] + b * B
    count = jnp.clip(counts[cell_c] - b * B, 0, B)

    return WorkItems(
        cell=jnp.where(valid, cell_c, num_cells).astype(jnp.int32),
        offset=jnp.where(valid, offset, 0).astype(jnp.int32),
        count=jnp.where(valid, count, 0).astype(jnp.int32),
    )


def moller_trumbore_t(tvec, e1, e2, ray_d, cfg: RenderConfig,
                      abs_t: bool | None = None):
    """Batched intersectTriUV t-value (trace_kernel.cu:4-45).

    tvec/e1/e2: [..., K, 3]; ray_d: [..., R, 3].  Returns t [..., R, K]
    with 0 for rejects and |t| when the abs_t quirk is on.  Pass
    ``abs_t=False`` for the shadow variant intersectTri
    (light_kernel.cu:13-50), which keeps signed t.
    """
    if abs_t is None:
        abs_t = cfg.quirks.abs_t
    pvec = cross(ray_d[..., :, None, :], e2[..., None, :, :], xp=jnp)
    det = dot(e1[..., None, :, :], pvec)
    inv_det = 1.0 / det
    u = dot(tvec[..., None, :, :], pvec) * inv_det
    qvec = cross(tvec[..., None, :, :], e1[..., None, :, :], xp=jnp)
    v = dot(ray_d[..., :, None, :], qvec) * inv_det
    t = dot(e2[..., None, :, :], qvec) * inv_det
    if abs_t:
        t = jnp.abs(t)
    reject = ((jnp.abs(det) < jnp.float32(cfg.epsilon))
              | (u < 0) | (u > 1) | (v < 0) | (u + v > 1))
    return jnp.where(reject, jnp.float32(0.0), t)


def tile_rays(dirs, cfg: RenderConfig):
    """[H, W, 3] -> [tiles, tile_y*tile_x, 3], tile index = bx*tiles_y+by.

    Matches the pixel/block mapping of trace_kernel.cu:91,138: block
    (bx,by) covers rows by*8..+8, cols bx*8..+8; in-tile ray index is
    ty*8+tx; cell index is bx*gridDim.y+by (x-major).  Width may be a
    strip of the full image (sharding); shapes come from ``dirs``.
    """
    ty, tx = cfg.tile_y, cfg.tile_x
    h, w = dirs.shape[:2]
    tiles_y = h // ty
    tiles_x = w // tx
    d = dirs.reshape(tiles_y, ty, tiles_x, tx, 3)
    d = jnp.transpose(d, (2, 0, 1, 3, 4))  # [tiles_x, tiles_y, ty, tx, 3]
    return d.reshape(tiles_x * tiles_y, ty * tx, 3)


def untile(img_tiled, cfg: RenderConfig, tiles_x: int, tiles_y: int):
    """[tiles, tile_y*tile_x, ...] -> [h, w, ...] (inverse of tile_rays)."""
    ty, tx = cfg.tile_y, cfg.tile_x
    trailing = img_tiled.shape[2:]
    d = img_tiled.reshape(tiles_x, tiles_y, ty, tx, *trailing)
    d = jnp.transpose(d, (1, 2, 0, 3) + tuple(range(4, 4 + len(trailing))))
    return d.reshape(tiles_y * ty, tiles_x * tx, *trailing)


def _work_chunk_min(vertices, faces, grid, work, ray_blocks, eye,
                    cfg: RenderConfig, chunk_size: int):
    """Per-work-item (min t, winner pair index) over rays, chunked.

    ray_blocks: [Wcap, R, 3] ray directions for each work item's tile.
    Returns tmin [Wcap, R], pair index [Wcap, R] (offset into sorted
    arrays; only meaningful where tmin finite).
    """
    B = cfg.tri_batch
    lane = jnp.arange(B, dtype=jnp.int32)

    def chunk_body(args):
        offset, count, rays = args          # [C], [C], [C, R, 3]
        idx = offset[:, None] + lane[None, :]
        idx = jnp.clip(idx, 0, grid.sorted_faces.shape[0] - 1)
        fidx = jnp.clip(grid.sorted_faces[idx], 0,
                        faces.shape[0] - 1)     # [C, B]
        v = vertices[faces[fidx]]               # [C, B, 3, 3]
        v0 = v[:, :, 0]
        e1 = v[:, :, 1] - v0
        e2 = v[:, :, 2] - v0
        tvec = eye[None, None, :] - v0

        t = moller_trumbore_t(tvec, e1, e2, rays, cfg)   # [C, R, B]
        live = (lane[None, :] < count[:, None])[:, None, :]
        t = jnp.where(live & (t > 0), t, _BIG)
        k = jnp.argmin(t, axis=-1)                        # first min
        tmin = jnp.min(t, axis=-1)
        pair = offset[:, None] + k.astype(jnp.int32)
        return tmin, pair

    def chunk_fn(args):
        # Work items are packed valid-first; fully-dead chunks (the
        # static-capacity padding tail) skip all compute.  The dead
        # branch derives its outputs from the traced inputs so their
        # device-varying provenance matches under shard_map.
        def dead(a):
            z = a[2][:, :, 0] * 0.0
            return z + _BIG, z.astype(jnp.int32)

        return jax.lax.cond(jnp.any(args[1] > 0), chunk_body, dead, args)

    wcap = work.cell.shape[0]
    n_chunks = -(-wcap // chunk_size)
    pad = n_chunks * chunk_size - wcap

    def pad0(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    xs = (pad0(work.offset).reshape(n_chunks, chunk_size),
          pad0(work.count).reshape(n_chunks, chunk_size),
          pad0(ray_blocks).reshape(n_chunks, chunk_size,
                                   *ray_blocks.shape[1:]))
    tmin, pair = jax.lax.map(chunk_fn, xs)
    R = ray_blocks.shape[1]
    return (tmin.reshape(-1, R)[:wcap], pair.reshape(-1, R)[:wcap])


def trace_primary(vertices, faces, camcoords, grid: DeviceGrid,
                  cfg: RenderConfig, *, chunk_size: int = 256,
                  bx0=0, n_bx: int | None = None,
                  backend: str | None = None, interpret: bool = False):
    """Full primary trace.  Returns per-pixel dict:
    t [H,w], face_id [H,w] int32, normal [H,w,3], ray_dir [H,w,3].

    bx0 / n_bx select a strip of tile columns (for shard_map sharding over
    the image x axis): only tiles bx in [bx0, bx0+n_bx) are traced and the
    outputs cover columns [bx0*tile_x, ...).  bx0 may be a traced scalar
    (e.g. axis_index * n_bx); n_bx must be static.  Default: full image.

    backend: "xla" (gather/segment pipeline) or "pallas" (the fused
    range sweep of ugrt.trace.pallas_tracer, compiled through Triton);
    None picks the platform's default (ugrt.trace.default_trace_backend).
    interpret runs the kernel in the Pallas interpreter (CPU tests).
    """
    if backend is None:
        from ugrt.trace import default_trace_backend
        backend = default_trace_backend()
    H, W = cfg.screen_height, cfg.screen_width
    assert W // cfg.tile_x == cfg.grid_x and H // cfg.tile_y == cfg.grid_y, (
        "screen tiles must match grid dims (reference couples them, "
        "main.cu.h:10-28)")
    if n_bx is None:
        n_bx = cfg.grid_x
    tiles_y = cfg.grid_y
    NS = cfg.num_slabs
    num_tiles = n_bx * tiles_y
    cells_local = num_tiles * NS
    c0 = jnp.asarray(bx0, dtype=jnp.int32) * (tiles_y * NS)

    eye = camcoords[0:3]
    dirs_full = cam.primary_ray_dirs(camcoords, W, H, xp=jnp)
    dirs = jax.lax.dynamic_slice(
        dirs_full, (0, jnp.asarray(bx0, jnp.int32) * cfg.tile_x, 0),
        (H, n_bx * cfg.tile_x, 3))
    rays_t = tile_rays(dirs, cfg)                        # [T, R, 3]
    R = rays_t.shape[1]

    # Each ray's own grid cell: tile t covers cell (bx0 + t // tiles_y,
    # t % tiles_y) — the heavy footprint test needs it.
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
    gx_t = jnp.asarray(bx0, jnp.int32) + tile_ids // tiles_y
    gy_t = tile_ids % tiles_y
    gx_r = jnp.broadcast_to(gx_t[:, None], (num_tiles, R)).reshape(-1)
    gy_r = jnp.broadcast_to(gy_t[:, None], (num_tiles, R)).reshape(-1)
    counts = jax.lax.dynamic_slice(grid.cell_count, (c0,), (cells_local,))
    offsets = jax.lax.dynamic_slice(grid.cell_offset, (c0,), (cells_local,))
    heavy = grid.heavy_faces.shape[0] > 0
    co = None
    if heavy:
        from ugrt.trace import heavy as theavy

        co = theavy.heavy_coeffs(vertices, faces, grid.heavy_faces,
                                 grid.heavy_count, eye, grid.heavy_ranges)

    if backend == "pallas":
        # One program per cell (tile, slab): its pair range is exactly
        # the cell's list; heavy faces live in slab 0 (the build asserts
        # num_slabs == 1 when the split is on) and are merged in-kernel.
        from ugrt.trace import pallas_tracer as pt

        assert R == pt.RAYS, "the kernel takes one 8x8 tile per program"
        slab0 = jnp.arange(cells_local, dtype=jnp.int32) % NS == 0
        hhi = jnp.where(slab0, grid.heavy_count, 0) if heavy else 0
        zero = jnp.zeros((cells_local,), jnp.int32)
        ranges = jnp.stack([offsets, offsets + counts, zero,
                            zero + hhi]).astype(jnp.int32)
        t_all, f_all = pt.primary_sweep(
            ranges, pt.pack_pairs(vertices, faces, grid, eye),
            pt.pack_heavy(co), rays_t.reshape(-1, 3).T,
            jnp.stack([gx_r, gy_r]), cfg=cfg, rep=NS, interpret=interpret)
        t_cell = t_all.reshape(num_tiles, NS, R)
        f_cell = f_all.reshape(num_tiles, NS, R)
    else:
        wcap = cells_local + grid.sorted_faces.shape[0] // cfg.tri_batch
        work = make_work_items(counts, offsets, cfg.tri_batch, wcap)
        tile_of_work = jnp.clip(work.cell // NS, 0, num_tiles - 1)
        ray_blocks = rays_t[tile_of_work]                # [Wcap, R, 3]
        tmin_w, pair_w = _work_chunk_min(
            vertices, faces, grid, work, ray_blocks, eye, cfg, chunk_size)

        # Segment-min over work items -> per (cell) candidates.
        seg = work.cell
        t_cell = jax.ops.segment_min(tmin_w, seg,
                                     num_segments=cells_local + 1)
        cand = jnp.where(tmin_w == t_cell[seg], pair_w,
                         jnp.int32(2**31 - 1))
        win_cell = jax.ops.segment_min(cand, seg,
                                       num_segments=cells_local + 1)

        t_cell = t_cell[:cells_local].reshape(num_tiles, NS, R)
        win_cell = win_cell[:cells_local].reshape(num_tiles, NS, R)

        # Winner face id before the heavy merge, so the heavy-list
        # candidates merge by (t, face) lex-min — the reference's
        # strict-< scan order over its face-ascending merged cell list
        # (ugrt.trace.heavy docstring).
        _MAXF = jnp.int32(2**31 - 1)
        f_cell = grid.sorted_faces[jnp.clip(win_cell, 0, None)
                                   ].astype(jnp.int32)
        f_cell = jnp.where(t_cell >= _BIG, _MAXF, f_cell)

        if heavy:
            t_h, f_h = theavy.heavy_min_t(co, rays_t.reshape(-1, 3),
                                          gx_r, gy_r, cfg)
            t_h = t_h.reshape(num_tiles, R)
            f_h = f_h.reshape(num_tiles, R)
            # Heavy faces live in slab 0 (build asserts num_slabs == 1).
            t_c0 = t_cell[:, 0]
            f_c0 = f_cell[:, 0]
            take_h = (t_h < t_c0) | ((t_h == t_c0) & (f_h < f_c0))
            t_cell = t_cell.at[:, 0].set(jnp.where(take_h, t_h, t_c0))
            f_cell = f_cell.at[:, 0].set(jnp.where(take_h, f_h, f_c0))

    # Sequential slab scan with the isWithin(done) state machine.
    mvp = camcoords[48:64]

    def slab_step(carry, xs):
        oldt, win, done = carry
        m, wk, slab = xs
        upd = (done != 2) & (m < oldt)
        oldt = jnp.where(upd, m, oldt)
        win = jnp.where(upd, wk, win)
        done = jnp.where(upd, 1, done)

        # isWithin reprojection (trace_kernel.cu:56-82)
        pt = eye[None, None, :] + oldt[..., None] * rays_t
        ndc = transform_point(mvp, pt, xp=jnp)
        zbin = jnp.floor(ndc[..., 2] * NS)
        done = jnp.where((done == 1) & (zbin == slab), 2, done)
        return (oldt, win, done), None

    # Derive the init carry from a traced array so its device-varying
    # provenance matches the scan outputs under shard_map (vma check).
    zero = rays_t[..., 0] * 0.0
    oldt0 = zero + jnp.float32(99999999.9)
    win0 = zero.astype(jnp.int32) - 1
    done0 = zero.astype(jnp.int32)
    slabs = jnp.arange(NS, dtype=jnp.float32)
    (oldt, win, done), _ = jax.lax.scan(
        slab_step, (oldt0, win0, done0),
        (jnp.moveaxis(t_cell, 1, 0), jnp.moveaxis(f_cell, 1, 0), slabs))

    ok = done == 2
    face_id = jnp.where(ok, win, -2).astype(jnp.int32)

    # Geometric normals via a per-FACE table: the normal depends only on
    # the face, so compute it once per face (F ~ 75k) instead of per
    # pixel (1M), replacing a [H*W, 3, 3] two-level vertex gather +
    # per-pixel normalize chain with one [H*W] row gather.  Same op
    # sequence per face => bitwise-identical to the per-pixel form
    # (trace_kernel.cu:232-253 semantics).
    fv = vertices[faces]                                 # [F, 3, 3]
    fe1 = normalize(fv[:, 1] - fv[:, 0], xp=jnp)
    fe2 = normalize(fv[:, 2] - fv[:, 0], xp=jnp)
    fnrm = normalize(cross(fe1, fe2, xp=jnp), xp=jnp)
    if cfg.quirks.abs_normal:
        fnrm = jnp.abs(fnrm)
    nrm = fnrm[jnp.clip(face_id, 0, None)]               # [T, R, 3]
    nrm = jnp.where(ok[..., None], nrm, jnp.float32(-1.0))

    t_out = jnp.where(ok, oldt, jnp.float32(-1.0))

    return dict(
        t=untile(t_out, cfg, n_bx, tiles_y),
        face_id=untile(face_id, cfg, n_bx, tiles_y),
        normal=untile(nrm, cfg, n_bx, tiles_y),
        ray_dir=dirs,
    )


trace_primary_jit = functools.partial(
    jax.jit, static_argnames=("cfg", "chunk_size"))(trace_primary)
