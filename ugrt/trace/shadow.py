"""Shadow pass: light-grid ray scheduling + occlusion trace.

The reference reorders shadow rays by their light-grid cell with a 6-step
CUDPP pipeline — radix sort, segment-head flags, segmented scan,
packet-start marking, compaction (DecisionData, /root/reference/
decision_data.h:171-271 and misc_kernel.cu:255-333) — then traces one CUDA
block per ray packet streaming the cell's triangle list through shared
memory (mod_light_rckernel, light_kernel.cu:52-270).

This formulation keeps the insight (sorting shadow rays by light-grid
cell makes them coherent) but replaces the reference's variable-offset
packets with **fixed blocks of the sorted stream**:

  cells    — per-ray light-cell id (ugrt.grid.binning.ray_light_cells)
  sort     — lax.sort (cell, ray) pairs, stable (== 15-bit CUDPP radix,
             decision_data.h:177)
  blocks   — the sorted stream reshaped into [N/R, R]: block b = rays
             [Rb, Rb+R).  No compaction, no packet-start marking, no
             ragged gather — packets become a reshape.
  segments — cell runs in the sorted stream (head flags + cumsum); each
             segment knows which blocks it overlaps
  work     — (block, cell, tri-batch) items: a block spanning k cell runs
             is swept against each run's triangle batches, with rays
             masked to their own cell (lane mask = ray_cell == item_cell)
  combine  — segment-max over work items -> per-block flags -> reshape
             back through the sort permutation

Results are identical to the reference's packet scheme: every ray is
tested against exactly its own cell's triangle list.  The reference's
cell-pure packets are still available as ``build_packets`` (the
DecisionData-parity component); the renderer path uses block scheduling
because it is allocation-exact (N/R blocks, no cells+N/64 packet
overallocation) and turns the per-packet ray gather — 4M scattered row
reads at 1024x1024 — into a reshape.  The fused kernel
(ugrt.trace.pallas_tracer) sweeps each block's contiguous pair range
directly instead of building work items.

Divergence (defined semantics, SURVEY.md §3.5): rays whose shadow
direction leaves the light grid get the sentinel cell and the reference
then indexes its span array OUT OF BOUNDS for those packets
(light_kernel.cu:111 with cell 16384 into a 16384-entry array) — undefined
behavior.  Here sentinel segments produce no work: such rays are never
shadowed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core.ragged import segment_ids_from_starts
from ugrt.core.vecmath import dot, normalize
from ugrt.grid import binning
from ugrt.grid.build import DeviceGrid
from ugrt.trace.primary import moller_trumbore_t

# numpy scalar, NOT jnp: a module-level device array gets hoisted as a
# hidden executable parameter under jax 0.9 simplified-jaxpr-constants,
# and the pjit C++ fastpath then drops it on re-execution
# ("Execution supplied N buffers but compiled program expected M").
_BIG = np.float32(3.0e38)


class ShadowWork(NamedTuple):
    packet_pos: jax.Array    # [Pcap] position in sorted ray order (N pad)
    packet_count: jax.Array  # [Pcap] rays in packet (<= 64, 0 pad)
    packet_cell: jax.Array   # [Pcap] light cell (sentinel pad)
    overflow: jax.Array      # [] bool


def _unpermute(values, perm):
    """values[i] belongs to original index perm[i] -> original order.

    perm is a permutation (the shadow sort's ray ids), so this is a
    gather by the inverse permutation; instead of the scatter that
    computing the inverse needs, sort (perm, values) by perm.
    """
    return jax.lax.sort((perm, values), num_keys=1)[1]


def packet_capacity(cfg: RenderConfig, num_rays: int) -> int:
    """Packets <= light cells + N/64: every cell adds at most one partial
    packet on top of the full 64-ray ones."""
    return cfg.cell_sentinel + num_rays // cfg.max_rays_per_packet + 1


def build_packets(cells, cfg: RenderConfig):
    """Sort rays by light cell and carve 64-ray cell-pure packets.

    This is the faithful DecisionData 6-step pipeline (decision_data.h:
    171-271): sort -> head flags -> segmented rank (cummax) -> rank%64==1
    packet starts -> compaction by sorting marked positions.  The hot
    render path uses block scheduling (trace_shadow) instead; this stays
    as the reference-parity component and for packet-level analysis.

    cells: [N] int32 light-cell ids (cfg.cell_sentinel = out of grid).
    Returns (sorted_ray [N] int32 original ray index, ShadowWork).
    """
    n = cells.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)
    sorted_cells, sorted_ray = jax.lax.sort((cells, ray_ids), num_keys=1)

    pos = jnp.arange(n, dtype=jnp.int32)
    head = jnp.concatenate(
        [jnp.ones((1,), dtype=jnp.bool_),
         sorted_cells[1:] != sorted_cells[:-1]])
    seg_start = jax.lax.cummax(jnp.where(head, pos, -1))
    rank = pos - seg_start + 1  # 1-based in-segment rank (segmented scan)

    start = (rank % cfg.max_rays_per_packet) == 1
    if cfg.max_rays_per_packet == 1:
        start = jnp.ones_like(start)

    pcap = packet_capacity(cfg, n)
    # Compact start positions: sort marked positions ascending, pad with n.
    marked = jnp.where(start, pos, n)
    sorted_marked = jnp.sort(marked)
    packet_pos = sorted_marked[:pcap]
    num_packets = jnp.sum(start.astype(jnp.int32))
    overflow = num_packets > pcap

    # Packet extent = distance to the next start (a new segment always
    # starts a packet, so this never crosses a cell boundary).
    next_pos = jnp.concatenate(
        [sorted_marked[1:pcap + 1],
         jnp.full((max(0, pcap + 1 - sorted_marked.shape[0]),), n,
                  dtype=sorted_marked.dtype)])[:pcap]
    packet_count = jnp.clip(next_pos - packet_pos, 0,
                            cfg.max_rays_per_packet)

    cell_at = sorted_cells[jnp.clip(packet_pos, 0, n - 1)]
    valid = packet_pos < n
    packet_cell = jnp.where(valid & (cell_at < cfg.cell_sentinel),
                            cell_at, cfg.cell_sentinel)
    packet_count = jnp.where(packet_cell < cfg.cell_sentinel,
                             packet_count, 0)

    work = ShadowWork(packet_pos.astype(jnp.int32),
                      packet_count.astype(jnp.int32),
                      packet_cell.astype(jnp.int32), overflow)
    return sorted_ray, work


def shadow_work_capacity(cfg: RenderConfig, num_rays: int,
                         pair_capacity: int,
                         block_rays: int | None = None) -> int:
    """Static bound on (block, cell-run, tri-batch) work items per slab.

    Data-dependent (rays and triangles concentrating in the same cells
    multiply), so this is a heuristic with an overflow flag behind it:
    8 batch-sweeps per ray block on average, plus one full pass over the
    pair buffer, plus one unit per possible cell run.
    """
    R = block_rays or cfg.max_rays_per_packet
    nb_blocks = -(-num_rays // R)
    return (8 * nb_blocks + pair_capacity // cfg.tri_batch
            + cfg.cell_sentinel + 1)


def light_extents(primary, primary_eye, light_camcoords,
                  cfg: RenderConfig, margin: float = 1.001):
    """Per-frame (x_max, y_max) light-grid extents from the hit points.

    Replicates the computation the reference performs and then discards
    (getRayGridMapping -> host max-reduce, main.cu:174-185, overridden
    with pi at :186-187): the max x/y angle of any pixel's hit point as
    seen from the light.  All pixels participate, including primary
    misses with their faithfully-garbage point eye + (-1)*dir.  The
    `margin` factor keeps the extremal ray strictly inside the grid
    (angle == max would land exactly on the out-of-grid boundary);
    results are clamped to pi (the reference override is the upper
    bound) and NaN angles (degenerate directions) are ignored.
    """
    from ugrt.core.vecmath import normalize as _normalize

    H, W = primary["t"].shape
    n = H * W
    L = light_camcoords[0:3]
    pts = (primary_eye[None]
           + primary["t"].reshape(n)[:, None]
           * primary["ray_dir"].reshape(n, 3))
    d = _normalize(pts - L[None], xp=jnp)
    xa = binning.x_angle(d, light_camcoords, xp=jnp)
    ya = binning.y_angle(d, light_camcoords,
                         cfg.quirks.y_forward_dot_typo, xp=jnp)
    f32 = jnp.float32
    xm = jnp.max(jnp.where(jnp.isnan(xa), f32(0.0), xa)) * f32(margin)
    ym = jnp.max(jnp.where(jnp.isnan(ya), f32(0.0), ya)) * f32(margin)
    pi = f32(np.pi)
    return (jnp.clip(xm, f32(1e-3), pi), jnp.clip(ym, f32(1e-3), pi))


# Windowed light-grid margin: fraction of the window width added per
# side, and the width floor (degenerate windows).  ugrt.dist.mesh
# re-applies these after its cross-device min/max reduction — keep the
# single source of truth here.
WINDOW_MARGIN = 2e-3
WINDOW_MIN_WIDTH = 1e-4


def apply_window_margin(x0, x1, y0, y1, margin: float = WINDOW_MARGIN):
    """Pad raw signed-angle bounds by ``margin`` of the width per side
    (width floored at WINDOW_MIN_WIDTH)."""
    f32 = jnp.float32

    def pad(lo, hi):
        w = jnp.maximum(hi - lo, f32(WINDOW_MIN_WIDTH))
        return lo - w * f32(margin), hi + w * f32(margin)

    x0, x1 = pad(x0, x1)
    y0, y1 = pad(y0, y1)
    return x0, x1, y0, y1


def light_window(primary, primary_eye, light_camcoords,
                 cfg: RenderConfig, margin: float = WINDOW_MARGIN):
    """(x0, x1, y0, y1): the signed-angle window of the hit points as
    seen from the light, padded by ``margin`` of the width per side.

    The WINDOWED light-grid parameterization maps this window across the
    whole grid (RenderConfig.light_grid_mode): on the flagship interior
    scene the reference mapping's usable band is ~0.3 rad of the pi
    extent (and the typo'd y angle is constant), so the 128x128 grid
    degenerates to ~75 cells; the window restores full 2-D resolution.
    NaN angles (degenerate directions) are excluded from the reduce.
    """
    H, W = primary["t"].shape
    n = H * W
    pts = (primary_eye[None]
           + primary["t"].reshape(n)[:, None]
           * primary["ray_dir"].reshape(n, 3))
    d = normalize(pts - light_camcoords[0:3][None], xp=jnp)
    sx, sy = binning.signed_xy_coords(d, light_camcoords, xp=jnp)
    f32 = jnp.float32
    big = f32(4.0)

    def lohi(s):
        ok = ~jnp.isnan(s)
        return (jnp.min(jnp.where(ok, s, big)),
                jnp.max(jnp.where(ok, s, -big)))

    x0, x1 = lohi(sx)
    y0, y1 = lohi(sy)
    return apply_window_margin(x0, x1, y0, y1, margin)


def trace_shadow(vertices, faces, light_camcoords, light_grid: DeviceGrid,
                 primary, primary_eye, cfg: RenderConfig, *,
                 chunk_size: int = 256,
                 work_capacity: int | None = None,
                 backend: str | None = None, interpret: bool = False,
                 x_max=None, y_max=None, window=None):
    """Per-pixel shadow flags [H, W] int32 (mod_light_rckernel semantics).

    Every pixel participates — including primary misses, whose 'hit point'
    eye + (-1)*dir is faithfully garbage, exactly as the reference
    reorders all IMAGE_SIZE rays (misc_kernel.cu:294-295).

    Rays are swept in fixed blocks of the cell-sorted stream (128 rays
    on the XLA path, pallas_tracer.RAYS in the kernel).  Results do not
    depend on the block width — every ray is cell-masked against exactly
    its own cell's triangles; the reference's 64-ray packets
    (MAX_RAYS_PER_BLOCK) remain available via build_packets.

    backend: "xla" (work-item pipeline) or "pallas" (the fused range
    sweep of ugrt.trace.pallas_tracer); None picks the platform's
    default (ugrt.trace.default_trace_backend).  interpret runs the
    kernel in the Pallas interpreter (CPU tests).  The kernel has no
    static work capacity, so its overflow flag is always false.

    x_max/y_max override the angular extent of the ray->cell mapping
    (may be traced scalars from light_extents); ``window`` selects the
    windowed parameterization (light_window).  Either MUST match what
    light_grid was built with or cell keys disagree.
    """
    if backend is None:
        from ugrt.trace import default_trace_backend
        backend = default_trace_backend()
    H, W = primary["t"].shape
    n = H * W
    L = light_camcoords[0:3]
    R = 128
    B = cfg.tri_batch
    NS = cfg.num_slabs
    sentinel = cfg.cell_sentinel
    if x_max is None:
        x_max = cfg.angular_extent
    if y_max is None:
        y_max = cfg.angular_extent

    t = primary["t"].reshape(n)
    dirs = primary["ray_dir"].reshape(n, 3)
    pts = primary_eye[None] + t[:, None] * dirs              # [N, 3]

    if window is not None:
        cells = binning.ray_light_cells_windowed(
            pts, light_camcoords, cfg.grid_x, cfg.grid_y, window,
            xp=jnp).reshape(n)
    else:
        cells = binning.ray_light_cells(
            pts, light_camcoords, cfg.grid_x, cfg.grid_y,
            x_max, y_max,
            cfg.quirks.y_forward_dot_typo, xp=jnp).reshape(n)

    use_heavy = light_grid.heavy_faces.shape[0] > 0

    # Sort rays by light cell with the hit point riding as radix-sort
    # PAYLOAD columns: building shadow rows in original order and
    # gathering them through the permutation costs a transposed [N, 4]
    # gather; the (dir, dist) math runs on the sorted values instead —
    # elementwise ops commute with the permutation bitwise, so results
    # are unchanged.
    ray_ids = jnp.arange(n, dtype=jnp.int32)
    (sorted_cells, sorted_ray, spx, spy, spz) = jax.lax.sort(
        (cells, ray_ids, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=1)
    spts = jnp.stack([spx, spy, spz], axis=1)             # [N, 3]
    delta = spts - L[None]
    srows = jnp.concatenate([normalize(delta, xp=jnp),
                             jnp.sqrt(dot(delta, delta))[:, None]], axis=1)

    if backend == "pallas":
        # One program per RAYS-ray block of the sorted stream: its cells
        # are a contiguous key range, so its pairs are the one range
        # [offset[first cell], end of last cell), swept with the key
        # test; heavy faces are the program's second range.
        from ugrt.trace import pallas_tracer as pt

        PR = pt.RAYS
        G = -(-n // PR)
        cblk = jnp.pad(sorted_cells, (0, G * PR - n),
                       constant_values=sentinel).reshape(G, PR)
        first_cell = jnp.clip(cblk[:, 0], 0, sentinel - 1)
        last_real = jnp.max(jnp.where(cblk < sentinel, cblk, -1), axis=1)
        live = last_real >= 0
        last_cell = jnp.clip(last_real, 0, sentinel - 1)
        out_grid = sorted_cells >= sentinel
        gx = jnp.where(out_grid, -1, sorted_cells // cfg.grid_y)
        gy = jnp.where(out_grid, -1, sorted_cells % cfg.grid_y)
        co = None
        if use_heavy:
            from ugrt.trace import heavy as theavy

            co = theavy.heavy_coeffs(
                vertices, faces, light_grid.heavy_faces,
                light_grid.heavy_count, L, light_grid.heavy_ranges)
        pairs = pt.pack_pairs(vertices, faces, light_grid, L)
        heavy = pt.pack_heavy(co)
        zero = jnp.zeros((G,), jnp.int32)
        shadowed = jnp.zeros((n,), jnp.int32)
        for slab in range(NS):
            k1 = first_cell * NS + slab
            k2 = last_cell * NS + slab
            lo = jnp.where(live, light_grid.cell_offset[k1], 0)
            hi = jnp.where(live, light_grid.cell_offset[k2]
                           + light_grid.cell_count[k2], 0)
            # Heavy faces exist only with one slab (see build).
            hhi = light_grid.heavy_count if use_heavy and slab == 0 else 0
            ranges = jnp.stack([lo, hi, zero, zero + hhi]).astype(
                jnp.int32)
            key = jnp.where(out_grid, -1, sorted_cells * NS + slab)
            sh = pt.shadow_sweep(ranges, pairs, heavy, srows.T,
                                 jnp.stack([key, gx, gy]), L, cfg=cfg,
                                 interpret=interpret)
            shadowed = jnp.maximum(shadowed, sh)
        shadowed = _unpermute(shadowed, sorted_ray)
        return shadowed.reshape(H, W), jnp.asarray(False)

    # Heavy-list occlusion (two-level grid): dense sweep over the few
    # global faces, in original ray order.  Sentinel-cell rays are
    # excluded — they test no triangles (SURVEY.md §3.5 divergence note).
    shadow_heavy = jnp.zeros((n,), dtype=jnp.int32)
    if use_heavy:
        from ugrt.trace import heavy as theavy

        delta0 = pts - L[None]
        dist0 = jnp.sqrt(dot(delta0, delta0))
        dirs0 = normalize(delta0, xp=jnp)
        co = theavy.heavy_coeffs(vertices, faces, light_grid.heavy_faces,
                                 light_grid.heavy_count, L,
                                 light_grid.heavy_ranges)
        # The ray's own light-grid cell coordinates (footprint mask);
        # sentinel cells yield gx == grid_x which matches no footprint.
        gx_r = cells // cfg.grid_y
        gy_r = cells % cfg.grid_y
        sh_h = theavy.heavy_shadowed(co, dirs0, dist0, gx_r, gy_r, cfg)
        shadow_heavy = jnp.where(cells < sentinel, sh_h, 0)

    # Pad the sorted stream to a whole number of R-ray blocks with
    # sentinel rays (masked everywhere by the cell-equality test).
    n_pad = -(-n // R) * R
    NB = n_pad // R
    scells = jnp.pad(sorted_cells, (0, n_pad - n),
                     constant_values=sentinel)
    srows = jnp.pad(srows, ((0, n_pad - n), (0, 0)))
    sh_dirs = srows[:, :3]
    dist_pt = srows[:, 3]

    # Cell runs (segments) of the sorted stream (XLA backend).
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    head = jnp.concatenate(
        [jnp.ones((1,), dtype=jnp.bool_),
         scells[1:] != scells[:-1]])
    seg_id = (jnp.cumsum(head.astype(jnp.int32)) - 1)
    nseg_cap = sentinel + 2  # distinct cells + sentinel + pad slot
    head_seg = jnp.where(head, seg_id, nseg_cap)
    seg_start = jnp.zeros((nseg_cap,), jnp.int32).at[head_seg].set(
        pos, mode="drop")
    seg_cell = jnp.full((nseg_cap,), sentinel, jnp.int32).at[head_seg].set(
        scells, mode="drop")
    seg_len = jax.ops.segment_sum(jnp.ones_like(seg_id), seg_id,
                                  num_segments=nseg_cap)
    b0 = seg_start // R
    b1 = jnp.maximum(seg_start + seg_len - 1, seg_start) // R
    nblk = jnp.where((seg_len > 0) & (seg_cell < sentinel),
                     b1 - b0 + 1, 0)

    if work_capacity is None:
        work_capacity = shadow_work_capacity(
            cfg, n, light_grid.sorted_faces.shape[0])
    wcap = work_capacity

    shadow_blocks = jnp.zeros((NB, R), dtype=jnp.int32)
    overflow = jnp.asarray(False)

    lane = jnp.arange(B, dtype=jnp.int32)
    ray_lane = jnp.arange(R, dtype=jnp.int32)

    for slab in range(NS):
        csr = jnp.clip(seg_cell * NS + slab, 0, cfg.num_cells - 1)
        cnt_seg = jnp.where(seg_cell < sentinel,
                            light_grid.cell_count[csr], 0)
        off_seg = light_grid.cell_offset[csr]
        nbt = (cnt_seg + (B - 1)) // B
        nunit = nblk * nbt
        ustart = jnp.cumsum(nunit) - nunit
        total_units = ustart[-1] + nunit[-1]
        overflow = overflow | (total_units > wcap)

        u = jnp.arange(wcap, dtype=jnp.int32)
        s_of = segment_ids_from_starts(ustart, wcap)
        uvalid = u < total_units
        r = u - ustart[s_of]
        nbt_c = jnp.maximum(nbt[s_of], 1)
        blk = jnp.clip(b0[s_of] + r // nbt_c, 0, NB - 1)
        bat = r % nbt_c
        w_off = off_seg[s_of] + bat * B
        w_cnt = jnp.where(uvalid, jnp.clip(cnt_seg[s_of] - bat * B, 0, B),
                          0)
        w_blk = jnp.where(uvalid, blk, NB)
        w_cell = seg_cell[s_of]

        def chunk_body(args):
            c_off, c_cnt, c_blk, c_cell = args
            idx = jnp.clip(c_off[:, None] + lane[None, :], 0,
                           light_grid.sorted_faces.shape[0] - 1)
            fidx = jnp.clip(light_grid.sorted_faces[idx], 0,
                            faces.shape[0] - 1)
            v = vertices[faces[fidx]]                    # [C, B, 3, 3]
            v0 = v[:, :, 0]
            e1 = v[:, :, 1] - v0
            e2 = v[:, :, 2] - v0
            tvec = L[None, None, :] - v0

            ridx = c_blk[:, None] * R + ray_lane[None, :]
            d = sh_dirs[ridx]                            # [C, R, 3]
            dp = dist_pt[ridx]                           # [C, R]
            rc = scells[ridx]                            # [C, R]

            tmt = moller_trumbore_t(tvec, e1, e2, d, cfg, abs_t=False)
            # intersectTri accept: nonzero and t < 999999.9
            # (light_kernel.cu:43-47); negative t passes.
            hit = (tmt != 0) & (tmt < jnp.float32(999999.9))
            if not cfg.quirks.shadow_accept_negative_t:
                hit = hit & (tmt > 0)

            occ = (L[None, None, None, :]
                   + tmt[..., None] * d[:, :, None, :])
            dl = occ - L[None, None, None, :]
            dist_occ = jnp.sqrt(dot(dl, dl))
            small = (dist_occ + jnp.float32(cfg.shadow_epsilon)
                     < dp[..., None])

            live_tri = (lane[None, None, :] < c_cnt[:, None, None])
            live_ray = rc == c_cell[:, None]
            sh = jnp.any(hit & small & live_tri, axis=-1) & live_ray
            return sh.astype(jnp.int32)                  # [C, R]

        def chunk_fn(args):
            # Work items are packed valid-first, so whole chunks
            # beyond the live count are dead — skip their compute.
            # Dead-branch outputs derive from traced inputs
            # (shard_map varying-axes provenance).
            def dead(a):
                return ((a[0][:, None] + ray_lane[None, :]) < 0
                        ).astype(jnp.int32)

            return jax.lax.cond(jnp.any(args[1] > 0), chunk_body,
                                dead, args)

        n_chunks = -(-wcap // chunk_size)
        pad = n_chunks * chunk_size - wcap

        def pad0(x):
            return jnp.pad(x, (0, pad))

        xs = (pad0(w_off).reshape(n_chunks, chunk_size),
              pad0(w_cnt).reshape(n_chunks, chunk_size),
              pad0(jnp.clip(w_blk, 0, NB - 1)).reshape(
                  n_chunks, chunk_size),
              pad0(w_cell).reshape(n_chunks, chunk_size))
        sh = jax.lax.map(chunk_fn, xs).reshape(-1, R)[:wcap]

        sh = jnp.where(uvalid[:, None], sh, 0)
        shadow_blocks = jnp.maximum(
            shadow_blocks,
            jax.ops.segment_max(sh, w_blk, num_segments=NB + 1)[:NB])

    shadowed = _unpermute(shadow_blocks.reshape(n_pad)[:n], sorted_ray)
    shadowed = jnp.maximum(shadowed, shadow_heavy)
    return shadowed.reshape(H, W), overflow
