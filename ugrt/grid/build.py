"""Grid construction as pure XLA ops — the CUDPP replacement.

The reference builds its CSR grid with a count kernel, host z-reduction,
cudppScan, a per-frame cudaMalloc sized by a device->host readback, a fill
kernel, cudppSort and a histogram (FrustumGrid::buildGrid,
/root/reference/frustum_grid.h:210-366).  That pipeline ping-pongs between
host and device three times per frame (SURVEY.md §3.3) — poison for XLA.

Here the whole build is one fused, statically-shaped graph (pure
functions — callers jit them, typically as part of the whole frame;
nesting jit inside jit adds nothing and jax 0.9's inner-jit jaxpr/const
caching miscounts executable parameters when the same builder runs both
at top level and inside a grad trace):

  counts  — vmapped binning (ugrt.grid.binning)
  z-range — on-device masked min/max (no host roundtrip)
  expand  — segment-id ragged expansion (scatter-add + cumsum,
            ugrt.core.ragged) into a static-capacity pair buffer
            (replaces DSFillkernel's nested scatter loops)
  sort    — jax.lax.sort key-value (stable, like CUDPP radix sort)
  CSR     — segment_sum histogram + exclusive cumsum

Data-dependent totals are handled by capacity + masking with an overflow
flag (recompile with a larger RenderConfig.pair_capacity_factor if set).

One deliberate unification: the reference triplicates this pipeline
(FrustumGrid::buildGrid, buildSphericalGrid, UniformGrid::buildGrid,
uniform_grid.h:196-350); here a single implementation is parameterized by
the binning projection (perspective / spherical / world-uniform).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ugrt.config import RenderConfig
from ugrt.core.ragged import segment_ids_from_starts
from ugrt.grid import binning


class DeviceGrid(NamedTuple):
    """CSR acceleration structure (mirrors d_span/d_offset/
    d_triangle_value_list, frustum_grid.h:21-29) plus static capacity
    bookkeeping.

    Two-level split: faces whose footprint covers >= heavy_threshold cells
    (typically behind-the-eye geometry whose clip-space AABB explodes to
    the whole grid — which the reference duplicates into EVERY cell's
    list, frustum_grid.h:254 reallocates to fit) are pulled out of the
    pair expansion into `heavy_faces`, a small global list the tracers
    sweep densely for every ray.  Results are identical (the union of
    candidate sets is unchanged; winner selection uses (t, face-id)
    lex-min, which equals the reference's strict-< scan over its
    face-ascending merged cell list) but the pair buffer shrinks by the
    duplication factor (~20x on reference-scale interior scenes).
    heavy_faces is empty (capacity 0) when the split is disabled.
    """

    sorted_faces: jax.Array   # [capacity] int32, face id per pair, -1 pad
    sorted_keys: jax.Array    # [capacity] int32 cell keys (sentinel pad)
    cell_count: jax.Array     # [num_cells] int32
    cell_offset: jax.Array    # [num_cells] int32 exclusive scan
    total_pairs: jax.Array    # [] int32 (clamped to capacity)
    overflow: jax.Array       # [] bool — true pair count exceeded capacity
    heavy_faces: jax.Array    # [heavy_capacity] int32 face ids (-1 pad)
    heavy_count: jax.Array    # [] int32 (clamped to heavy_capacity)
    # [heavy_capacity, 4] int32 (gxmin, gxmax, gymin, gymax): the face's
    # cell footprint.  A ray only tests a heavy face when its own cell
    # lies inside — exactly the rays that would have found the face in
    # their cell list (partial-footprint heavy faces are still only
    # visible to rays in their footprint).
    heavy_ranges: jax.Array


def _split_heavy(ranges, cfg: RenderConfig, heavy_threshold: int,
                 heavy_capacity: int):
    """Split faces into (light ranges, heavy face list).

    Heavy = footprint >= heavy_threshold cells.  Light faces keep their
    ranges; heavy faces get counts=0 (no pairs) and are packed ascending
    into a static [heavy_capacity] list (-1 pad).  Only valid for
    num_slabs==1 (with z-slabs a heavy face would belong to one slab bin,
    which the global sweep does not model) — the builders disable the
    split automatically for multi-slab configs.
    """
    counts = ranges["counts"].astype(jnp.int32)
    heavy = counts >= heavy_threshold
    num_faces = counts.shape[0]

    face_ids = jnp.arange(num_faces, dtype=jnp.int32)
    marked = jnp.where(heavy, face_ids, jnp.int32(2**31 - 1))
    if num_faces < heavy_capacity:
        marked = jnp.pad(marked, (0, heavy_capacity - num_faces),
                         constant_values=2**31 - 1)
    packed = jnp.sort(marked)[:heavy_capacity]
    n_heavy = jnp.sum(heavy.astype(jnp.int32))
    heavy_faces = jnp.where(
        jnp.arange(heavy_capacity, dtype=jnp.int32)
        < jnp.minimum(n_heavy, heavy_capacity), packed, -1)

    fidx = jnp.clip(heavy_faces, 0, num_faces - 1)
    heavy_ranges = jnp.stack(
        [ranges["gxmin"][fidx], ranges["gxmax"][fidx],
         ranges["gymin"][fidx], ranges["gymax"][fidx]],
        axis=1).astype(jnp.int32)
    # dead slots: empty range (1, 0, 1, 0) so no ray's cell matches.
    # (iota parity instead of an array literal: trace-time consts become
    # executable parameters in jax 0.9 and are avoided in jitted paths)
    col = jax.lax.broadcasted_iota(jnp.int32, (heavy_capacity, 4), 1)
    empty_range = 1 - (col % 2)
    dead = (heavy_faces < 0)[:, None]
    heavy_ranges = jnp.where(dead, empty_range, heavy_ranges)

    light = dict(ranges)
    light["counts"] = jnp.where(heavy, 0, counts)
    heavy_overflow = n_heavy > heavy_capacity
    return (light, heavy_faces,
            jnp.minimum(n_heavy, heavy_capacity), heavy_overflow,
            heavy_ranges)


def _expand_and_sort(ranges, gz, cfg: RenderConfig, capacity: int,
                     align: int = 1):
    """Ragged expand + stable sort + CSR from per-face cell ranges.

    Pair keys replicate grid_kernel.cu:322:
      key = ((gxmin+i) * grid_y + (gymin+j)) * num_slabs + gz
    enumerated i-major, j-minor, faces ascending — so the stably sorted
    value list matches CUDPP's radix-sorted output order exactly.

    align > 1 inserts per-cell padding pairs (face -1) so every cell
    segment STARTS at a multiple of `align` (an aligned layout produced
    natively by the sort instead of a post-hoc scatter; every tracer
    rejects the padding pairs).  cell_count stays the REAL count (padding rows are
    masked by it); cell_offset points into the padded layout.
    """
    num_cells = cfg.num_cells
    sentinel = num_cells  # sorts after every real cell key

    counts = ranges["counts"].astype(jnp.int32)
    size_y = (ranges["gymax"] - ranges["gymin"] + 1).astype(jnp.int32)

    incl = jnp.cumsum(counts)
    total = incl[-1]
    offsets = incl - counts

    p = jnp.arange(capacity, dtype=jnp.int32)
    face_c = segment_ids_from_starts(offsets, capacity)
    valid = p < total

    # Expansion gathers are [capacity]-wide, so gather ONE packed
    # per-face row (offset, size_y, base) instead of 5 separate fields.
    # base = key(gxmin, gymin, gz); key(i, j) = base + (i*grid_y + j)*NS.
    base = (((ranges["gxmin"] * cfg.grid_y + ranges["gymin"])
             * cfg.num_slabs) + gz).astype(jnp.int32)
    per_face = jnp.stack(
        [offsets.astype(jnp.int32), size_y, base], axis=1)   # [F, 3]
    g = per_face[face_c]                                     # [cap, 3]

    k = p - g[:, 0]
    sy = g[:, 1]
    i = k // sy
    j = k - i * sy
    key = (g[:, 2]
           + (i * cfg.grid_y + j) * cfg.num_slabs).astype(jnp.int32)

    key = jnp.where(valid, key, sentinel)
    val = jnp.where(valid, face_c, -1)

    if align > 1:
        # The align path pads per cell BEFORE the sort and needs the
        # histogram up front; a 16k-bin scatter-add over the (unsorted)
        # keys is acceptable off the hot path.
        cell_count = jax.ops.segment_sum(
            valid.astype(jnp.int32), key,
            num_segments=num_cells + 1)[:num_cells].astype(jnp.int32)
        # Padding pairs per cell: roundup(count) - count, keyed by the
        # cell; appended AFTER the real pairs so the stable sort places
        # them at each cell segment's end.
        pad_per_cell = ((cell_count + (align - 1)) // align * align
                        - cell_count)
        pad_cap = (align - 1) * num_cells
        pincl = jnp.cumsum(pad_per_cell)
        q = jnp.arange(pad_cap, dtype=jnp.int32)
        pcell = segment_ids_from_starts(pincl - pad_per_cell, pad_cap)
        pvalid = q < pincl[-1]
        pad_key = jnp.where(pvalid, pcell, sentinel)
        key = jnp.concatenate([key, pad_key.astype(jnp.int32)])
        val = jnp.concatenate(
            [val, jnp.full((pad_cap,), -1, dtype=jnp.int32)])
        padded_count = cell_count + pad_per_cell

    # Single-key packed sort when (cell, face) fits 32 bits: the radix
    # analog of CUDPP's kv sort at roughly half the cost.  Real faces
    # sort ascending within a cell (matching the stable kv sort) and the
    # padding marker (all-ones) sorts after them.
    key_bits = max(int(num_cells + 1).bit_length(), 1)
    face_bits = 32 - key_bits
    num_faces_total = ranges["counts"].shape[0]
    if 0 < face_bits and num_faces_total < (1 << face_bits) - 1:
        marker = (1 << face_bits) - 1
        face_code = jnp.where(val >= 0, val, marker).astype(jnp.uint32)
        packed = ((key.astype(jnp.uint32) << face_bits) | face_code)
        packed = jax.lax.sort(packed)
        sorted_key = (packed >> face_bits).astype(jnp.int32)
        fc = (packed & jnp.uint32(marker)).astype(jnp.int32)
        sorted_val = jnp.where(fc == marker, -1, fc)
    else:
        sorted_key, sorted_val = jax.lax.sort((key, val), num_keys=1)

    if align > 1:
        cell_offset = (jnp.cumsum(padded_count)
                       - padded_count).astype(jnp.int32)
    else:
        # CSR from the SORTED keys: offsets[c] = # pairs with key < c —
        # a two-level search (ugrt.core.ragged.searchsorted_2level)
        # instead of a 590k scatter-add histogram or jnp.searchsorted's
        # serial while loop.
        from ugrt.core.ragged import searchsorted_2level
        bounds = searchsorted_2level(
            sorted_key, jnp.arange(num_cells + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
        cell_offset = bounds[:num_cells]
        cell_count = bounds[1:] - bounds[:-1]

    return DeviceGrid(
        sorted_faces=sorted_val.astype(jnp.int32),
        sorted_keys=sorted_key.astype(jnp.int32),
        cell_count=cell_count,
        cell_offset=cell_offset,
        total_pairs=jnp.minimum(total, capacity).astype(jnp.int32),
        overflow=total > capacity,
        heavy_faces=jnp.full((0,), -1, dtype=jnp.int32),
        heavy_count=jnp.int32(0),
        heavy_ranges=jnp.zeros((0, 4), dtype=jnp.int32),
    )


def build_perspective_grid(vertices, faces, camcoords, *,
                           cfg: RenderConfig, capacity: int,
                           align: int = 1,
                           heavy_threshold: int | None = None) -> DeviceGrid:
    """Perspective grid over camera clip space (buildGrid).

    heavy_threshold (None = cfg.heavy_threshold; 0 disables) activates
    the two-level split — see DeviceGrid."""
    if heavy_threshold is None:
        heavy_threshold = cfg.heavy_threshold
    if cfg.num_slabs > 1:
        heavy_threshold = 0  # split needs per-slab modeling; disable
    r = binning.perspective_face_ranges(
        vertices, faces, camcoords, cfg.grid_x, cfg.grid_y, cfg.num_slabs,
        xp=jnp)
    if heavy_threshold > 0 and cfg.heavy_capacity > 0:
        r, hf, hc, hov, hr = _split_heavy(r, cfg, heavy_threshold,
                                          cfg.heavy_capacity)
    else:
        hf, hc, hov = (jnp.full((0,), -1, jnp.int32), jnp.int32(0),
                       jnp.asarray(False))
        hr = jnp.zeros((0, 4), jnp.int32)
    z_lo, z_hi = binning.z_minmax(r["zmin"], xp=jnp)
    gz = binning.slab_bins(r["zmin"], z_lo, z_hi, cfg.num_slabs, xp=jnp)
    g = _expand_and_sort(r, gz, cfg, capacity, align)
    return g._replace(heavy_faces=hf, heavy_count=hc, heavy_ranges=hr,
                      overflow=g.overflow | hov)


def build_spherical_grid(vertices, faces, camcoords, *,
                         cfg: RenderConfig, capacity: int,
                         x_max: float | None = None,
                         y_max: float | None = None,
                         window=None,
                         align: int = 1,
                         heavy_threshold: int | None = None) -> DeviceGrid:
    """Spherical light-centric grid (buildSphericalGrid); angular extent
    defaults to pi per main.cu:186-187.  ``window`` (x0, x1, y0, y1)
    selects the windowed affine parameterization instead
    (RenderConfig.light_grid_mode \"windowed\")."""
    if heavy_threshold is None:
        heavy_threshold = cfg.heavy_threshold
        # (Windowed mode keeps the same threshold: raising it to shrink
        # the heavy list was measured to bloat the pair buffer faster
        # than it removes heavy windows — 256 -> 2048 costs +394k pairs
        # to drop 2 of 5 windows on the flagship scene.)
    if cfg.num_slabs > 1:
        heavy_threshold = 0  # split needs per-slab modeling; disable
    if window is not None:
        r = binning.windowed_face_ranges(
            vertices, faces, camcoords, cfg.grid_x, cfg.grid_y,
            cfg.num_slabs, window, xp=jnp)
    else:
        x_max = cfg.angular_extent if x_max is None else x_max
        y_max = cfg.angular_extent if y_max is None else y_max
        r = binning.spherical_face_ranges(
            vertices, faces, camcoords, cfg.grid_x, cfg.grid_y,
            cfg.num_slabs, x_max, y_max, cfg.quirks.y_forward_dot_typo,
            xp=jnp)
    if heavy_threshold > 0 and cfg.heavy_capacity > 0:
        r, hf, hc, hov, hr = _split_heavy(r, cfg, heavy_threshold,
                                          cfg.heavy_capacity)
    else:
        hf, hc, hov = (jnp.full((0,), -1, jnp.int32), jnp.int32(0),
                       jnp.asarray(False))
        hr = jnp.zeros((0, 4), jnp.int32)
    z_lo, z_hi = binning.z_minmax(r["zmin"], xp=jnp)
    gz = binning.slab_bins(r["zmin"], z_lo, z_hi, cfg.num_slabs, xp=jnp)
    g = _expand_and_sort(r, gz, cfg, capacity, align)
    return g._replace(heavy_faces=hf, heavy_count=hc, heavy_ranges=hr,
                      overflow=g.overflow | hov)


def uniform_face_ranges(vertices, faces, aabb_min, aabb_max,
                        grid_x, grid_y, grid_z, xp=jnp):
    """World-space uniform grid binning for reflection rays.

    The reference's UniformGrid (uniform_grid.h:11-59) was intended for
    reflection rays (README.md:1) but its build reuses the perspective
    DSKernel and is never instantiated (SURVEY.md §2).  This is the actual
    world-space binning that intent requires: per-face AABB over the scene
    AABB, cells keyed (gx * grid_y + gy) * grid_z + gz.
    """
    v = vertices[faces]                       # [F, 3, 3]
    lo = xp.asarray(aabb_min, dtype=xp.float32)
    hi = xp.asarray(aabb_max, dtype=xp.float32)
    extent = hi - lo
    dims = xp.asarray([grid_x, grid_y, grid_z], dtype=xp.float32)

    fmin = (xp.min(v, axis=1) - lo) / extent * dims
    fmax = (xp.max(v, axis=1) - lo) / extent * dims
    gmin = xp.clip(xp.floor(fmin).astype(xp.int32), 0,
                   xp.asarray([grid_x - 1, grid_y - 1, grid_z - 1]))
    gmax = xp.clip(xp.floor(fmax).astype(xp.int32), 0,
                   xp.asarray([grid_x - 1, grid_y - 1, grid_z - 1]))

    counts = ((gmax[:, 0] - gmin[:, 0] + 1)
              * (gmax[:, 1] - gmin[:, 1] + 1)
              * (gmax[:, 2] - gmin[:, 2] + 1)).astype(xp.int32)
    return dict(gmin=gmin, gmax=gmax, counts=counts)


def build_uniform_grid(vertices, faces, aabb_min, aabb_max, *,
                       grid_dims: tuple[int, int, int],
                       capacity: int) -> DeviceGrid:
    """Uniform world-space grid build (3-D ragged expand + sort + CSR)."""
    gx, gy, gz_dim = grid_dims
    num_cells = gx * gy * gz_dim
    r = uniform_face_ranges(vertices, faces, aabb_min, aabb_max,
                            gx, gy, gz_dim, xp=jnp)

    counts = r["counts"]
    sx = r["gmax"][:, 0] - r["gmin"][:, 0] + 1
    sy = r["gmax"][:, 1] - r["gmin"][:, 1] + 1
    sz = r["gmax"][:, 2] - r["gmin"][:, 2] + 1

    incl = jnp.cumsum(counts)
    total = incl[-1]
    offsets = incl - counts

    p = jnp.arange(capacity, dtype=jnp.int32)
    face_c = segment_ids_from_starts(offsets, capacity)
    valid = p < total

    k = p - offsets[face_c]
    syz = sy[face_c] * sz[face_c]
    i = k // syz
    rem = k - i * syz
    j = rem // sz[face_c]
    kk = rem - j * sz[face_c]
    key = (((r["gmin"][face_c, 0] + i) * gy
            + (r["gmin"][face_c, 1] + j)) * gz_dim
           + (r["gmin"][face_c, 2] + kk)).astype(jnp.int32)

    key = jnp.where(valid, key, num_cells)
    val = jnp.where(valid, face_c, -1)
    sorted_key, sorted_val = jax.lax.sort((key, val), num_keys=1)

    cell_count = jax.ops.segment_sum(
        jnp.ones_like(sorted_key), sorted_key, num_segments=num_cells + 1,
        indices_are_sorted=True)[:num_cells].astype(jnp.int32)
    cell_offset = (jnp.cumsum(cell_count) - cell_count).astype(jnp.int32)

    return DeviceGrid(
        sorted_faces=sorted_val.astype(jnp.int32),
        sorted_keys=sorted_key.astype(jnp.int32),
        cell_count=cell_count,
        cell_offset=cell_offset,
        total_pairs=jnp.minimum(total, capacity).astype(jnp.int32),
        overflow=total > capacity,
        heavy_faces=jnp.full((0,), -1, dtype=jnp.int32),
        heavy_count=jnp.int32(0),
        heavy_ranges=jnp.zeros((0, 4), dtype=jnp.int32),
    )
