"""Multi-chip sharding: shard_map over a ray/tile mesh axis.

The reference is single-GPU, single-process (SURVEY.md §2 parallelism
inventory); the distributed axis is a new design: shard rays/tiles
across devices and all-reduce the scene-parameter gradients.

Design:
  * mesh axis "rays" shards the image along tile COLUMNS (bx) — cell ids
    are x-major (bx * grid_y + by, grid_kernel.cu:322), so each device
    owns a contiguous cell range and a contiguous image strip;
  * the scene (vertices/faces/materials) is replicated; each device
    builds the (identical) grid locally — grid build is O(F + P log P)
    and replicating it avoids an all-gather of CSR arrays;
  * forward is embarrassingly parallel over strips; gradients of the
    replicated scene parameters are combined with one psum (which XLA
    hands to NCCL on GPUs).

Multi-host: call jax.distributed.initialize() before building the mesh;
everything below is host-count agnostic (jax.devices() spans all hosts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ugrt.config import RenderConfig
from ugrt.diff import render_grad
from ugrt.grid import build as gbuild
from ugrt.shade import shaders
from ugrt.trace import primary as tprimary
from ugrt.trace import refine as trefine
from ugrt.trace import shadow as tshadow


def make_mesh(devices=None, axis_name: str = "rays") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def _strip_color(vertices, materials, faces, mat_index, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool,
                 n_bx: int, axis_name: str, chunk_size: int,
                 trace_backend: str | None = None,
                 interpret: bool = False):
    """Per-device body: render this device's tile-column strip,
    differentiable in (vertices, materials).

    trace_backend None is the platform's default (the fused kernel on a
    GPU); interpret=True runs the kernel in the Pallas interpreter for
    CPU-mesh tests.  NOTE: the shadow pass sorts ALL rays of the full
    image in the single-device path; per-strip it sorts only this
    device's rays — results are identical (cell masking is per-ray)."""
    d = jax.lax.axis_index(axis_name)
    bx0 = d * n_bx
    vsg = jax.lax.stop_gradient(vertices)

    grid = gbuild.build_perspective_grid(
        vsg, faces, camcoords, cfg=cfg, capacity=capacity)
    raw = tprimary.trace_primary(vsg, faces, camcoords, grid, cfg,
                                 chunk_size=chunk_size, bx0=bx0, n_bx=n_bx,
                                 backend=trace_backend, interpret=interpret)

    eye = camcoords[0:3]
    shadowed = jnp.zeros(raw["t"].shape, dtype=jnp.int32)
    overflow = grid.overflow
    shade_cc = camcoords
    mode = cfg.light_grid_mode
    # "windowed" spreads geometry over the full grid (pairs stay
    # near the reference level); "extent" clamp-bloats edge cells
    # and needs headroom.  Overflow-flag guarded either way.
    lcap = 2 * capacity if mode == "extent" else capacity
    for li in range(num_lights):
        lcc = light_camcoords[li]
        # Extents/windows must agree across devices; each strip derives
        # them from its own rays and the mesh reduces (max/min).
        x_max = y_max = window = None
        if mode == "extent":
            x_max, y_max = tshadow.light_extents(raw, eye, lcc, cfg)
            x_max = jax.lax.pmax(x_max, axis_name)
            y_max = jax.lax.pmax(y_max, axis_name)
        elif mode == "windowed":
            # Reduce the RAW angle bounds, then re-apply the margin so
            # the result equals the single-device window of all rays.
            x0, x1, y0, y1 = tshadow.light_window(raw, eye, lcc, cfg,
                                                  margin=0.0)
            x0 = jax.lax.pmin(x0, axis_name)
            y0 = jax.lax.pmin(y0, axis_name)
            x1 = jax.lax.pmax(x1, axis_name)
            y1 = jax.lax.pmax(y1, axis_name)
            window = tshadow.apply_window_margin(x0, x1, y0, y1)
        lgrid = gbuild.build_spherical_grid(
            vsg, faces, lcc, cfg=cfg, capacity=lcap,
            x_max=x_max, y_max=y_max, window=window)
        sh, sh_ovf = tshadow.trace_shadow(vsg, faces, lcc, lgrid, raw, eye,
                                          cfg, chunk_size=chunk_size,
                                          backend=trace_backend,
                                          interpret=interpret,
                                          x_max=x_max, y_max=y_max,
                                          window=window)
        shadowed = jnp.maximum(shadowed, sh)
        overflow = overflow | lgrid.overflow | sh_ovf
        shade_cc = lcc
    shadowed = jax.lax.stop_gradient(shadowed)

    refined = trefine.refine_primary(vertices, faces, camcoords, raw, cfg)
    shader = shaders.spotlight if use_spot else shaders.lambert
    color = shader(refined, shade_cc, light_position, eye, mat_index,
                   materials, cfg, xp=jnp)
    return shaders.add_shadows_f32(color, shadowed, xp=jnp), overflow


def sharded_render(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                   num_lights: int, use_spot: bool,
                   chunk_size: int = 256,
                   trace_backend: str | None = None,
                   interpret: bool = False):
    """Returns a jitted function rendering the full image across the mesh:
    (image [H, W, 3] f32 sharded along W, overflow [] bool).

    overflow is the mesh-wide OR of every strip's capacity flags (pair
    buffer / heavy list / shadow work) — sharded rendering must surface
    clipped geometry exactly like the single-device path does."""
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    assert cfg.grid_x % ndev == 0, "grid_x must divide across devices"
    n_bx = cfg.grid_x // ndev

    strip = functools.partial(
        _strip_color, cfg=cfg, capacity=capacity, num_lights=num_lights,
        use_spot=use_spot, n_bx=n_bx, axis_name=axis,
        chunk_size=chunk_size, trace_backend=trace_backend,
        interpret=interpret)

    def body(*args):
        color, overflow = strip(*args)
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
        return color, overflow

    # check_vma=False: pallas_call outputs carry no varying-axes
    # metadata, which the jax 0.9 vma checker rejects under shard_map.
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(None, axis, None), P()), check_vma=False)
    return jax.jit(fn)


def sharded_train_step(mesh: Mesh, *, cfg: RenderConfig, capacity: int,
                       num_lights: int, use_spot: bool,
                       chunk_size: int = 256,
                       trace_backend: str | None = None,
                       interpret: bool = False):
    """Returns a jitted step: (verts, mats, ..., target) ->
    (loss, grad_verts, grad_mats, overflow) with gradients all-reduced
    (psum) over the mesh.

    target: full [H, W, 3] image (sharded along W like the render).
    overflow is the mesh-wide OR of capacity flags; callers must raise
    on it like train.py does (clipped geometry => corrupt gradients).
    """
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    assert cfg.grid_x % ndev == 0
    n_bx = cfg.grid_x // ndev

    def per_device(vertices, materials, faces, mat_index, camcoords,
                   light_camcoords, light_position, target_strip):
        def loss_fn(v, m):
            color, overflow = _strip_color(
                v, m, faces, mat_index, camcoords, light_camcoords,
                light_position, cfg=cfg, capacity=capacity,
                num_lights=num_lights, use_spot=use_spot, n_bx=n_bx,
                axis_name=axis, chunk_size=chunk_size,
                trace_backend=trace_backend, interpret=interpret)
            # Per-strip sum of squares; normalize by the global pixel
            # count so the psum'd loss equals the global MSE.
            return jnp.sum((color - target_strip) ** 2) / (
                3.0 * cfg.image_size), overflow

        (loss, overflow), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(vertices, materials)
        loss = jax.lax.psum(loss, axis)
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
        # Explicit gradient all-reduce over the mesh.  (With
        # check_vma=False the implicit psum of unvaried-primal cotangents
        # does not happen, so it must be spelled out.)
        gv, gm = grads
        gv = jax.lax.psum(gv, axis)
        gm = jax.lax.psum(gm, axis)
        return loss, gv, gm, overflow

    fn = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P(None, axis, None)),
        out_specs=(P(), P(), P(), P()), check_vma=False)
    return jax.jit(fn)
