"""Differentiable rendering: gradients w.r.t. vertices and materials.

The reverse-mode path the reference lacks (BASELINE.json north star).
Structure (see ugrt.trace.refine for the rationale):

    stop_grad(vertices) ─→ grid build ─→ combinatorial trace ─→ face ids
    vertices ───────────────────────────→ differentiable refinement ─┐
    materials ──────────────────────────→ shading ───────────────────┴→ color

The shadow mask is binary (piecewise constant) and stop-gradded; shadow
darkening uses the float /3 variant so its scaling still modulates
material/vertex gradients.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ugrt.config import RenderConfig
from ugrt.grid import build as gbuild
from ugrt.shade import shaders
from ugrt.trace import primary as tprimary
from ugrt.trace import refine as trefine
from ugrt.trace import shadow as tshadow


def render_color(vertices, materials, faces, mat_index, camcoords,
                 light_camcoords, light_position, *, cfg: RenderConfig,
                 capacity: int, num_lights: int, use_spot: bool,
                 chunk_size: int = 256, trace_backend: str | None = None):
    """(Float RGB [H, W, 3] image, overflow []) — differentiable w.r.t.
    vertices and materials.  Matches the u8 reference image up to
    quantization.  ``overflow`` is true when any static capacity (pair
    buffer, heavy list, shadow work) clipped real work: the image then
    silently misses geometry and gradients are corrupt — callers must
    surface it (train.py raises)."""
    vsg = jax.lax.stop_gradient(vertices)

    grid = gbuild.build_perspective_grid(
        vsg, faces, camcoords, cfg=cfg, capacity=capacity)
    raw = tprimary.trace_primary(vsg, faces, camcoords, grid, cfg,
                                 chunk_size=chunk_size,
                                 backend=trace_backend)

    eye = camcoords[0:3]
    H, W = cfg.screen_height, cfg.screen_width
    shadowed = jnp.zeros((H, W), dtype=jnp.int32)
    overflow = grid.overflow
    shade_cc = camcoords
    mode = cfg.light_grid_mode
    # "windowed" spreads geometry over the full grid: measured pair
    # counts are 0.65x capacity at 74k faces and 0.80x at 51k on the
    # flagship interior scenes, so the 1x budget holds
    # with >=20% slack; "extent" clamp-bloats edge cells and needs
    # headroom.  Overflow-flag guarded either way.
    lcap = 2 * capacity if mode == "extent" else capacity
    for li in range(num_lights):
        lcc = light_camcoords[li]
        x_max = y_max = window = None
        if mode == "extent":
            x_max, y_max = tshadow.light_extents(raw, eye, lcc, cfg)
        elif mode == "windowed":
            window = tshadow.light_window(raw, eye, lcc, cfg)
        lgrid = gbuild.build_spherical_grid(
            vsg, faces, lcc, cfg=cfg, capacity=lcap,
            x_max=x_max, y_max=y_max, window=window)
        sh, sh_ovf = tshadow.trace_shadow(vsg, faces, lcc, lgrid, raw, eye,
                                         cfg, chunk_size=chunk_size,
                                         backend=trace_backend,
                                         x_max=x_max, y_max=y_max,
                                         window=window)
        shadowed = jnp.maximum(shadowed, sh)
        overflow = overflow | lgrid.overflow | sh_ovf
        shade_cc = lcc
    shadowed = jax.lax.stop_gradient(shadowed)

    refined = trefine.refine_primary(
        vertices, faces, camcoords, raw, cfg,
        face_aux=shaders.face_shade_meta(mat_index, materials.shape[0],
                                         jnp))

    if use_spot:
        color = shaders.spotlight(refined, shade_cc, light_position, eye,
                                  mat_index, materials, cfg, xp=jnp)
    else:
        color = shaders.lambert(refined, shade_cc, light_position, eye,
                                mat_index, materials, cfg, xp=jnp)
    return shaders.add_shadows_f32(color, shadowed, xp=jnp), overflow


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "capacity", "num_lights", "use_spot",
                     "chunk_size", "trace_backend"))
def render_and_grad(vertices, materials, faces, mat_index, camcoords,
                    light_camcoords, light_position, target, *,
                    cfg: RenderConfig, capacity: int, num_lights: int,
                    use_spot: bool, chunk_size: int = 256,
                    trace_backend: str | None = None):
    """Image + MSE-to-target loss + gradients w.r.t. (vertices, materials).

    The canonical inverse-rendering step: everything (grid rebuild, trace,
    shadow, shade, backward) is one XLA graph.  ``overflow`` in the result
    flags clipped static capacities (gradients untrustworthy).
    """

    def loss_fn(verts, mats):
        color, overflow = render_color(
            verts, mats, faces, mat_index, camcoords, light_camcoords,
            light_position, cfg=cfg, capacity=capacity,
            num_lights=num_lights, use_spot=use_spot,
            chunk_size=chunk_size, trace_backend=trace_backend)
        return jnp.mean((color - target) ** 2), (color, overflow)

    (loss, (color, overflow)), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(vertices, materials)
    return dict(loss=loss, color=color, grad_vertices=grads[0],
                grad_materials=grads[1], overflow=overflow)
