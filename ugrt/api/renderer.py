"""Frame renderer — the equivalent of the reference's display() loop.

display() (/root/reference/main.cu:59-302) per frame: camera matrices →
perspective grid build → primary trace → per-light (spherical grid build +
shadow reorder + shadow trace) → shade (simpleShade for the first frame,
spotlight_shade after, main.cu:205-219) → add_shadows → image.

Here the whole frame is ONE jitted, statically-shaped XLA graph
(`render_frame_device`); camera matrix setup stays on host (tiny, float32,
GL-faithful — ugrt.core.camera) exactly like the reference computes them
on CPU via OpenGL.

State-machine parity note: the reference shades with whatever camcoords
the light loop left in constant memory — the LAST light's camera — and
with d_cam_position still holding the primary eye (SURVEY.md §3.2).  The
`shade_camcoords` argument makes that explicit; `render_frame` wires it
the reference's way.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.shade import shaders
from ugrt.trace import primary as tprimary
from ugrt.trace import shadow as tshadow


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "capacity", "num_lights", "use_spot",
                     "chunk_size", "trace_backend"))
def render_frame_device(vertices, faces, mat_index, materials,
                        camcoords, light_camcoords, light_position, *,
                        cfg: RenderConfig, capacity: int, num_lights: int,
                        use_spot: bool, chunk_size: int = 256,
                        trace_backend: str | None = None):
    """One fully-fused frame: returns dict with float RGB image [H,W,3],
    u8 image, shadow mask, and primary-hit buffers.

    light_camcoords: [num_lights, 64].  Shading uses the last light's
    camcoords when lights exist (reference behavior), else the camera's.
    trace_backend None selects the platform's default
    (ugrt.trace.default_trace_backend).
    """
    grid = gbuild.build_perspective_grid(
        vertices, faces, camcoords, cfg=cfg, capacity=capacity,
        align=1)
    primary = tprimary.trace_primary(
        vertices, faces, camcoords, grid, cfg, chunk_size=chunk_size,
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
            x_max, y_max = tshadow.light_extents(primary, eye, lcc, cfg)
        elif mode == "windowed":
            window = tshadow.light_window(primary, eye, lcc, cfg)
        lgrid = gbuild.build_spherical_grid(
            vertices, faces, lcc, cfg=cfg, capacity=lcap,
            align=1, x_max=x_max, y_max=y_max, window=window)
        sh, sh_ovf = tshadow.trace_shadow(
            vertices, faces, lcc, lgrid, primary, eye, cfg,
            chunk_size=chunk_size, backend=trace_backend,
            x_max=x_max, y_max=y_max, window=window)
        shadowed = jnp.maximum(shadowed, sh)
        overflow = overflow | lgrid.overflow | sh_ovf
        shade_cc = lcc

    if use_spot:
        color = shaders.spotlight(primary, shade_cc, light_position, eye,
                                  mat_index, materials, cfg, xp=jnp)
    else:
        color = shaders.lambert(primary, shade_cc, light_position, eye,
                                mat_index, materials, cfg, xp=jnp)

    image_u8 = shaders.add_shadows_u8(shaders.to_u8(color, xp=jnp),
                                      shadowed, xp=jnp)
    color_f = shaders.add_shadows_f32(color, shadowed, xp=jnp)

    return dict(image=image_u8, color=color_f, shadowed=shadowed,
                primary=primary, overflow=overflow)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "capacity", "num_lights", "use_spot",
                     "uniform_dims", "uniform_capacity", "reflectivity",
                     "chunk_size", "max_batches", "reflect_batch"))
def render_frame_reflective(vertices, faces, mat_index, materials,
                            camcoords, light_camcoords, light_position, *,
                            cfg: RenderConfig, capacity: int,
                            num_lights: int, use_spot: bool,
                            uniform_dims: tuple = (32, 32, 32),
                            uniform_capacity: int = 1 << 20,
                            reflectivity: float = 0.3,
                            chunk_size: int = 256,
                            max_batches: int = 8,
                            reflect_batch: int = 32):
    """BASELINE config 4: 2-level trace with a uniform-grid reflection
    bounce (the capability the reference's dead UniformGrid intended,
    uniform_grid.h:11-59 / README.md:1).

    color = (1 - kr) * primary_shaded + kr * reflection_shaded, with the
    reflection hit shaded by the same Lambert model lit from
    light_position.
    """
    from ugrt.core.vecmath import cross as _cross
    from ugrt.core.vecmath import normalize as _normalize
    from ugrt.trace import reflect as treflect

    base = render_frame_device(
        vertices, faces, mat_index, materials, camcoords, light_camcoords,
        light_position, cfg=cfg, capacity=capacity, num_lights=num_lights,
        use_spot=use_spot, chunk_size=chunk_size)
    primary = base["primary"]
    eye = camcoords[0:3]

    # Uniform grid over the (padded) scene AABB.
    lo = jnp.min(vertices, axis=0) - 1e-3
    hi = jnp.max(vertices, axis=0) + 1e-3
    ugrid = gbuild.build_uniform_grid(
        vertices, faces, lo, hi, grid_dims=uniform_dims,
        capacity=uniform_capacity)

    # Signed normals for the mirror direction (abs-normal is display-only).
    fid = primary["face_id"]
    v = vertices[faces[jnp.clip(fid, 0, None)]]
    nrm = _normalize(_cross(_normalize(v[..., 1, :] - v[..., 0, :], xp=jnp),
                            _normalize(v[..., 2, :] - v[..., 0, :], xp=jnp),
                            xp=jnp), xp=jnp)
    prim_signed = dict(t=primary["t"], face_id=fid, normal=nrm,
                       ray_dir=primary["ray_dir"])

    refl = treflect.reflection_pass(
        vertices, faces, prim_signed, ugrid, lo, hi, uniform_dims, cfg,
        eye, max_batches=max_batches, batch=reflect_batch)

    # Shade reflection hits with the Lambert model (flat normals of the
    # reflection hit face), lit from light_position.
    rfid = refl["face_id"]
    rv = vertices[faces[jnp.clip(rfid, 0, None)]]
    rn = _normalize(_cross(
        _normalize(rv[..., 1, :] - rv[..., 0, :], xp=jnp),
        _normalize(rv[..., 2, :] - rv[..., 0, :], xp=jnp), xp=jnp), xp=jnp)
    if cfg.quirks.abs_normal:
        rn = jnp.abs(rn)
    refl_primary = dict(t=refl["t"], face_id=rfid, normal=rn,
                        ray_dir=refl["ray_dir"])
    # Hit point = origin + t*dir; shade_core reconstructs from an 'eye';
    # reflection origins vary per pixel, so fold them in by passing the
    # per-pixel origin through a zero-eye trick: use point = origin +
    # t*dir directly via a wrapper primary whose ray_dir is scaled.
    shade_cc = light_camcoords[num_lights - 1] if num_lights > 0 \
        else camcoords
    refl_color = _shade_at_points(
        refl_primary, refl["origin"], shade_cc, light_position,
        mat_index, materials, cfg)

    kr = jnp.float32(reflectivity)
    mixed = ((1.0 - kr) * base["color"]
             + kr * jnp.where((rfid >= 0)[..., None], refl_color, 0.0))
    image_u8 = (jnp.clip(mixed, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    return dict(image=image_u8, color=mixed, reflection=refl,
                shadowed=base["shadowed"], primary=primary,
                overflow=base["overflow"] | ugrid.overflow
                | refl["overflow"])


def _shade_at_points(refl_primary, origins, shade_cc, light_position,
                     mat_index, materials, cfg):
    """Lambert shade where ray origins vary per pixel (reflection rays).

    shaders.shade_core assumes a single eye; reuse it by substituting the
    per-pixel origin as 'point = origin + t*dir' computed here."""
    from ugrt.core.vecmath import dot as _dot
    from ugrt.core.vecmath import normalize as _normalize
    from ugrt.core.vecmath import rotate_basis as _rot

    f32 = jnp.float32
    mv = shade_cc[16:32]
    tri = refl_primary["face_id"]
    idx = jnp.where(tri >= 0, mat_index[jnp.maximum(tri, 0)], -1)
    valid = (idx >= 0) & (idx < materials.shape[0])
    mats = materials[jnp.maximum(idx, 0)]
    ka = mats[..., 3:6] if cfg.quirks.ka_from_kd else mats[..., 0:3]
    kd = mats[..., 3:6]

    point = origins + refl_primary["t"][..., None] * refl_primary["ray_dir"]
    light_view = _rot(mv, jnp.asarray(light_position, dtype=f32), xp=jnp)
    point_view = _rot(mv, point, xp=jnp)
    normal_view = _normalize(_rot(mv, refl_primary["normal"], xp=jnp),
                             xp=jnp)
    light_dir = _normalize(point_view - light_view[None, None], xp=jnp)
    ndotl = _dot(light_dir, normal_view)
    if cfg.quirks.abs_n_dot_l:
        ndotl = jnp.abs(ndotl)
    diffuse = jnp.where(ndotl > 0, ndotl, f32(0.0))[..., None]
    color = ka * f32(0.5) + kd * diffuse
    color = jnp.clip(color, None, f32(1.0))
    return jnp.where(valid[..., None] & (refl_primary["t"][..., None] > 0),
                     color, f32(0.0))


class Renderer:
    """Host-side frame driver (the GLUT-loop replacement).

    Owns device copies of the scene, computes per-frame camera matrices on
    host, and invokes the fused frame graph.  The first rendered frame
    uses the plain Lambert shader and later frames the spotlight shader,
    matching main.cu:205-219 (frame_cnt < 2).
    """

    def __init__(self, scene, cfg: RenderConfig,
                 capacity: int | None = None):
        self.cfg = cfg
        self.vertices = jnp.asarray(scene.vertices)
        self.faces = jnp.asarray(scene.faces)
        self.mat_index = jnp.asarray(scene.mat_index)
        self.materials = jnp.asarray(scene.materials)
        self.capacity = (capacity if capacity is not None
                         else cfg.pair_capacity(scene.num_faces))
        self.frame_cnt = 0

    def update_vertices(self, vertices):
        """Dynamic scenes / animation: swap in new vertex positions."""
        self.vertices = jnp.asarray(vertices)

    def render(self, camera_spec: cam.CameraSpec,
               light_specs: Sequence[cam.CameraSpec],
               light_position, use_spot: bool | None = None,
               chunk_size: int = 256):
        cfg = self.cfg
        self.frame_cnt += 1
        if use_spot is None:
            use_spot = self.frame_cnt >= 2   # main.cu:205

        aspect = cfg.screen_width / cfg.screen_height
        cc = jnp.asarray(
            cam.camcoords_from_spec(camera_spec, cfg.fovy_deg, aspect))
        if light_specs:
            lccs = jnp.stack([
                jnp.asarray(
                    cam.camcoords_from_spec(ls, cfg.fovy_deg, aspect))
                for ls in light_specs])
        else:
            lccs = jnp.zeros((1, 64), dtype=jnp.float32)

        out = render_frame_device(
            self.vertices, self.faces, self.mat_index, self.materials,
            cc, lccs, jnp.asarray(np.asarray(light_position,
                                             dtype=np.float32)),
            cfg=cfg, capacity=self.capacity, num_lights=len(light_specs),
            use_spot=use_spot, chunk_size=chunk_size)
        return out
