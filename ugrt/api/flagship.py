"""The flagship workload, shared by bench.py, chip_smoke.py and the dry run.

The procedural sibenik-scale cathedral interior (~75k faces) at the
reference's 1024x1024 / 128x128-grid shape, lit by one light through the
windowed light grid, with the reference's camera and shadow-camera
presets (main.cu:87-90, :158-164).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ugrt.config import RenderConfig
from ugrt.core import camera as cam

CAMERA = cam.CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                        up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = cam.CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
NUM_FACES = 75000
# Pixels whose shadow flag the kernel may flip against the XLA path:
# its float32 arithmetic is contracted into FMAs by another compiler
# (Triton, not XLA), so a shadow ray whose occluder distance sits within
# an ulp of the shadow_epsilon margin or of a u/v accept edge can flip.
SHADOW_PX_BOUND = 16


def config(size: int = 1024,
           light_grid_mode: str = "windowed") -> RenderConfig:
    """RenderConfig at ``size``² pixels over a size/8 grid."""
    return dataclasses.replace(
        RenderConfig(), screen_width=size, screen_height=size,
        grid_x=size // 8, grid_y=size // 8, light_grid_mode=light_grid_mode)


def inputs(cfg: RenderConfig, scene=None, num_faces: int = NUM_FACES):
    """Device arrays of one flagship step: dict with vertices, materials,
    faces, mat_index, cc (camera camcoords), lcc ([1, 64] light
    camcoords), lp (light position), target (zeros), capacity, scene."""
    if scene is None:
        from ugrt.scene import procedural
        scene = procedural.cathedral(num_faces_target=num_faces)
    aspect = cfg.screen_width / cfg.screen_height
    return dict(
        scene=scene,
        vertices=jnp.asarray(scene.vertices),
        materials=jnp.asarray(scene.materials),
        faces=jnp.asarray(scene.faces),
        mat_index=jnp.asarray(scene.mat_index),
        cc=jnp.asarray(cam.camcoords_from_spec(CAMERA, cfg.fovy_deg,
                                               aspect)),
        lcc=jnp.asarray(cam.camcoords_from_spec(LIGHT, cfg.fovy_deg,
                                                aspect))[None],
        lp=jnp.asarray(np.asarray(LIGHT.eye, dtype=np.float32)),
        target=jnp.zeros((cfg.screen_height, cfg.screen_width, 3),
                         jnp.float32),
        capacity=cfg.pair_capacity(scene.num_faces),
    )


def trace_both(cfg: RenderConfig, inp):
    """Primary and shadow passes of one frame through the XLA path and
    the fused kernel, on the same grids: numpy dict of face ids, t,
    shadow masks (``*_x`` XLA, ``*_k`` kernel) and the XLA overflow."""
    from ugrt.grid import build as gbuild
    from ugrt.trace import primary as tprim
    from ugrt.trace import shadow as tshadow

    mode = cfg.light_grid_mode
    if mode not in ("windowed", "reference"):
        raise ValueError(f"trace_both does not model mode {mode!r}")
    f, cc, lcc, cap = inp["faces"], inp["cc"], inp["lcc"][0], \
        inp["capacity"]

    @jax.jit
    def both(v):
        grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg,
                                             capacity=cap)
        rx = tprim.trace_primary(v, f, cc, grid, cfg, backend="xla")
        rk = tprim.trace_primary(v, f, cc, grid, cfg, backend="pallas")
        eye = cc[0:3]
        window = (tshadow.light_window(rx, eye, lcc, cfg)
                  if mode == "windowed" else None)
        lgrid = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg,
                                            capacity=cap, window=window)
        sx, ovf = tshadow.trace_shadow(v, f, lcc, lgrid, rx, eye, cfg,
                                       backend="xla", window=window)
        sk, _ = tshadow.trace_shadow(v, f, lcc, lgrid, rx, eye, cfg,
                                     backend="pallas", window=window)
        return dict(face_x=rx["face_id"], face_k=rk["face_id"],
                    t_x=rx["t"], t_k=rk["t"], shadow_x=sx, shadow_k=sk,
                    overflow=ovf | grid.overflow | lgrid.overflow)

    return {k: np.asarray(a) for k, a in both(inp["vertices"]).items()}
