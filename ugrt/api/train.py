"""Inverse-rendering training loop.

Example production driver for the new capability stack: optimize scene
parameters (vertices and/or materials) to match target images, optionally
sharded across a device mesh, with checkpoint/resume — the "multi-frame
animated camera, gradients w.r.t. vertices + materials, sharded across
N>=2 hosts" configuration of BASELINE.json (config 5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

try:
    import optax
    _HAS_OPTAX = True
except Exception:  # pragma: no cover
    _HAS_OPTAX = False

from ugrt.api import checkpoint as ckpt
from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.diff import render_grad
from ugrt.dist import mesh as dmesh


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-2
    steps: int = 100
    optimize_vertices: bool = True
    optimize_materials: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    use_mesh: bool = False  # shard over all available devices


def train(scene, camera_specs: Sequence[cam.CameraSpec],
          light_spec: cam.CameraSpec, light_position, targets,
          cfg: RenderConfig, tcfg: TrainConfig, verbose: bool = True):
    """Optimize scene params against per-frame targets.

    camera_specs: one camera per frame (animated path); targets: list of
    [H, W, 3] float32 images.  Returns final (vertices, materials, log).
    """
    assert _HAS_OPTAX, "optax required for the training loop"
    aspect = cfg.screen_width / cfg.screen_height
    cap = cfg.pair_capacity(scene.num_faces)

    faces = jnp.asarray(scene.faces)
    mat_index = jnp.asarray(scene.mat_index)
    lcc = jnp.asarray(
        cam.camcoords_from_spec(light_spec, cfg.fovy_deg, aspect))[None]
    lp = jnp.asarray(np.asarray(light_position, dtype=np.float32))
    ccs = [jnp.asarray(cam.camcoords_from_spec(s, cfg.fovy_deg, aspect))
           for s in camera_specs]

    params = dict(vertices=jnp.asarray(scene.vertices),
                  materials=jnp.asarray(scene.materials))
    opt = optax.adam(tcfg.learning_rate)
    opt_state = opt.init(params)

    start_step = 0
    if tcfg.checkpoint_dir:
        latest = ckpt.latest_step(tcfg.checkpoint_dir)
        if latest is not None:
            state = ckpt.load_checkpoint(tcfg.checkpoint_dir, latest)
            params = dict(vertices=jnp.asarray(state["params/vertices"]),
                          materials=jnp.asarray(state["params/materials"]))
            start_step = latest + 1
            if verbose:
                print(f"resumed from step {latest}")

    if tcfg.use_mesh:
        mesh = dmesh.make_mesh()
        step_fns = {}

        def grads_for(frame, p):
            if "fn" not in step_fns:
                step_fns["fn"] = dmesh.sharded_train_step(
                    mesh, cfg=cfg, capacity=cap, num_lights=1,
                    use_spot=True)
            loss, gv, gm, overflow = step_fns["fn"](
                p["vertices"], p["materials"], faces, mat_index,
                ccs[frame], lcc, lp, targets[frame])
            return loss, dict(vertices=gv, materials=gm), overflow
    else:
        # One plain inner function under ONE outer jit, with every device
        # array passed explicitly (no closure-captured jnp constants):
        # jax 0.9's const-hoisting turns captured arrays into hidden
        # executable parameters whose count can go stale across traces
        # ("Execution supplied N buffers but compiled program expected M").
        def _loss(v, m, f, mi, cc, lc, l, target):
            color, overflow = render_grad.render_color(
                v, m, f, mi, cc, lc, l, cfg=cfg,
                capacity=cap, num_lights=1, use_spot=True)
            return jnp.mean((color - target) ** 2), overflow

        grad_fn = jax.jit(
            jax.value_and_grad(_loss, argnums=(0, 1), has_aux=True))

        def grads_for(frame, p):
            (loss, overflow), (gv, gm) = grad_fn(
                p["vertices"], p["materials"], faces, mat_index,
                ccs[frame], lcc, lp, targets[frame])
            return loss, dict(vertices=gv, materials=gm), overflow

    log = []
    for step in range(start_step, tcfg.steps):
        frame = step % len(camera_specs)
        loss, grads, overflow = grads_for(frame, params)
        if not tcfg.optimize_vertices:
            grads["vertices"] = jnp.zeros_like(grads["vertices"])
        if not tcfg.optimize_materials:
            grads["materials"] = jnp.zeros_like(grads["materials"])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # ONE host pull for both scalars: the loss sync the loop already
        # pays doubles as the overflow check (keeps dispatch async —
        # checking overflow alone would add a serializing device fence).
        loss_v, ovf_v = jax.device_get((loss, overflow))
        if bool(ovf_v):
            raise RuntimeError(
                "static capacity overflow during training step: "
                "geometry was clipped and gradients are corrupt — "
                "raise RenderConfig.pair_capacity_factor / "
                "heavy_capacity / shadow work capacity")
        log.append(float(loss_v))
        if verbose and (step % 10 == 0 or step == tcfg.steps - 1):
            print(f"step {step}: loss {float(loss_v):.6f}")
        if (tcfg.checkpoint_dir
                and (step + 1) % tcfg.checkpoint_every == 0):
            ckpt.save_checkpoint(tcfg.checkpoint_dir,
                                 {"params": jax.device_get(params)}, step)

    return params["vertices"], params["materials"], log
