"""Smoke test of the render-and-gradient path on a GPU, in one process.

    python chip_smoke.py          # phases 1-5 on one card
    python chip_smoke.py --four   # phase 6 only, on four cards

Phases (each one raises on failure; nothing is caught):

1. Device: refuse to run unless JAX's first device is a GPU; print the
   card's name and power limit.
2. Kernel parity at flagship width (1024², ~75k faces, windowed light
   grid): the fused kernel against the XLA path on the card — primary
   face ids and t bitwise, the shadow mask within
   flagship.SHADOW_PX_BOUND pixels.
3. Frames: three frames through ``Renderer`` / ``render_frame_device``
   as the CLI drives them (frame 0 Lambert, later frames spotlight) at
   the CLI's flagship configuration; no overflow, a non-constant image.
4. Oracle: a 256²/8k-face frame rendered on the card against the CPU
   oracle (ugrt/ref/oracle.py), u8 image bitwise except knife-edge
   pixels (at most ORACLE_PX_SHARE of them).
5. Gradients: three ``render_and_grad`` steps at flagship width through
   the kernel, finite loss and gradients that agree with the XLA path
   (GRAD_RTOL), then ``ugrt.api.train`` for TRAIN_STEPS steps.
6. (--four) ``sharded_train_step`` over four cards at flagship width
   against the one-card ``render_and_grad``.

Step and compile times go to earlier lines; the last line is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Share of knife-edge pixels the card may differ from the CPU oracle by
# (README "Parity"): a ray within an ulp of a triangle edge can pick the
# neighbouring face when the card contracts float32 products into FMAs.
ORACLE_PX_SHARE = 1e-3
# Gradient agreement, kernel path vs XLA path, relative to the largest
# gradient component: both paths pick the same faces (phase 2), so the
# gradients differ only by float32 summation order over a million pixels
# (XLA's GPU scatter-adds use atomics) and by the few shadow pixels the
# kernel may flip (flagship.SHADOW_PX_BOUND), each of which moves only the
# gradients of the one face it shows.
GRAD_RTOL = 1e-3
TRAIN_STEPS = 2


def log(msg):
    print(msg, flush=True)


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def close_grads(name, a, b, rtol=GRAD_RTOL):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    log(f"  {name}: max |diff| {err:.3e}, max |grad| {scale:.3e}")
    assert np.isfinite(a).all() and np.isfinite(b).all(), name
    assert err <= rtol * scale, f"{name} differ: {err} > {rtol} * {scale}"


def grad_step(inp, cfg, backend):
    from ugrt.diff import render_grad

    return render_grad.render_and_grad(
        inp["vertices"], inp["materials"], inp["faces"], inp["mat_index"],
        inp["cc"], inp["lcc"], inp["lp"], inp["target"], cfg=cfg,
        capacity=inp["capacity"], num_lights=1, use_spot=True,
        trace_backend=backend)


def phase_parity(cfg, inp):
    from ugrt.api import flagship

    log("phase 2: kernel parity at flagship width")
    r, dt = timed(flagship.trace_both, cfg, inp)
    face = int((r["face_x"] != r["face_k"]).sum())
    tpx = int((r["t_x"] != r["t_k"]).sum())
    shadow = int((r["shadow_x"] != r["shadow_k"]).sum())
    log(f"  {dt:.1f} s incl. compile; primary face mismatches {face}, "
        f"t mismatches {tpx}, shadow mismatches {shadow} "
        f"(bound {flagship.SHADOW_PX_BOUND}); shadowed px "
        f"{int(r['shadow_x'].sum())}, hit px {int((r['face_x'] >= 0).sum())}")
    assert not r["overflow"]
    assert face == 0 and tpx == 0, "primary kernel is not bitwise"
    assert shadow <= flagship.SHADOW_PX_BOUND


def phase_frames(scene):
    import numpy as np

    from ugrt.api import flagship
    from ugrt.api.renderer import Renderer

    cfg = flagship.config(light_grid_mode="reference")
    log("phase 3: three CLI frames at flagship width")
    renderer = Renderer(scene, cfg)
    for frame in range(3):
        out, dt = timed(renderer.render, flagship.CAMERA, [flagship.LIGHT],
                        flagship.LIGHT.eye)
        img = np.asarray(out["image"])
        log(f"  frame {frame}: {dt * 1000:.1f} ms, overflow "
            f"{bool(out['overflow'])}, image range "
            f"[{img.min()}, {img.max()}]")
        assert not bool(out["overflow"])
        assert img.min() != img.max(), "constant image"


def phase_oracle():
    import numpy as np

    from ugrt.api import flagship
    from ugrt.api.renderer import render_frame_device
    from ugrt.ref import oracle

    log("phase 4: 256^2 / 8k faces against the CPU oracle")
    cfg = flagship.config(size=256, light_grid_mode="reference")
    inp = flagship.inputs(cfg, num_faces=8000)
    out, dt = timed(render_frame_device, inp["vertices"], inp["faces"],
                    inp["mat_index"], inp["materials"], inp["cc"],
                    inp["lcc"], inp["lp"], cfg=cfg,
                    capacity=inp["capacity"], num_lights=1, use_spot=True)
    ref = oracle.render_frame(inp["scene"], flagship.CAMERA,
                              [flagship.LIGHT], np.asarray(inp["lp"]), cfg,
                              use_spot=True)
    img = np.asarray(out["image"])
    diff = (img != ref["image"]).any(axis=-1)
    share = float(diff.mean())
    log(f"  {dt:.1f} s incl. compile; {int(diff.sum())} px differ "
        f"({share:.5%}, bound {ORACLE_PX_SHARE:.3%}); overflow "
        f"{bool(out['overflow'])}")
    assert not bool(out["overflow"])
    assert share <= ORACLE_PX_SHARE


def phase_grads(cfg, inp):
    import numpy as np

    from ugrt.api import flagship
    from ugrt.api.train import TrainConfig, train

    log("phase 5: render_and_grad at flagship width")
    for i in range(3):
        out, dt = timed(grad_step, inp, cfg, "pallas")
        log(f"  kernel step {i}: {dt * 1000:.1f} ms, loss "
            f"{float(out['loss']):.6f}")
        assert not bool(out["overflow"])
        assert np.isfinite(float(out["loss"]))
    ref, dt = timed(grad_step, inp, cfg, "xla")
    log(f"  XLA step: {dt * 1000:.1f} ms incl. compile, loss "
        f"{float(ref['loss']):.6f}")
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    close_grads("grad_vertices", out["grad_vertices"],
                ref["grad_vertices"])
    close_grads("grad_materials", out["grad_materials"],
                ref["grad_materials"])

    t0 = time.perf_counter()
    _, _, losses = train(inp["scene"], [flagship.CAMERA], flagship.LIGHT,
                         flagship.LIGHT.eye, [inp["target"]], cfg,
                         TrainConfig(steps=TRAIN_STEPS), verbose=False)
    log(f"  train: {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s "
        f"incl. compile, losses {losses}")
    assert np.isfinite(losses).all()


def phase_four(cfg, inp):
    import jax
    import numpy as np

    from ugrt.dist import mesh as dmesh

    log("phase 6: sharded_train_step over four cards")
    assert len(jax.devices()) >= 4, "--four needs four cards"
    step = dmesh.sharded_train_step(
        dmesh.make_mesh(jax.devices()[:4]), cfg=cfg,
        capacity=inp["capacity"], num_lights=1, use_spot=True)
    args = (inp["vertices"], inp["materials"], inp["faces"],
            inp["mat_index"], inp["cc"], inp["lcc"], inp["lp"],
            inp["target"])
    times = []
    for i in range(4):
        (loss, gv, gm, ovf), dt = timed(step, *args)
        times.append(dt)
        log(f"  sharded step {i}: {dt * 1000:.1f} ms")
        assert not bool(ovf)
    ref, dt = timed(grad_step, inp, cfg, None)
    ref, dt = timed(grad_step, inp, cfg, None)
    log(f"  one-card step: {dt * 1000:.1f} ms; four-card median "
        f"{np.median(times[1:]) * 1000:.1f} ms over {len(times) - 1}")
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    close_grads("grad_vertices", gv, ref["grad_vertices"])
    close_grads("grad_materials", gm, ref["grad_materials"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    import bench
    from ugrt.api import flagship
    from ugrt.api.compile_cache import enable_compilation_cache

    log(bench.card_line())
    log(f"phase 1: JAX device {dev.device_kind} x {len(jax.devices())}; "
        f"compile cache {enable_compilation_cache()}")
    cfg = flagship.config()
    inp = flagship.inputs(cfg)
    t_start = time.perf_counter()
    if args.four:
        phase_four(cfg, inp)
    else:
        phase_parity(cfg, inp)
        phase_frames(inp["scene"])
        phase_oracle()
        phase_grads(cfg, inp)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
