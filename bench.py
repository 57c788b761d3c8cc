"""Flagship benchmark on one GPU: forward+backward step time and rays/s.

Workload (ugrt.api.flagship): the sibenik-scale procedural cathedral
(~75k triangles) or a real OBJ via --scene, 1024x1024 primary rays over
a 128x128 perspective grid, one light through the windowed light grid
(--pi-extent: the reference's pi-extent mapping), spot shading, plus the
full backward pass (gradients w.r.t. vertices and materials) —
``ugrt.diff.render_grad.render_and_grad``, or ``sharded_train_step``
over N devices with --mesh N.

Each step is timed on the host clock around work that ends in
``block_until_ready``; the result reports the median and 90th
percentile over --iters steps, compile time (the first call), the
device JAX reports and the card's name and power limit.  Without a GPU
the benchmark fails: it does not shrink to a size the CPU can run.

Before timing, a parity gate compares the fused kernel with the XLA
path on the benchmark's own frame (--skip-parity to skip it), and the
warm-up step's overflow flag is asserted — a benchmark of clipped
geometry fails instead of lying.

Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def parity_gate(cfg, inp):
    """Kernel vs XLA on one frame: primary face ids and t bitwise, the
    shadow mask within flagship.SHADOW_PX_BOUND pixels.  Returns the
    counts."""
    from ugrt.api import flagship

    r = flagship.trace_both(cfg, inp)
    counts = dict(
        primary_face_px=int((r["face_x"] != r["face_k"]).sum()),
        primary_t_px=int((r["t_x"] != r["t_k"]).sum()),
        shadow_px=int((r["shadow_x"] != r["shadow_k"]).sum()))
    print(f"parity: {counts}", file=sys.stderr)
    assert not r["overflow"], "XLA reference overflowed its capacities"
    assert counts["primary_face_px"] == 0 and counts["primary_t_px"] == 0, (
        f"parity gate: primary diverges on the card {counts}")
    assert counts["shadow_px"] <= flagship.SHADOW_PX_BOUND, (
        f"parity gate: shadow masks diverge on the card {counts}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=None,
                    help="OBJ file to bench instead of the procedural "
                         "cathedral")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run sharded_train_step over an N-device mesh")
    ap.add_argument("--iters", type=int, default=100,
                    help="timed steps (the 90th percentile needs >= 100 "
                         "to have ten samples beyond it)")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the kernel/XLA parity gate")
    ap.add_argument("--pi-extent", action="store_true",
                    help="use the reference's pi light-grid extent "
                         "(light_grid_mode='reference') instead of the "
                         "windowed light grid")
    ap.add_argument("--trace-backend", choices=("pallas", "xla"),
                    default=None,
                    help="trace backend to time (default: the "
                         "platform's, the fused kernel on a GPU)")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform!r}")
    from ugrt.api import flagship
    from ugrt.api.compile_cache import enable_compilation_cache
    from ugrt.diff import render_grad
    from ugrt.trace import default_trace_backend

    cache_dir = enable_compilation_cache()
    card = card_line()
    cfg = flagship.config(
        light_grid_mode="reference" if args.pi_extent else "windowed")
    scene = None
    scene_name = "procedural-cathedral"
    if args.scene:
        from ugrt.scene import model as smodel
        scene = smodel.load_scene(args.scene)
        scene_name = os.path.basename(args.scene)
    inp = flagship.inputs(cfg, scene)
    backend = args.trace_backend or default_trace_backend()

    parity = None
    if not args.skip_parity:
        parity = parity_gate(cfg, inp)

    step_args = (inp["vertices"], inp["materials"], inp["faces"],
                 inp["mat_index"], inp["cc"], inp["lcc"], inp["lp"],
                 inp["target"])
    if args.mesh:
        from ugrt.dist import mesh as dmesh
        mesh = dmesh.make_mesh(jax.devices()[:args.mesh])
        sfn = dmesh.sharded_train_step(
            mesh, cfg=cfg, capacity=inp["capacity"], num_lights=1,
            use_spot=True, trace_backend=backend)

        def step():
            return sfn(*step_args)
    else:
        def step():
            out = render_grad.render_and_grad(
                *step_args, cfg=cfg, capacity=inp["capacity"],
                num_lights=1, use_spot=True, trace_backend=backend)
            return (out["loss"], out["grad_vertices"],
                    out["grad_materials"], out["overflow"])

    t0 = time.perf_counter()
    out = jax.block_until_ready(step())
    compile_s = time.perf_counter() - t0
    assert not bool(out[3]), (
        "static capacity overflow on the bench scene — the result would "
        "benchmark clipped geometry; raise RenderConfig capacities")

    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    result = {
        "metric": "primary_rays_per_s_fwd_bwd",
        "value": cfg.image_size / med,
        "unit": "rays/s",
        "detail": {
            "step_ms_median": med * 1000,
            "step_ms_p90": float(np.percentile(times, 90)) * 1000,
            "steps": len(times),
            "compile_s": compile_s,
            "compile_cache_dir": cache_dir,
            "size": f"{cfg.screen_width}x{cfg.screen_height}",
            "faces": inp["scene"].num_faces,
            "scene": scene_name,
            "light_grid_mode": cfg.light_grid_mode,
            "trace_backend": backend,
            "mesh": args.mesh or None,
            "card": card,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }
    if parity is not None:
        result["detail"]["parity"] = parity
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
