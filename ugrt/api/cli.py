"""Command-line frame driver — the GLUT main() replacement.

The reference CLI (per_app_funcs.h:8-37, main.cu:331-394):
    ./rt_uniform scene.obj material_file [frames] [tag]
with a directory argument meaning a dynamic scene of dir/f_<i>.obj, the
camera/light presets hardcoded in main.cu:82-118/:158-164, exit after
MAXFRAMES=100 frames, and PPM+JPG dumps per frame.

Here:
    python -m ugrt.api.cli scene.obj [material_file] [--frames N]
        [--tag name] [--out results/] [--size 1024] [--grid 128]
        [--camera ex ey ez lx ly lz ux uy uz] [--light ...]
        [--reflect] [--no-shadows] [--png]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


# Reference presets (main.cu:87-90 camera, main.cu:158-164 shadow camera,
# per_frame_funcs.h:8-10 light position).
SIBENIK_CAMERA = (3.0, 15.0, 5.0, 13.0, 13.0, 3.0, 0.0, 0.0, 1.0)
SIBENIK_LIGHT_CAMERA = (14.0, 13.0, 8.0, 14.0, 13.0, 0.0, 0.0, 1.0, 0.0)
LIGHT_POSITION = (10.0, 12.0, 6.0)


def build_parser():
    p = argparse.ArgumentParser(
        description="uniform/perspective-grid ray tracer")
    p.add_argument("scene", help="OBJ file or dynamic-scene directory")
    p.add_argument("material", nargs="?", default=None,
                   help="custom material file (scene.h:370 format)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--tag", default="frame")
    p.add_argument("--out", default="results")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--camera", type=float, nargs=9, default=SIBENIK_CAMERA,
                   metavar=("EX", "EY", "EZ", "LX", "LY", "LZ",
                            "UX", "UY", "UZ"))
    p.add_argument("--light-camera", type=float, nargs=9,
                   default=SIBENIK_LIGHT_CAMERA)
    p.add_argument("--light-position", type=float, nargs=3,
                   default=LIGHT_POSITION)
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=100.0)
    p.add_argument("--reflect", action="store_true",
                   help="2-level uniform-grid reflection bounce")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--png", action="store_true", help="also write PNG")
    p.add_argument("--flip", action="store_true",
                   help="vertical flip (the reference's convert -flip)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ugrt.api.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp

    from ugrt.api import io
    from ugrt.api.profiler import StageTimer
    from ugrt.api.renderer import Renderer, render_frame_reflective
    from ugrt.config import RenderConfig
    from ugrt.core import camera as cam
    from ugrt.scene import model as smodel

    if not os.path.exists(args.scene):
        raise SystemExit(f"error: scene not found: {args.scene}")
    if args.size % args.grid != 0 or args.size // args.grid != 8:
        raise SystemExit(
            f"error: --size must be --grid * 8 (8x8 pixel tiles per grid "
            f"cell, main.cu.h:10-28); got size={args.size} "
            f"grid={args.grid}")

    cfg = dataclasses.replace(
        RenderConfig(), screen_width=args.size, screen_height=args.size,
        grid_x=args.grid, grid_y=args.grid)

    if os.path.isdir(args.scene):
        scenes = smodel.load_dynamic_scene(args.scene, args.material,
                                           args.frames)
    else:
        scenes = [smodel.load_scene(args.scene, args.material)]
    print(f"vertices: {scenes[0].num_vertices}\tfaces: "
          f"{scenes[0].num_faces}\tmaterials: {scenes[0].num_materials}")

    c = args.camera
    camera_spec = cam.CameraSpec(eye=tuple(c[0:3]), look_at=tuple(c[3:6]),
                                 up=tuple(c[6:9]), near=args.near,
                                 far=args.far)
    lc = args.light_camera
    light_spec = cam.CameraSpec(eye=tuple(lc[0:3]), look_at=tuple(lc[3:6]),
                                up=tuple(lc[6:9]), near=args.near,
                                far=args.far)
    lights = [] if args.no_shadows else [light_spec]

    os.makedirs(args.out, exist_ok=True)
    renderer = Renderer(scenes[0], cfg)
    timer = StageTimer()

    for frame in range(args.frames):
        scene = scenes[min(frame, len(scenes) - 1)]
        renderer.update_vertices(scene.vertices)

        t0 = time.perf_counter()
        if args.reflect:
            aspect = 1.0
            cc = jnp.asarray(cam.camcoords_from_spec(
                camera_spec, cfg.fovy_deg, aspect))
            lcc = jnp.asarray(cam.camcoords_from_spec(
                light_spec, cfg.fovy_deg, aspect))[None]
            out = render_frame_reflective(
                renderer.vertices, renderer.faces, renderer.mat_index,
                renderer.materials, cc, lcc,
                jnp.asarray(np.asarray(args.light_position, np.float32)),
                cfg=cfg, capacity=renderer.capacity,
                num_lights=len(lights), use_spot=frame >= 1)
        else:
            out = timer.time_stage(
                "frame", renderer.render, camera_spec, lights,
                args.light_position)
        img = np.asarray(out["image"])
        dt = time.perf_counter() - t0

        name = os.path.join(args.out, f"{args.tag}-{frame}")
        io.write_ppm(name + ".ppm", img, flip=args.flip)
        if args.png:
            io.write_png(name + ".png", img, flip=args.flip)
        print(f"frame {frame}: {dt * 1000:.1f} ms -> {name}.ppm"
              + (f" (+.png)" if args.png else ""))

    print(timer.report())


if __name__ == "__main__":
    main()
