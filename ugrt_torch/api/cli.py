"""Command-line frame renderer (torch mirror of ugrt/api/cli.py).

    python -m ugrt_torch.api.cli scene.obj [material_file] [--frames N]
        [--tag name] [--out results/] [--size 1024] [--grid 128]
        [--camera ex ey ez lx ly lz ux uy uz] [--light-camera ...]
        [--light-position x y z] [--reflect] [--no-shadows] [--png]
        [--flip] [--device cuda]

The flags are ugrt's, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain PyTorch versions).  Frame 0 shades with Lambert, later
frames with the spotlight; PPMs (and PNGs) are written by
``ugrt_torch.api.io``, byte for byte in ugrt's format.  ``--reflect``
renders ``render_frame_reflective`` as ugrt's CLI does (aspect 1, the
light camera's matrices even under ``--no-shadows``): on the card each
frame replays its captured program (frames 0 and 1 each record one, for
Lambert and the spotlight), and the frame's line says which.  The run
records the program's spans (``api.profiler.tracing``) and ends with
their report: per span, calls, host ms and self ms per call, device ms
per call where the span has events, and the counters (among them
``program.captures``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

# Reference presets (main.cu:87-90 camera, main.cu:158-164 shadow camera,
# per_frame_funcs.h:8-10 light position) — ugrt.api.cli's defaults.
SIBENIK_CAMERA = (3.0, 15.0, 5.0, 13.0, 13.0, 3.0, 0.0, 0.0, 1.0)
SIBENIK_LIGHT_CAMERA = (14.0, 13.0, 8.0, 14.0, 13.0, 0.0, 0.0, 1.0, 0.0)
LIGHT_POSITION = (10.0, 12.0, 6.0)


def build_parser():
    p = argparse.ArgumentParser(
        description="uniform/perspective-grid ray tracer (PyTorch/CUDA)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ugrt_torch import bridge
    from ugrt_torch.api import io
    from ugrt_torch.api import profiler
    from ugrt_torch.api.renderer import Renderer, render_frame_reflective
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.scene import model as smodel

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

    def spec(c):
        return CameraSpec(eye=tuple(c[0:3]), look_at=tuple(c[3:6]),
                          up=tuple(c[6:9]), near=args.near, far=args.far)

    camera_spec = spec(args.camera)
    light_spec = spec(args.light_camera)
    lights = [] if args.no_shadows else [light_spec]

    os.makedirs(args.out, exist_ok=True)
    renderer = Renderer(scenes[0], cfg, device=args.device)
    with profiler.tracing(renderer.device) as rec:
        for frame in range(args.frames):
            scene = scenes[min(frame, len(scenes) - 1)]
            renderer.update_vertices(scene.vertices)
            t0 = time.perf_counter()
            how = ""
            if args.reflect:
                keys = render_frame_reflective.cache_size()
                cc, lcc = (bridge.camcoords_to_torch(s, cfg.fovy_deg, 1.0,
                                                     renderer.device)
                           for s in (camera_spec, light_spec))
                out = render_frame_reflective(
                    renderer.vertices, renderer.faces, renderer.mat_index,
                    renderer.materials, cc, lcc[None],
                    bridge.from_numpy(args.light_position, renderer.device,
                                      np.float32),
                    cfg=cfg, capacity=renderer.capacity,
                    num_lights=len(lights), use_spot=frame >= 1)
                if renderer.device.type != "cuda":
                    how = " (reflective program, eager on the CPU)"
                elif render_frame_reflective.cache_size() > keys:
                    how = " (reflective program: captured, then replayed)"
                else:
                    how = " (reflective program: one graph replay)"
            else:
                out = renderer.render(camera_spec, lights, args.light_position)
            img = out["image"].cpu().numpy()
            dt = time.perf_counter() - t0
            if bool(out["overflow"]):
                print(f"warning: frame {frame}: grid capacity overflow "
                      "(geometry clipped)")
            name = os.path.join(args.out, f"{args.tag}-{frame}")
            io.write_ppm(name + ".ppm", np.asarray(img), flip=args.flip)
            if args.png:
                io.write_png(name + ".png", img, flip=args.flip)
            print(f"frame {frame}: {dt * 1000:.1f} ms on {args.device}{how}"
                  f" -> {name}.ppm" + (" (+.png)" if args.png else ""))

    print(rec.report())


if __name__ == "__main__":
    main()
