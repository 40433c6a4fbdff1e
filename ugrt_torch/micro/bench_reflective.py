"""BASELINE config 4 on the card: the reflective two-level frame at
flagship scale (the counterpart of scripts/bench_reflective.py).

    python -m ugrt_torch.micro.bench_reflective [--refl-only]
        [--base-only] [--out reflective_1024.png]

Times ``render_frame_reflective`` (primary, shadow, the uniform-grid
reflection bounce with the DDA kernel D1, mixed shading) at 1024x1024
over the 73,824-face procedural cathedral, windowed light grid, one
light, spot shading, a 32^3 uniform grid of capacity 2^20, reflectivity
0.3 and up to 8 face batches a cell, against ``render_frame_device``
(the same frame without the bounce), each chained over 10 calls
(``micro._timing.chain_ms``: host clock, CUDA events beside), and
prints the bounce's cost.  Both are captured programs: a call is one
CUDA graph replay, and the warm-up call records it.  Then one more
reflective frame: its overflow flag (set, it makes the exit code 1)
and the share of pixels whose reflection ray hits a face; its image
goes to ``--out`` as a PNG.  ``--refl-only`` skips the base frame,
``--base-only`` stops after it.  The last line of stdout is one JSON
object of these numbers.
It runs on the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ugrt_torch import bridge
from ugrt_torch.api import io
from ugrt_torch.api.renderer import render_frame_device, render_frame_reflective
from ugrt_torch.bench import CAMERA, LIGHT
from ugrt_torch.config import RenderConfig
from ugrt_torch.micro._timing import chain_ms
from ugrt_torch.scene import procedural

UDIMS = (32, 32, 32)
UCAP = 1 << 20
ITERS = 10


def run(cfg: RenderConfig, scene, device, *, out_path: str,
        iters: int = ITERS, base: bool = True, reflective: bool = True,
        uniform_dims=UDIMS, uniform_capacity: int = UCAP) -> dict:
    """Time the base and the reflective frame of ``scene`` (module
    docstring); print each line and return the numbers."""
    x = bridge.scene_to_torch(scene, device)
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)[None]
    lp = bridge.from_numpy(LIGHT.eye, device, np.float32)
    frame = (x["faces"], x["mat_index"], x["materials"], cc, lcc, lp)
    common = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
                  num_lights=1, use_spot=True)
    result = dict(faces=scene.num_faces, base_ms=None, base_ms_events=None)
    if base:
        timing, _ = chain_ms(lambda v: render_frame_device(
            v, *frame, **common)["color"], x["vertices"], n=iters)
        result.update(base_ms=timing.host_ms, base_ms_events=timing.event_ms)
        print(f"base frame (no bounce)      {timing.host_ms:8.3f} ms "
              f"(CUDA events {timing.event_ms})", flush=True)
        if not reflective:
            return result

    def refl(v):
        return render_frame_reflective(
            v, *frame, uniform_dims=uniform_dims,
            uniform_capacity=uniform_capacity, reflectivity=0.3,
            max_batches=8, **common)

    timing, _ = chain_ms(lambda v: refl(v)["color"], x["vertices"], n=iters)
    bounce = timing.host_ms - result["base_ms"] if base else None
    result.update(reflective_ms=timing.host_ms,
                  reflective_ms_events=timing.event_ms, bounce_ms=bounce)
    print(f"reflective frame            {timing.host_ms:8.3f} ms "
          f"(CUDA events {timing.event_ms}; bounce +{bounce} ms)",
          flush=True)

    out = refl(x["vertices"])
    overflow = bool(out["overflow"])
    hit = float((out["reflection"]["face_id"] >= 0).float().mean())
    result.update(overflow=overflow, reflection_hit_fraction=hit,
                  png=out_path)
    print("overflow:", overflow, "refl hit frac:", hit, flush=True)
    io.write_png(out_path, bridge.to_numpy(out["image"]))
    print(f"wrote {out_path}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--refl-only", action="store_true",
                    help="skip the base frame's timing")
    ap.add_argument("--base-only", action="store_true",
                    help="time the base frame only")
    ap.add_argument("--out", default="reflective_1024.png",
                    help="where the reflective frame's PNG goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available")
    device = torch.device("cuda")
    cfg = dataclasses.replace(RenderConfig(), light_grid_mode="windowed")
    scene = procedural.cathedral(num_faces_target=75000)
    name = torch.cuda.get_device_name(device)
    print("faces:", scene.num_faces, "device:", name, flush=True)
    result = run(cfg, scene, device, out_path=args.out,
                 base=not args.refl_only, reflective=not args.base_only)
    print(json.dumps(dict(result, device=name)), flush=True)
    # A frame of clipped geometry fails instead of passing as a time.
    return 1 if result.get("overflow") else 0


if __name__ == "__main__":
    sys.exit(main())
