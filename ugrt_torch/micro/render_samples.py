"""Render the sample images on the card, the visual baseline (the
counterpart of scripts/render_samples.py).

    python -m ugrt_torch.micro.render_samples --out DIR

The cathedral: ``Renderer`` at the flagship (1024x1024 over a 128x128
grid, the 73,824-face procedural cathedral, the reference light grid)
with the script's camera and light, ``frame_cnt = 5``, spot shading.
The Cornell box: ``render_frame_reflective`` at 512x512 over a 64x64
grid, ``cornell_box(subdiv=4)``, a 16^3 uniform grid of capacity 65,536,
reflectivity 0.25.  Each prints its seconds (the first call of each
records its program, so this is set-up time, not a frame time) and the
cathedral its shadowed pixels.  Writes ``cathedral.png`` and
``cornell_reflective.png`` (flipped, as the script's) into ``--out``,
where the script writes into ``results/``.  It runs on the card only:
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import sys
import time
import zlib

import numpy as np
import torch

from ugrt_torch import bridge
from ugrt_torch.api import io
from ugrt_torch.api.renderer import Renderer, render_frame_reflective
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.micro._common import card_line, main_device
from ugrt_torch.scene import procedural

# render_samples.py:26-29 and :45-48.
CAMERA = CameraSpec(eye=(3, 15, 5), look_at=(13, 13, 3), up=(0, 0, 1),
                    near=0.1, far=100.0)
LIGHT = CameraSpec(eye=(14, 13, 8), look_at=(14, 13, 0), up=(0, 1, 0),
                   near=0.1, far=100.0)
LIGHT_POSITION = (10.0, 12.0, 6.0)
CORNELL_CAMERA = CameraSpec(eye=(0.12, 0.07, 2.53),
                            look_at=(-0.04, 0.01, 0.0), up=(0.02, 1.0, 0.01),
                            near=0.1, far=100.0)
CORNELL_LIGHT = CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                           up=(0, 0, 1), near=0.1, far=100.0)
UDIMS = (16, 16, 16)
UCAP = 65536
REFLECTIVITY = 0.25


def cornell_config() -> RenderConfig:
    """The Cornell box's 512x512 frame over a 64x64 grid."""
    return dataclasses.replace(RenderConfig(), screen_width=512,
                               screen_height=512, grid_x=64, grid_y=64)


def read_png(path: str) -> np.ndarray:
    """The u8 [H, W, 3] image of a PNG as ``io.write_png`` writes it (8-bit
    RGB, one IDAT chunk, filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    chunks, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        chunks[data[pos + 4:pos + 8]] = data[pos + 8:pos + 8 + n]
        pos += n + 12
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2):
        raise ValueError(f"{path}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row is filtered")
    return rows[:, 1:].reshape(h, w, 3)


def run(cfg: RenderConfig, scene, device, out_dir: str, *,
        cornell_cfg: RenderConfig | None = None) -> dict:
    """Render and write both samples (module docstring): the cathedral
    ``scene`` at ``cfg``, the Cornell box at ``cornell_cfg`` (default:
    its 512x512 frame).  Returns the seconds, the shadowed pixels and the
    paths written."""
    device = torch.device(device)
    cornell_cfg = cornell_cfg or cornell_config()
    cornell_scene = procedural.cornell_box(subdiv=4)
    os.makedirs(out_dir, exist_ok=True)

    r = Renderer(scene, cfg, device=device)
    r.frame_cnt = 5
    t0 = time.perf_counter()
    out = r.render(CAMERA, [LIGHT], LIGHT_POSITION, use_spot=True)
    img = bridge.to_numpy(out["image"])
    cathedral_s = time.perf_counter() - t0
    shadowed = int(out["shadowed"].sum())
    print(f"cathedral: {cathedral_s:.1f}s, shadowed px: {shadowed}",
          flush=True)
    cathedral = os.path.join(out_dir, "cathedral.png")
    io.write_png(cathedral, img, flip=True)

    c = cornell_cfg
    x = bridge.scene_to_torch(cornell_scene, device)
    cc = bridge.camcoords_to_torch(CORNELL_CAMERA, c.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(CORNELL_LIGHT, c.fovy_deg, 1.0,
                                    device)[None]
    lp = bridge.from_numpy(CORNELL_LIGHT.eye, device, np.float32)
    t0 = time.perf_counter()
    out2 = render_frame_reflective(
        x["vertices"], x["faces"], x["mat_index"], x["materials"], cc, lcc,
        lp, cfg=c, capacity=c.pair_capacity(cornell_scene.num_faces),
        num_lights=1, use_spot=True, uniform_dims=UDIMS,
        uniform_capacity=UCAP, reflectivity=REFLECTIVITY)
    img2 = bridge.to_numpy(out2["image"])
    cornell_s = time.perf_counter() - t0
    print(f"cornell reflective: {cornell_s:.1f}s", flush=True)
    cornell = os.path.join(out_dir, "cornell_reflective.png")
    io.write_png(cornell, img2, flip=True)
    print(f"wrote {cathedral}, {cornell}", flush=True)
    return dict(cathedral_s=cathedral_s, shadowed_px=shadowed,
                cornell_s=cornell_s, cathedral=cathedral, cornell=cornell)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory the two PNGs are written to")
    args = ap.parse_args(argv)
    device = main_device()
    print("device:", card_line(), flush=True)
    run(RenderConfig(), procedural.cathedral(num_faces_target=75000),
        device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
