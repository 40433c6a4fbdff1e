"""Capture a torch.profiler trace of the flagship fwd+bwd step on the
card (the counterpart of scripts/capture_trace.py).

    python -m ugrt_torch.micro.capture_trace --out DIR [--pi-extent]
    python -m ugrt_torch.micro.parse_trace DIR 25

Workload: ``ugrt_torch.bench``'s, nothing cut (1024x1024 over a 128x128
grid, the 73,824-face procedural cathedral, one light, spot, the MSE to
a zero target and its backward), windowed light grid, or the
reference's pi extent with ``--pi-extent`` (capture_trace.py:19-20).
The step is ``render_and_grad``'s captured program.  One warm-up call
records it and prints the loss; then three chained steps (each one's
vertices the last one's ``+ grad_vertices * 0``, :48-52) run under
torch.profiler (CPU and CUDA activities), whose Chrome trace goes into
``--out``.  A replay's kernels reach the profiler one by one, so the
trace names every kernel of the step.  ``micro.parse_trace`` aggregates
it.  It runs on the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from ugrt_torch import bench
from ugrt_torch.config import RenderConfig
from ugrt_torch.micro._common import main_device

STEPS = 3


def run(cfg: RenderConfig, scene, device, out_dir: str) -> dict:
    """Profile STEPS chained steps of bench's step on ``scene`` at
    ``cfg`` (module docstring) and write the trace into ``out_dir``.
    Returns the warm-up's loss, the last traced loss and the trace's
    path."""
    device = torch.device(device)
    w = bench.Workload(cfg, scene, "procedural-cathedral", STEPS,
                       cfg.pair_capacity(scene.num_faces))
    x = bench.step_inputs(w, device)
    step, _ = bench.make_step(w, x)
    out = step(x["vertices"], x["materials"])
    loss0 = float(out[0])
    print("warm, loss:", loss0, flush=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    v = x["vertices"]
    with profile(activities=activities) as prof:
        for _ in range(STEPS):
            out = step(v, x["materials"])
            v = bench.chain(v, out)
        loss = float(out[0])
    print("traced, loss:", loss, flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step_{cfg.light_grid_mode}.pt.trace.json")
    prof.export_chrome_trace(path)
    print("files:", [path], flush=True)
    return dict(loss=loss0, traced_loss=loss, trace=path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory the Chrome trace is written to")
    ap.add_argument("--pi-extent", action="store_true",
                    help="the reference's pi light-grid extent instead of "
                         "the windowed parameterization")
    args = ap.parse_args(argv)
    device = main_device()
    w = bench.workload(device, pi_extent=args.pi_extent)
    print("faces:", w.scene.num_faces, "device:",
          torch.cuda.get_device_name(device), flush=True)
    run(w.cfg, w.scene, device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
