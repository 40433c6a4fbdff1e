"""Where the sharded step's gradient all-reduce sits in the step (the
counterpart of scripts/trace_psum_overlap.py).

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m ugrt_torch.micro.trace_psum_overlap --out DIR

Every rank joins an NCCL group, makes its mesh (``dist.mesh.make_mesh``:
rank r on ``cuda:<LOCAL_RANK>``) and builds ``sharded_train_step`` (a
captured program) on bench's flagship workload (1024x1024 over a 128x128
grid, the 73,824-face procedural cathedral, windowed light grid, spot,
a zero target).  One call records the program.  Then torch.profiler
(CPU and CUDA activities) sees one replay after one unrecorded replay:
the profiler starts at another moment on each rank, and a collective of
the first call would wait for the last rank.  Each rank writes its
Chrome trace into ``--out`` and reads its device events back
(``micro.parse_trace``).  Rank 0 prints, after an all_reduce MAX of the
ranks' step spans (first device event to last):

- the step span and the number of all-reduce kernels;
- the six longest, each with its ms and its start and end as a share of
  its rank's span;
- the compute time on its card (the union of the other device events)
  that overlaps the largest all-reduce, and its share of that
  all-reduce's duration (trace_psum_overlap.py:78-91).

On the CPU (``run`` on a gloo group, as the tests call it) the trace has
no device track: the host's operator events take its place, and the
gloo all-reduce is one of them.  ``main`` runs on the card only: without
one it exits non-zero.  The program is cleared before the group is
destroyed.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, schedule

from ugrt_torch import bench, bridge
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.dist import mesh as dmesh
from ugrt_torch.micro import parse_trace
from ugrt_torch.micro._common import card_line, main_device

TOP = 6
# trace_psum_overlap.py:34-37: the Cornell box's camera and light of the
# script's own small configuration.
CORNELL_CAMERA = CameraSpec(eye=(0.12, 0.07, 2.5), look_at=(0.0, 0.0, 0.0),
                            up=(0.02, 1.0, 0.01), near=0.1, far=100.0)
CORNELL_LIGHT = CameraSpec(eye=(0.1, 0.9, 0.5), look_at=(0.0, -1.0, 0.5),
                           up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
HOST_CATEGORIES = ("cpu_op", "user_annotation")


def is_all_reduce(name: str) -> bool:
    """An all-reduce kernel or op: NCCL's ``ncclDevKernel_AllReduce_*``,
    gloo's ``gloo:all_reduce``, c10d's ``allreduce_``."""
    return "allreduce" in name.lower().replace("_", "").replace("-", "")


def step_events(trace: dict) -> list:
    """The device events of a trace; on a trace without a device track
    (the CPU), the host's operator events."""
    events = parse_trace.device_events(trace)
    if events:
        return events
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") in HOST_CATEGORIES and "dur" in e]


def _union_overlap(events, a0: float, a1: float) -> float:
    """Length of [a0, a1] covered by the union of the events' intervals."""
    spans = sorted((max(a0, e["ts"]), min(a1, e["ts"] + e["dur"]))
                   for e in events)
    covered, end = 0.0, a0
    for s, t in spans:
        if t <= end:
            continue
        covered += t - max(s, end)
        end = t
    return covered


def report(events) -> dict:
    """Where the all-reduces of ``events`` (one rank's step) sit: the
    step span in ms, the number of all-reduce events, the TOP longest
    (name, ms, start and end as shares of the span), and the compute
    time that overlaps the largest one (ms, and its share of the
    all-reduce)."""
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    own = t1 - t0
    ars = [e for e in events if is_all_reduce(e["name"])]
    top = [dict(name=e["name"], ms=e["dur"] / 1e3,
                start=(e["ts"] - t0) / own,
                end=(e["ts"] + e["dur"] - t0) / own)
           for e in sorted(ars, key=lambda e: -e["dur"])[:TOP]]
    out = dict(span_ms=own / 1e3, rank_span_ms=own / 1e3,
               all_reduces=len(ars), top=top,
               overlap_ms=0.0, overlap_share=0.0)
    if ars:
        big = max(ars, key=lambda e: e["dur"])
        a0, a1 = big["ts"], big["ts"] + big["dur"]
        compute = [e for e in events if not is_all_reduce(e["name"])
                   and e["ts"] < a1 and e["ts"] + e["dur"] > a0]
        overlap = _union_overlap(compute, a0, a1)
        # The union's pieces add up in rounded microseconds.
        share = min(1.0, overlap / (a1 - a0)) if a1 > a0 else 0.0
        out.update(overlap_ms=overlap / 1e3, overlap_share=share)
    return out


def print_report(r: dict, world: int) -> None:
    print(f"step span: {r['span_ms']:.3f} ms (slowest of {world} ranks; "
          f"rank 0 {r['rank_span_ms']:.3f}); {r['all_reduces']} all-reduce "
          f"events", flush=True)
    for e in r["top"]:
        print(f"  {e['name'][:50]:50s} dur {e['ms']:8.4f} ms  at "
              f"{e['start']:.1%}..{e['end']:.1%} of step", flush=True)
    print(f"compute time overlapping the largest all-reduce: "
          f"{r['overlap_ms']:.4f} ms on rank 0's device "
          f"({r['overlap_share']:.0%} of its duration)", flush=True)


def run(mesh: dmesh.Mesh, cfg: RenderConfig, scene, out_dir: str, *,
        camera: CameraSpec = bench.CAMERA,
        light: CameraSpec = bench.LIGHT) -> dict:
    """Profile one replayed sharded step of ``scene`` at ``cfg`` on every
    rank of ``mesh`` (module docstring), seen from ``camera`` and lit by
    ``light`` (bench's by default); write rank r's trace into ``out_dir``
    and return its report (every rank's span is the slowest's)."""
    w = bench.Workload(cfg, scene, "procedural-cathedral", 1,
                       cfg.pair_capacity(scene.num_faces))
    x = bench.step_inputs(w, mesh.device)
    aspect = cfg.screen_width / cfg.screen_height
    x.update(camcoords=bridge.camcoords_to_torch(
        camera, cfg.fovy_deg, aspect, mesh.device),
        light_camcoords=bridge.camcoords_to_torch(
            light, cfg.fovy_deg, aspect, mesh.device)[None],
        light_position=bridge.from_numpy(light.eye, mesh.device,
                                         np.float32))
    step, program = bench.make_step(w, x, mesh)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rank{mesh.rank}.pt.trace.json")
    cuda = mesh.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    try:
        out = step(x["vertices"], x["materials"])
        loss = float(out[0])
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(2):
                step(x["vertices"], x["materials"])
                if cuda:
                    torch.cuda.synchronize(mesh.device)
                prof.step()
    finally:
        program.clear()
    events = step_events(parse_trace.load(path))
    r = report(events)
    span = torch.tensor([r["rank_span_ms"]], dtype=torch.float64,
                        device=mesh.device)
    dist.all_reduce(span, op=dist.ReduceOp.MAX, group=mesh.group)
    r.update(span_ms=float(span), loss=loss, trace=path)
    if mesh.rank == 0:
        print_report(r, mesh.world_size)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory each rank's Chrome trace is written to")
    args = ap.parse_args(argv)
    main_device()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("error: run under torch.distributed.run "
                         "(torchrun --nproc_per_node=N)")
    dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = dmesh.make_mesh()
        w = bench.workload(mesh.device)
        if mesh.rank == 0:
            print("faces:", w.scene.num_faces, "ranks:", mesh.world_size,
                  "device:", card_line(), flush=True)
        run(mesh, w.cfg, w.scene, args.out)
    finally:
        dmesh.clear()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
