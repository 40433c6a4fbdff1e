"""The traced run's ``torch.profiler`` session, in a child process.

    python3 benchmark/profiler_child.py --workload <name> --seed <n>
        --out <file.json>

A profiled replay of the program's step has crashed its process inside
CUPTI before, so the traced run asks a child for the trace: the child
makes the cell's set-up from the same seed, profiles a short window of
the same loop (``SECONDS``), and writes what the result line carries:
``busy_s`` (the union of the card's kernel, copy and fill intervals
inside the window), ``window_s`` (the window's length on the host's
clock) and ``breakdown``: the ten device-op groups of most time, and the
ten longest idle gaps of the card, each named by the innermost host
event that spans the gap's middle.  Where the child fails, the parent's
result leaves these out and says so on an earlier line.

The grouping (``DEVICE_CATEGORIES``, ``group_key``) is a frozen copy of
``ugrt_torch/micro/parse_trace.py:33-35, :80-83``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 0.3
TIMEOUT_S = 200
TOP = 10
WINDOW_NAME = "benchmark_window"

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy",
                     "memset")


def group_key(name: str) -> str:
    """A numeric suffix dropped, then every run of digits replaced by
    '#' (kernels differing only in template numbers share a group)."""
    return re.sub(r"\d+", "#", re.sub(r"\.\d+$", "", name))


def summarize(trace: dict) -> dict:
    """busy_s, window_s and breakdown of a Chrome trace whose window is
    the host event named ``WINDOW_NAME``."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW_NAME]
    if not win:
        raise ValueError("no window event in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = sorted((e for e in events
                  if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES
                  and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
    if not dev:
        raise ValueError("no device event inside the window")
    busy, end = 0.0, None
    gaps = []
    groups = defaultdict(float)
    for e in dev:
        s, t = e["ts"], e["ts"] + e.get("dur", 0)
        groups[group_key(e.get("name", ""))] += e.get("dur", 0)
        if end is None or s >= end:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    host = [e for e in events
            if str(e.get("cat", "")).lower() not in DEVICE_CATEGORIES
            and e.get("name") != WINDOW_NAME]
    gaps.sort(reverse=True)
    idle = []
    for g, a, b in gaps[:TOP]:
        mid = (a + b) / 2
        cover = [e for e in host
                 if e["ts"] <= mid <= e["ts"] + e.get("dur", 0)]
        name = (min(cover, key=lambda e: e.get("dur", 0))["name"]
                if cover else "(no host event)")
        idle.append([name, g * 1e-6])
    ops = sorted(groups.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                breakdown=dict(device_ops=[[k, v * 1e-6] for k, v in ops],
                               idle_gaps=idle))


def run_child(name: str, seed: int, notes: list):
    """Run this module for the cell in a child process; its summary, or
    None (with a note) when the child fails."""
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_cache")
    os.makedirs(tmp, exist_ok=True)
    out = os.path.join(tmp, f"profile_{os.getpid()}.json")
    cmd = [sys.executable, os.path.join(ROOT, "benchmark",
                                        "profiler_child.py"),
           "--workload", name, "--seed", str(seed), "--out", out]
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        if proc.returncode != 0:
            notes.append(f"profiler child failed (rc {proc.returncode}): "
                         + proc.stderr[-600:].replace("\n", " | "))
            return None
        with open(out) as f:
            return json.load(f)
    except subprocess.TimeoutExpired:
        notes.append(f"profiler child timed out after {TIMEOUT_S} s")
        return None
    finally:
        if os.path.exists(out):
            os.remove(out)


def profile_rank(driver) -> dict:
    """Set-up, then ``SECONDS`` of the cell's loop under torch.profiler;
    the trace's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import drivers
    driver.setup(SECONDS)
    drivers.sync(driver.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_NAME):
            driver.window(SECONDS)
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_cache")
    path = os.path.join(tmp, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return summarize(json.load(f))
    finally:
        os.remove(path)
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from benchmark import host
    host.steady_allocator()
    import torch

    from benchmark import drivers, launcher, registry
    cell = registry.load(ROOT).cell(args.workload)
    if cell.chips == 1:
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        summary = profile_rank(drivers.make(cell, args.seed, device))
    else:
        reports = launcher.spawn(cell.chips, ROOT, args.workload, args.seed,
                                 SECONDS, False, "cuda", "profile", 0.0)
        bad = [r for r in reports if not r["ok"]]
        if bad:
            raise RuntimeError(bad[0].get("error", "a rank failed"))
        n = len(reports)
        summary = dict(busy_s=sum(r["busy_s"] for r in reports) / n,
                       window_s=sum(r["window_s"] for r in reports) / n,
                       breakdown=reports[0]["breakdown"])
    with open(args.out, "w") as f:
        json.dump(summary, f)
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
