"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (``setup_s``, from the process's start to the window's): the
traffic from ``--seed``, the program's objects, and the warm-up that
captures every program key the window replays (the first run in a
checkout also builds the kernel library, in ``ugrt_torch/_build``).
Then the window: ``--seconds`` of the cell's loop (``drivers``).  Then,
with ``--trace 1``, the per-layer readers (``metrics/``) and a
``torch.profiler`` session in a child process (``profiler_child.py``).  Then
the program's state is freed and ``check`` compares what the window
produced with the reference.  The numbers compared, each with its
limit, are the last lines on standard error; the result is the last
line on standard output.

It exits non-zero, and prints no result, without CUDA or with fewer
cards than the cell asks for, and when a module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``ugrt`` is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age_s()

# Run as a script, the first path entry is this folder, whose module names
# must not shadow the standard library's: the checkout's root replaces it.
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import host  # noqa: E402

host.steady_allocator()

# Every build and kernel cache at a fixed path inside the checkout.
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".bench_cache", _dir))

FORBIDDEN = ("jax", "jaxlib", "flax", "ugrt")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden (compared whole:
    ``ugrt_torch`` is not ``ugrt``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from benchmark import registry
    bench = registry.load(ROOT)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("error: CUDA is not available; the benchmark measures the "
              "program on NVIDIA cards only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from benchmark import launcher
        result, compared = launcher.run(cell, args.workload, args.seed,
                                        args.seconds, bool(args.trace),
                                        T_START)
    else:
        from benchmark import harness
        result, compared = harness.run_cell(
            cell, args.workload, args.seed, args.seconds, bool(args.trace),
            "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print("error: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for line in compared:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
