"""Drive the sequence in which torch.profiler crashed on a replayed step
(the crash: PERF.md §7).

    python -m ugrt_torch.micro.profile_crash [--skip 6g,7,8,9,10,11]
        [--sessions 5] [--plain-sums]

This runs ``chip_smoke.py``'s own ``main`` (from the checkout's root,
seed 0) with the phases named by ``--skip`` left out (any of 3, 6g, 7,
8, 9, 10, 11 and 12; phases 1, 2, 4, 5 and 6 always run) and phase 13
replaced by what it did before the crash was found: the bench step
(``bench.make_step``, a replay of ``render_and_grad``'s program) under
torch.profiler in this process, ``--sessions`` sessions of one replay
each.  It prints ``profile_crash: done`` and exits 0 when every session
returned; a crash kills the process (exit 139 under a shell).
``--plain-sums`` makes the step's two sums run their plain versions
(``index_add_``) instead of G1.  Each run is one observation: run it in
a fresh process per try.  Card only.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
from pathlib import Path

from ugrt_torch.micro._common import main_device

# chip_smoke.py's phase functions that --skip can leave out.
PHASES = {"3": ("kernel_phase",), "6g": ("gather_phase",),
          "7": ("probe_phase",), "8": ("reflect_phase",),
          "9": ("train_phase",),
          "10": ("mesh_phase", "strip_phase", "native_phase",
                 "packet_phase"),
          "11": ("program_phase",), "12": ("bench_phase",)}
# The other names of chip_smoke.py that this module reads or replaces,
# and those of core.gather that --plain-sums replaces.
CHIP_SMOKE_NAMES = ("main", "profile_once", "profiling_phase", "G1_KERNELS",
                    "INDEX_ADD_KERNEL")
GATHER_NAMES = ("segment_sum", "face_corner_sum")


def missing_names(cs, gather):
    """The names that this module patches or calls and that chip_smoke
    module ``cs`` or core.gather module ``gather`` lacks: a phase renamed
    there would otherwise be added here as a new attribute and still
    run."""
    want = [n for names in PHASES.values() for n in names]
    return ([n for n in want + list(CHIP_SMOKE_NAMES) if not hasattr(cs, n)]
            + [f"core.gather.{n}" for n in GATHER_NAMES
               if not hasattr(gather, n)])


def _counts(*_args, **_kw):
    """A skipped phase's launch counts (every kernel once)."""
    return collections.defaultdict(lambda: 1)


def _skipped(name):
    """What chip_smoke's main takes from phase function ``name`` when it
    is left out."""
    if name in ("kernel_phase", "gather_phase"):
        return lambda *a, **k: {}
    if name == "probe_phase":
        return lambda *a, **k: []
    if name == "reflect_phase":
        return lambda *a, **k: (_counts(), {})
    return _counts


def _plain_sums(cs):
    """The step's two sums through their plain versions (launches still
    counted), and chip_smoke's checks of G1's kernels by name relaxed."""
    from ugrt_torch.core import gather
    from ugrt_torch.kernels import segment_sum as g1

    def counted(plain, wrapper):
        def run(*args):
            wrapper.launches += 1
            return plain(*args)
        return run

    gather.segment_sum = counted(g1.segment_sum_plain, g1.segment_sum)
    gather.face_corner_sum = counted(g1.face_corner_sum_plain,
                                     g1.face_corner_sum)
    cs.G1_KERNELS = {k: r"." for k in cs.G1_KERNELS}
    cs.INDEX_ADD_KERNEL = r"^$"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip", default="",
                    help="chip_smoke phases to leave out, comma-separated "
                         f"(of {', '.join(PHASES)})")
    ap.add_argument("--sessions", type=int, default=5,
                    help="torch.profiler sessions over a step replay")
    ap.add_argument("--plain-sums", action="store_true",
                    help="the step's sums through their plain versions")
    args = ap.parse_args(argv)
    main_device()
    skip = [p for p in args.skip.split(",") if p]
    unknown = sorted(set(skip) - set(PHASES))
    if unknown:
        raise SystemExit(f"error: unknown phases {unknown}")
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from ugrt_torch.core import gather

    missing = missing_names(cs, gather)
    if missing:
        raise SystemExit(f"error: chip_smoke.py lacks {missing}")
    for phase in skip:
        for name in PHASES[phase]:
            setattr(cs, name, _skipped(name))
    if args.plain_sums:
        _plain_sums(cs)

    def profiled_steps():
        import torch

        from ugrt_torch import bench

        w = bench.workload("cuda")
        x = bench.step_inputs(w, torch.device("cuda"))
        step, _ = bench.make_step(w, x)
        step(x["vertices"], x["materials"])
        for i in range(args.sessions):
            cs.profile_once(f"profile_crash: the bench step in this process, "
                            f"session {i + 1} of {args.sessions}",
                            lambda: step(x["vertices"], x["materials"]),
                            top_n=3)
        print(f"profile_crash: done (skipped {skip or 'nothing'}, plain sums "
              f"{args.plain_sums})", flush=True)
        sys.stdout.flush()
        os._exit(0)

    cs.profiling_phase = profiled_steps
    return cs.main([])


if __name__ == "__main__":
    sys.exit(main())
