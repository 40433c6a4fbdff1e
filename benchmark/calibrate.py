"""The readings that the limits of ``check`` are set from, on the card,
at the cell's own size, in one process (the benchmark's runs never run
this).

    python3 benchmark/calibrate.py --workload <name> --seeds 101 102 ...
        [--seconds 2] [--control] [--faults altered half_batch]
        [--fault-seeds 3]

For each seed: the cell's set-up and a short window of its loop, then
the numbers of the sound program against the reference and, with
``--control``, of the control: the reference computed with every
floating input, gradient and update rounded to bfloat16 (``check``'s
``lowp``).  Then each fault of ``faults`` planted underneath the timed
path on the first ``--fault-seeds`` seeds.  One JSON line a reading.
A seed's traffic is made once in the process and reused by its fault
readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(cell, seed, seconds, device, *, control=False, fault=None):
    """The sound (or, with ``fault``, the faulty) reading of one seed and,
    with ``control``, the control's."""
    from benchmark import drivers
    if cell.chips > 1:
        return sharded_reading(cell, seed, seconds, control, fault)
    d = drivers.make(cell, seed, device)
    d.setup(seconds)
    w = d.window(seconds)
    out = [dict(seed=seed, kind="sound", attempted=w.attempted,
                failed=w.failed, error=w.error, numbers=d.check())]
    if control:
        import torch
        out.append(dict(seed=seed, kind="control",
                        numbers=d.check(lowp=torch.bfloat16)))
    return out


def sharded_reading(cell, seed, seconds, control, fault):
    """As ``reading``, for a cell of several cards (the launcher's ranks;
    rank 0 checks)."""
    from benchmark import launcher, registry
    reports = launcher.spawn(cell.chips, registry.ROOT, cell.name, seed,
                             seconds, False, "cuda",
                             "calibrate" if control else "run", 0.0, fault)
    bad = [r.get("error", "") for r in reports if not r["ok"]]
    r0 = reports[0]
    w = r0.get("window", {})
    out = [dict(seed=seed, kind="sound", attempted=w.get("attempted"),
                failed=w.get("failed"), error=w.get("error") or bad or None,
                numbers=r0.get("numbers", {}))]
    if control:
        out.append(dict(seed=seed, kind="control",
                        numbers=r0.get("control", {})))
    return out


def reuse_traffic():
    """Make each seed's traffic once in this process (``traffic.generate``
    memoized by seed; the drivers only read it)."""
    from benchmark import traffic
    real = traffic.generate
    made = {}

    def generate(t, config, seed, device):
        key = (json.dumps(t, sort_keys=True), config["name"], seed,
               str(device))
        if key not in made:
            made[key] = real(t, config, seed, device)
        return made[key]
    traffic.generate = generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import host
    host.steady_allocator()
    import torch

    from benchmark import faults, registry
    if not torch.cuda.is_available():
        print("error: no card", file=sys.stderr)
        return 2
    cell = registry.load(ROOT).cell(args.workload)
    if cell.chips == 1:
        reuse_traffic()
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    for seed in args.seeds:
        for r in reading(cell, seed, args.seconds, device,
                         control=args.control):
            print(json.dumps(r), flush=True)
    kind = cell.traffic["kind"] + ("_sharded" if cell.chips > 1 else "")
    for name in args.faults:
        for seed in args.seeds[:args.fault_seeds]:
            if cell.chips > 1:      # planted in each rank
                r = reading(cell, seed, args.seconds, device, fault=name)[0]
            else:
                with faults.plant(kind, name):
                    r = reading(cell, seed, args.seconds, device)[0]
            r["kind"] = "fault:" + name
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    sys.exit(main())
