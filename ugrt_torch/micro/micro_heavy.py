"""S3 on the card: K2's function under three window-loop layouts
(port of scripts/micro_heavy.py).

    python -m ugrt_torch.micro.micro_heavy [v1 v2 v3] [1 2 4 8]

The workload is the script's: a [16, 1024] heavy table (691 live faces,
8 windows of 128, footprints covering the whole grid, dead columns with
det = 0 and an empty footprint) and 8193 blocks of 128 random rays,
from numpy seed 0.  Every variant of ``kernels.heavy_variants`` at each
``mb`` is held bitwise against ``heavy_primary_sweep_plain`` and then
timed; K2 itself (``heavy_primary_sweep``, the shipped kernel, one ray
block per CUDA block) is timed beside them, as the script timed "cur".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import heavy_variants as hv
from ugrt_torch.kernels.heavy_primary_sweep import (
    heavy_primary_sweep, heavy_primary_sweep_plain)
from ugrt_torch.micro._common import (compare, cuda_ms, print_records,
                                      record, require_cuda)

NB = 8193          # 1M rays / 128 + the script's guard block
H_LIVE = 691       # live heavy faces
H_CAP = 1024       # table capacity: 8 windows of 128
VARIANTS = {"v1": hv.heavy_sweep_v1, "v2": hv.heavy_sweep_v2,
            "v3": hv.heavy_sweep_v3}


def make_workload(device, nb=NB, h_live=H_LIVE, h_cap=H_CAP, seed=0):
    """The script's heavy table and rays (scripts/micro_heavy.py:39-61),
    as (heavy_count, table [16, h_cap], rays [nb, 128, 8]) on ``device``."""
    rng = np.random.default_rng(seed)
    tbl = rng.standard_normal((16, h_cap)).astype(np.float32)
    tbl[10] = 0.0
    tbl[11] = 127.0
    tbl[12] = 0.0
    tbl[13] = 127.0                                  # footprint: all cells
    tbl[14] = np.arange(h_cap, dtype=np.float32)     # face id
    dead = np.arange(h_cap) >= h_live
    tbl[0:3, dead] = 0.0                             # det = 0
    tbl[10, dead] = 1.0
    tbl[11, dead] = 0.0                              # empty footprint
    rays = rng.standard_normal((nb, 8, 128)).astype(np.float32)
    rays[:, 3] = np.abs(rays[:, 3]) * 10
    rays[:, 4] = rng.integers(0, 128, (nb, 128))
    rays[:, 5] = rng.integers(0, 128, (nb, 128))
    return (torch.tensor(h_live, dtype=torch.int32, device=device),
            torch.from_numpy(tbl).to(device),
            torch.from_numpy(np.ascontiguousarray(
                rays.swapaxes(1, 2))).to(device))


def run(variants=tuple(VARIANTS), mbs=hv.MBS, iters=20, workload=None):
    """Check, then time, each variant at each mb on the card; returns the
    records (K2 first)."""
    dev = require_cuda()
    cfg = RenderConfig()
    args = workload if workload is not None else make_workload(dev)
    want = heavy_primary_sweep_plain(*args, cfg=cfg)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: heavy_primary_sweep_plain(*args, cfg=cfg), 1)
    mism, err = compare(heavy_primary_sweep(*args, cfg=cfg), want)
    out = [record("heavy_primary_sweep", "K2", mism, err,
                  cuda_ms(lambda: heavy_primary_sweep(*args, cfg=cfg), iters),
                  plain_ms)]
    for name in variants:
        fn = VARIANTS[name]
        for mb in mbs:
            mism, err = compare(fn(*args, cfg=cfg, mb=mb), want)
            ms = cuda_ms(lambda: fn(*args, cfg=cfg, mb=mb), iters)
            out.append(record(fn.__name__, f"mb={mb}", mism, err, ms,
                              plain_ms))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    variants = [a for a in argv if a in VARIANTS] or list(VARIANTS)
    mbs = [int(a) for a in argv if a.isdigit()] or list(hv.MBS)
    records = run(variants, mbs)
    print_records("S3 heavy-sweep layouts (NB 8193, 691 live of 1024)",
                  records)
    return 1 if any(r["mismatches"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
