"""S2 on the card: a 128-row window sweep cut into copy ("dma"), math
("compute") and both ("full"), at 8 and 64 items per block (port of
scripts/pallas_micro.py).

    python -m ugrt_torch.micro.pallas_micro

The workload has the script's sizes and indices: a [571520, 128] f32
triangle table, 16384 ray tiles of [8, 128], 20480 items with 8-row
aligned offsets from numpy seed 0 and ray tiles from seed 1.  The
script filled table and rays with zeros, which makes every output 0.5
or 0 and a check of the math vacuous; here they are standard normal
from seed 2 (the copy and the math do the same work on any finite
values).  "full" and "compute" are held bitwise to ``tile_sweep_plain``
and "dma" must write zeros.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ugrt_torch.kernels import tile_pipeline as tp
from ugrt_torch.micro._common import (compare, cuda_ms, print_records,
                                      record, require_cuda)

CAP8 = 571520      # table rows
NITEMS = 20480
N_TILES = 16384
WCHUNKS = (8, 64)


def make_workload(device, cap8=CAP8, n_items=NITEMS, n_tiles=N_TILES):
    """(offs, tiles, tri [cap8, 128], rays [n_tiles, 8, 128]) on
    ``device`` (scripts/pallas_micro.py:8-16, values as above)."""
    offs = (np.random.default_rng(0).integers(
        0, (cap8 - tp.ROWS) // 8, n_items) * 8).astype(np.int32)
    tiles = np.random.default_rng(1).integers(
        0, n_tiles, n_items).astype(np.int32)
    rng = np.random.default_rng(2)
    tri = rng.standard_normal((cap8, tp.COLS), dtype=np.float32)
    rays = rng.standard_normal((n_tiles, tp.RAY_C, tp.RAY_N),
                               dtype=np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (offs, tiles, tri, rays))


def run(iters=10, workload=None):
    """Check, then time, every variant at each wchunk; returns the
    records."""
    dev = require_cuda()
    args = workload if workload is not None else make_workload(dev)
    out = []
    for variant in tp.VARIANTS:
        want = tp.tile_sweep_plain(*args, variant)
        plain_ms = cuda_ms(lambda: tp.tile_sweep_plain(*args, variant), 1)
        for wchunk in WCHUNKS:
            mism, err = compare(tp.tile_sweep(*args, variant, wchunk), want)
            ms = cuda_ms(lambda: tp.tile_sweep(*args, variant, wchunk), iters)
            out.append(record("tile_sweep", f"{variant} wchunk={wchunk}",
                              mism, err, ms, plain_ms))
    return out


def main(argv=None):
    records = run()
    print_records("S2 tile sweep (20480 items of 128 x 128)", records)
    return 1 if any(r["mismatches"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
