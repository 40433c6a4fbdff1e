"""S1 on the card: coefficient-form Möller–Trumbore on the tensor cores
(mma.sync TF32, "highest" = 3xTF32 and "default" = 1xTF32) against the
CUDA cores (port of scripts/micro_mxu.py).

    python -m ugrt_torch.micro.micro_mxu

The workload is the script's (numpy seed 0): 4096 items of 256
triangles (components 0-2, 8-10, 16-18 random, a random k in slot 5, the
key 7 in slot 6, the rest zero) against 8 blocks of 128 rays (direction
random, key 7 in row 3), item i against ray block i % 8.  ``coeff_mt_fma``
is held bitwise to its plain version; ``coeff_mt_mma`` is held to the
8-term plain version within ``coeff_mt.mma_check``'s bound (the
script's max(|ref|, 1e-6) relative error blows up where det cancels).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ugrt_torch.kernels import coeff_mt as cm
from ugrt_torch.micro._common import (compare, cuda_ms, print_records,
                                      record, require_cuda)

NITEMS = 4096


def make_workload(device, n_items=NITEMS, seed=0):
    """The script's (items, tri [n, 24, 256], rays [8, 8, 128])
    (scripts/micro_mxu.py:89-101) on ``device``."""
    rng = np.random.default_rng(seed)
    tri = np.zeros((n_items, cm.TRI_C, cm.TRI_W), np.float32)
    tri[:, 0:3] = rng.standard_normal((n_items, 3, cm.TRI_W))
    tri[:, 8:11] = rng.standard_normal((n_items, 3, cm.TRI_W))
    tri[:, 16:19] = rng.standard_normal((n_items, 3, cm.TRI_W))
    tri[:, 5] = rng.standard_normal((n_items, cm.TRI_W))     # k slot
    tri[:, 6] = 7.0                                           # key slot
    rays = np.zeros((8, cm.RAY_C, cm.RAY_N), np.float32)
    rays[:, 0:3] = rng.standard_normal((8, 3, cm.RAY_N))
    rays[:, 3] = 7.0                                          # key row
    return (torch.arange(n_items, dtype=torch.int32, device=device),
            torch.from_numpy(tri).to(device),
            torch.from_numpy(rays).to(device))


def run(iters=10, workload=None):
    """Check, then time, fma and mma at both precisions; returns the
    records."""
    dev = require_cuda()
    args = workload if workload is not None else make_workload(dev)
    out = []
    want = cm.coeff_mt_plain(*args, terms=3)
    plain_ms = cuda_ms(lambda: cm.coeff_mt_plain(*args, terms=3), 1)
    mism, err = compare(cm.coeff_mt_fma(*args), want)
    out.append(record("coeff_mt_fma", "3-term f32", mism, err,
                      cuda_ms(lambda: cm.coeff_mt_fma(*args), iters),
                      plain_ms))
    del want
    want = cm.coeff_mt_plain(*args, terms=8)
    plain_ms = cuda_ms(lambda: cm.coeff_mt_plain(*args, terms=8), 1)
    for precision in ("highest", "default"):
        got = cm.coeff_mt_mma(*args, precision=precision)
        bad, worst, det_err = cm.mma_check(got, want, *args, precision)
        del got
        ms = cuda_ms(lambda: cm.coeff_mt_mma(*args, precision=precision),
                     iters)
        out.append(record("coeff_mt_mma", precision, bad, det_err, ms,
                          plain_ms, bound_c=cm.MMA_BOUND[precision][1],
                          max_err_over_bound=worst))
    return out


def main(argv=None):
    records = run()
    print_records("S1 coefficient-form MT (4096 items x 256 x 128)", records)
    return 1 if any(r["mismatches"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
