"""K1 — primary windowed sweep (CUDA: ``csrc/primary_sweep.cu``).

Replaces ugrt's Pallas ``primary_sweep`` (ugrt/trace/pallas_tracer.py:
_primary_kernel + _primary_body, :304-387).  Every ray of a 128-ray
block is tested against the rows of its block's window range
[w_lo, w_hi] of ``pack_tri_windows``' [NW, 128, 16] table; rows whose
cell key differs from the ray's are not candidates.  Per ray the result
is the lex-min (t, face) of the accepted hits.

``primary_sweep`` launches the kernel for CUDA tensors and runs
``primary_sweep_plain`` — the same function in PyTorch ops, bitwise
equal — only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import _build
from ugrt_torch.kernels._plain import BIG, MAXI, lexmin_into, sweep_items

WIN = 128


def _check(tri_windows, rays, w_lo, w_hi):
    dev = rays.device
    nb = rays.shape[0] if rays.dim() == 3 else None
    _build.check_tensor(tri_windows, "tri_windows", torch.float32,
                        (None, WIN, 16), dev)
    _build.check_tensor(rays, "rays", torch.float32, (None, 128, 8), dev)
    _build.check_tensor(w_lo, "w_lo", torch.int32, (nb,), dev)
    _build.check_tensor(w_hi, "w_hi", torch.int32, (nb,), dev)
    if tri_windows.data_ptr() % 16:
        raise ValueError("tri_windows: the kernel reads it as float4; its "
                         "data must be 16-byte aligned")


def primary_sweep(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig):
    """Per-ray (t [NB, 128] f32, face [NB, 128] int32): lex-min (t, face)
    over the admitted rows of each block's window range; t = 3e38 and
    face = 2^31-1 where there is none.

    tri_windows: [NW, 128, 16] (pack_tri_windows); rays: [NB, 128, 8]
    (dir 0:3, cell key 3); w_lo/w_hi: [NB] int32 inclusive window ranges.
    """
    _check(tri_windows, rays, w_lo, w_hi)
    if rays.device.type == "cpu":
        return primary_sweep_plain(tri_windows, rays, w_lo, w_hi, cfg=cfg)
    if rays.device.type != "cuda":
        raise ValueError(f"primary_sweep: unsupported device {rays.device}")
    nb = rays.shape[0]
    t = torch.empty((nb, 128), dtype=torch.float32, device=rays.device)
    face = torch.empty((nb, 128), dtype=torch.int32, device=rays.device)
    _build.launch("ugrt_primary_sweep", tri_windows, tri_windows.shape[0],
                  rays, nb, w_lo, w_hi, np.float32(cfg.epsilon),
                  int(cfg.quirks.abs_t), t, face)
    primary_sweep.launches += 1
    return t, face


primary_sweep.launches = 0


def primary_sweep_plain(tri_windows, rays, w_lo, w_hi, *,
                        cfg: RenderConfig):
    """``primary_sweep`` in PyTorch ops (any device), in the op order of
    _primary_body (pallas_tracer.py:353-372)."""
    nb = rays.shape[0]
    t_best = torch.full((nb * 128,), BIG, device=rays.device)
    f_best = torch.full((nb * 128,), MAXI, dtype=torch.int32,
                        device=rays.device)
    eps = np.float32(cfg.epsilon)
    for blk, tri in sweep_items(tri_windows, w_lo, w_hi):
        ray = rays[blk]                              # [C, 128, 8]

        def rc(c):                                   # [C, 128 rays, 1]
            return ray[:, :, c, None]

        def tc(c):                                   # [C, 1, 128 tris]
            return tri[:, None, :, c]

        dx, dy, dz = rc(0), rc(1), rc(2)
        tvx, tvy, tvz = tc(0), tc(1), tc(2)
        e1x, e1y, e1z = tc(3), tc(4), tc(5)
        e2x, e2y, e2z = tc(6), tc(7), tc(8)
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = 1.0 / det
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        if cfg.quirks.abs_t:
            t = torch.abs(t)
        reject = ((torch.abs(det) < eps) | (u < 0) | (u > 1) | (v < 0)
                  | (u + v > 1) | (t <= 0) | (tc(9) != rc(3)))
        lexmin_into(t_best, f_best, blk, t, reject, tc(10))
    return t_best.reshape(nb, 128), f_best.reshape(nb, 128)
