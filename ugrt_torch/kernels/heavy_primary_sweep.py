"""K2 — dense primary sweep over the heavy faces
(CUDA: ``csrc/heavy_primary_sweep.cu``).

Replaces ugrt's Pallas ``heavy_primary_sweep`` (ugrt/trace/
pallas_tracer.py: _heavy_primary_kernel and
_heavy_primary_kernel_unrolled, :641-724, with _heavy_common :605-635),
two bitwise-equal variants picked by live density; one kernel covers
both here.  Every ray tests every live heavy face of the comp-major
[16, NWH * 128] table from ``pack_heavy_windows``; the op order is
ugrt.trace.heavy.heavy_min_t's.  The kernel tests the footprint, then
the bounds that need no t, then whether a ray's t could still drop, and
lets a warp skip the rest of a face where none of its rays passes (the
same values result).  The S3 probes (``heavy_variants``) share its face
body.

``heavy_primary_sweep`` launches the kernel for CUDA tensors and runs
``heavy_primary_sweep_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import _build
from ugrt_torch.kernels._plain import BIG, MAXI, lexmin_into, sweep_items

WIN = 128
# The counting builds' counts (K2 and the S3 probes), in this order.
STATS = ("skipped_footprint", "skipped_before_division",
         "skipped_could_not_win", "divided")


def _check(heavy_count, table, rays):
    dev = rays.device
    _build.check_tensor(heavy_count, "heavy_count", torch.int32, (), dev)
    _build.check_tensor(table, "table", torch.float32, (16, None), dev)
    if table.shape[1] % WIN:
        raise ValueError(f"table: width {table.shape[1]} is not a multiple "
                         f"of {WIN}")
    _build.check_tensor(rays, "rays", torch.float32, (None, 128, 8), dev)
    if rays.data_ptr() % 16:
        raise ValueError("rays: the kernel reads it as float4; its data "
                         "must be 16-byte aligned")


def new_stats(device):
    """The zeroed int64 counts a counting build adds to."""
    return torch.zeros((len(STATS),), dtype=torch.int64, device=device)


def _launch(heavy_count, table, rays, cfg, stats):
    nb = rays.shape[0]
    t = torch.empty((nb, 128), dtype=torch.float32, device=rays.device)
    face = torch.empty((nb, 128), dtype=torch.int32, device=rays.device)
    _build.launch("ugrt_heavy_primary_sweep", table, table.shape[1] // WIN,
                  heavy_count, rays, nb, np.float32(cfg.epsilon),
                  int(cfg.quirks.abs_t), t, face, stats)
    return t, face


def heavy_primary_sweep(heavy_count, table, rays, *, cfg: RenderConfig):
    """Per-ray (t [NB, 128] f32, face [NB, 128] int32): lex-min (t, face)
    over the live heavy faces whose footprint holds the ray's cell;
    t = 3e38 and face = 2^31-1 where there is none.

    heavy_count: int32 scalar tensor; table: [16, NWH * 128]
    (pack_heavy_windows); rays: [NB, 128, 8] (dir 0:3, gx 4, gy 5).
    """
    _check(heavy_count, table, rays)
    if rays.device.type == "cpu":
        return heavy_primary_sweep_plain(heavy_count, table, rays, cfg=cfg)
    if rays.device.type != "cuda":
        raise ValueError(
            f"heavy_primary_sweep: unsupported device {rays.device}")
    out = _launch(heavy_count, table, rays, cfg, None)
    heavy_primary_sweep.launches += 1
    return out


heavy_primary_sweep.launches = 0


def heavy_primary_sweep_stats(heavy_count, table, rays, *,
                              cfg: RenderConfig):
    """The kernel's counts on these inputs (CUDA tensors only), in (ray,
    face) tests (``STATS``): those whose warp skipped the face at the
    footprint, at the t-free vote and at the could-win vote, and those
    that divided.  A measurement aid: it launches a counting build of the
    kernel and is no launch of the main path."""
    _check(heavy_count, table, rays)
    if rays.device.type != "cuda":
        raise ValueError("heavy_primary_sweep_stats: the counts are the "
                         "CUDA kernel's")
    stats = new_stats(rays.device)
    _launch(heavy_count, table, rays, cfg, stats)
    return dict(zip(STATS, stats.tolist()))



def heavy_primary_sweep_plain(heavy_count, table, rays, *,
                              cfg: RenderConfig):
    """``heavy_primary_sweep`` in PyTorch ops (any device), in the op
    order of _heavy_common / heavy_min_t."""
    nb = rays.shape[0]
    nwh = table.shape[1] // WIN
    windows = table.T.reshape(nwh, WIN, 16)
    n_live = min(max((int(heavy_count) + WIN - 1) // WIN, 0), nwh)
    w_lo = torch.zeros((nb,), dtype=torch.int32, device=rays.device)
    t_best = torch.full((nb * 128,), BIG, device=rays.device)
    f_best = torch.full((nb * 128,), MAXI, dtype=torch.int32,
                        device=rays.device)
    eps = np.float32(cfg.epsilon)
    for blk, tri in sweep_items(windows, w_lo, w_lo + (n_live - 1)):
        ray = rays[blk]

        def rc(c):                                   # [C, 128 rays, 1]
            return ray[:, :, c, None]

        def tc(c):                                   # [C, 1, 128 faces]
            return tri[:, None, :, c]

        dx, dy, dz, gx, gy = rc(0), rc(1), rc(2), rc(4), rc(5)
        det = dx * tc(0) + dy * tc(1) + dz * tc(2)
        up = dx * tc(3) + dy * tc(4) + dz * tc(5)
        vp = dx * tc(6) + dy * tc(7) + dz * tc(8)
        det2 = det * det
        ud = up * det
        vd = vp * det
        t = tc(9) * (1.0 / det)
        in_fp = ((gx >= tc(10)) & (gx <= tc(11))
                 & (gy >= tc(12)) & (gy <= tc(13)))
        if cfg.quirks.abs_t:
            t = torch.abs(t)
        reject = ((torch.abs(det) < eps) | (ud < 0) | (ud > det2) | (vd < 0)
                  | (ud + vd > det2) | ~in_fp | (t <= 0))
        lexmin_into(t_best, f_best, blk, t, reject, tc(14))
    return t_best.reshape(nb, 128), f_best.reshape(nb, 128)
