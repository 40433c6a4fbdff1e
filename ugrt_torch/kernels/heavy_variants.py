"""S3 — K2's function under three loop layouts (CUDA:
``csrc/heavy_variants.cu``), the probe behind ``ugrt_torch.micro.micro_heavy``.

Replaces the Pallas probes ``_v1_kernel``, ``_v2_kernel`` and
``_v3_kernel`` of scripts/micro_heavy.py:105-183.  All three run K2's
face body and compute ``heavy_primary_sweep``'s result bitwise; they
differ in how a block's window loop is laid out:

- ``heavy_sweep_v1``: one block of ``mb`` ray blocks walks the live
  windows, staging each window once for all its rays (K2's layout);
- ``heavy_sweep_v2``: one block per (``mb`` ray blocks, window), windows
  merged by a 64-bit atomicMin on (t bits, face) — the split design
  proposed for K3's long cell-key ranges; t and face are views of the
  keys (``primary_sweep.unpack_key``), which one fill sets to the no-hit
  key before the launch;
- ``heavy_sweep_v3``: the live table staged once per block, windows
  unrolled under a live predicate (NWH in ``V3_NWH``).

``mb`` (1, 2, 4 or 8; 64 * mb threads per block, two rays per thread)
replaces the TPU's MB in {8, 16, 32}, which a 1024-thread block cannot
hold.  Each wrapper launches its kernel for CUDA tensors and runs
``heavy_primary_sweep_plain`` only for CPU tensors; ``heavy_sweep_stats``
launches a counting build.
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import _build
from ugrt_torch.kernels.heavy_primary_sweep import (
    STATS, WIN, _check, heavy_primary_sweep_plain, new_stats)
from ugrt_torch.kernels.primary_sweep import NO_HIT_KEY, unpack_key

MBS = (1, 2, 4, 8)
V3_NWH = (1, 2, 4, 8, 16)


def _sweep(wrapper, heavy_count, table, rays, cfg, mb, stats=None):
    _check(heavy_count, table, rays)
    if mb not in MBS:
        raise ValueError(f"{wrapper.__name__}: mb must be one of {MBS}, "
                         f"got {mb}")
    nwh = table.shape[1] // WIN
    if wrapper is heavy_sweep_v3 and nwh not in V3_NWH:
        raise ValueError(f"heavy_sweep_v3: the table has {nwh} windows; "
                         f"the kernel is built for {V3_NWH}")
    if rays.device.type == "cpu":
        return heavy_primary_sweep_plain(heavy_count, table, rays, cfg=cfg)
    if rays.device.type != "cuda":
        raise ValueError(
            f"{wrapper.__name__}: unsupported device {rays.device}")
    nb = rays.shape[0]
    entry = f"ugrt_{wrapper.__name__}"
    args = (table, nwh, heavy_count, rays, nb, np.float32(cfg.epsilon),
            int(cfg.quirks.abs_t), mb)
    if wrapper is heavy_sweep_v2:
        keys = torch.full((nb, 128), NO_HIT_KEY, dtype=torch.int64,
                          device=rays.device)
        _build.launch(entry, *args, keys, stats)
        out = unpack_key(keys)
    else:
        out = (torch.empty((nb, 128), dtype=torch.float32,
                           device=rays.device),
               torch.empty((nb, 128), dtype=torch.int32, device=rays.device))
        _build.launch(entry, *args, *out, stats)
    if stats is None:
        wrapper.launches += 1
    return out


def heavy_sweep_v1(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with ``mb`` ray blocks per CUDA block, one
    window loop per block; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v1, heavy_count, table, rays, cfg, mb)


def heavy_sweep_v2(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with the window as a grid axis, merged by
    atomicMin on the packed (t, face) key; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v2, heavy_count, table, rays, cfg, mb)


def heavy_sweep_v3(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with the live table in shared memory and
    the window loop unrolled; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v3, heavy_count, table, rays, cfg, mb)


heavy_sweep_v1.launches = 0
heavy_sweep_v2.launches = 0
heavy_sweep_v3.launches = 0

VARIANTS = {"v1": heavy_sweep_v1, "v2": heavy_sweep_v2,
            "v3": heavy_sweep_v3}


def heavy_sweep_stats(variant, heavy_count, table, rays, *,
                      cfg: RenderConfig, mb=8):
    """A variant's counts on these inputs (CUDA tensors only), as
    ``heavy_primary_sweep_stats`` gives K2's: (ray, face) tests skipped at
    the footprint, at the t-free vote and at the could-win vote, and
    those that divided.  A counting build; it adds no launch."""
    if rays.device.type != "cuda":
        raise ValueError("heavy_sweep_stats: the counts are the CUDA "
                         "kernel's")
    stats = new_stats(rays.device)
    _sweep(VARIANTS[variant], heavy_count, table, rays, cfg, mb, stats)
    return dict(zip(STATS, stats.tolist()))
