"""S3 — K2's function under three loop layouts (CUDA:
``csrc/heavy_variants.cu``), the probe behind ``ugrt_torch.micro.micro_heavy``.

Replaces the Pallas probes ``_v1_kernel``, ``_v2_kernel`` and
``_v3_kernel`` of scripts/micro_heavy.py:105-183.  All three compute
``heavy_primary_sweep``'s result bitwise; they differ in how a block's
window loop is laid out:

- ``heavy_sweep_v1``: one block of ``mb`` ray blocks walks the live
  windows, staging each window once for all its rays;
- ``heavy_sweep_v2``: one block per (``mb`` ray blocks, window), windows
  merged by a 64-bit atomicMin on (t bits, face) — the split design
  proposed for K3's long cell-key ranges;
- ``heavy_sweep_v3``: the whole table staged once per block, windows
  unrolled under a live predicate (NWH in ``V3_NWH``).

``mb`` (1, 2, 4 or 8; 128 * mb threads per block) replaces the TPU's
MB in {8, 16, 32}, which a 1024-thread block cannot hold.  Each wrapper
launches its kernel for CUDA tensors and runs ``heavy_primary_sweep_plain``
only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import _build
from ugrt_torch.kernels.heavy_primary_sweep import (WIN, _check,
                                                    heavy_primary_sweep_plain)

MBS = (1, 2, 4, 8)
V3_NWH = (1, 2, 4, 8, 16)


def _sweep(wrapper, entry, heavy_count, table, rays, cfg, mb):
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
    t = torch.empty((nb, 128), dtype=torch.float32, device=rays.device)
    face = torch.empty((nb, 128), dtype=torch.int32, device=rays.device)
    scratch = ()
    if wrapper is heavy_sweep_v2:
        scratch = (torch.empty((nb, 128), dtype=torch.int64,
                               device=rays.device),)
    _build.launch(entry, table, nwh, heavy_count, rays, nb,
                  np.float32(cfg.epsilon), int(cfg.quirks.abs_t), mb,
                  *scratch, t, face)
    wrapper.launches += 1
    return t, face


def heavy_sweep_v1(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with ``mb`` ray blocks per CUDA block, one
    window loop per block; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v1, "ugrt_heavy_sweep_v1", heavy_count, table,
                  rays, cfg, mb)


def heavy_sweep_v2(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with the window as a grid axis, merged by
    atomicMin on the packed (t, face) key; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v2, "ugrt_heavy_sweep_v2", heavy_count, table,
                  rays, cfg, mb)


def heavy_sweep_v3(heavy_count, table, rays, *, cfg: RenderConfig, mb=8):
    """``heavy_primary_sweep`` with the whole table in shared memory and
    the window loop unrolled; (t, face) [NB, 128]."""
    return _sweep(heavy_sweep_v3, "ugrt_heavy_sweep_v3", heavy_count, table,
                  rays, cfg, mb)


heavy_sweep_v1.launches = 0
heavy_sweep_v2.launches = 0
heavy_sweep_v3.launches = 0
