"""K1 — primary windowed sweep (CUDA: ``csrc/primary_sweep.cu``).

Replaces ugrt's Pallas ``primary_sweep`` (ugrt/trace/pallas_tracer.py:
_primary_kernel + _primary_body, :304-387).  Every ray of a 128-ray
block is tested against the rows of its block's window range
[w_lo, w_hi] of ``pack_tri_windows``' [NW, 128, 16] table; rows whose
cell key differs from the ray's are not candidates.  Per ray the result
is the lex-min (t, face) of the accepted hits.

The work is a list of items, each ray block's range cut into chunks of
at most ``chunk`` windows (``_plain.chunk_item_end``, shared with K3),
which the kernel's persistent blocks take from a device counter.  Items
merge per ray through a 64-bit key (``pack_key``) with ``atomicMin``, so
the result does not depend on ``chunk`` or on the order of the items.

``primary_sweep`` launches the kernel for CUDA tensors and runs
``primary_sweep_plain`` — the same function in PyTorch ops, bitwise
equal — only for CPU tensors (``_build.Kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.kernels import _build
from ugrt_torch.kernels._plain import (BIG, MAXI, chunk_item_end, chunk_runs,
                                       lexmin_into)

WIN = 128


def pack_key(t, face):
    """int64 keys (bits(t) << 32) | face of f32 t and int32 face.  For
    positive finite t and face >= 0 their order is the lex order of
    (t, face): positive floats order as their bit patterns."""
    bits = t.contiguous().view(torch.int32).long()
    return (bits << 32) | face.long()


def unpack_key(keys):
    """(t f32, face int32) of int64 ``keys``, as views of them (low word
    face, high word t: the card and its hosts are little-endian)."""
    words = keys.view(torch.int32).view(*keys.shape, 2)
    return words[..., 1].view(torch.float32), words[..., 0]


# The key of "no hit": t = 3e38, face = 2^31-1.
NO_HIT_KEY = int(pack_key(torch.tensor([BIG], dtype=torch.float32),
                          torch.tensor([MAXI], dtype=torch.int32)))


def _check(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
           chunk: int = 1):
    dev = rays.device
    nb = rays.shape[0] if rays.dim() == 3 else None
    _build.check_tensor(tri_windows, "tri_windows", torch.float32,
                        (None, WIN, 16), dev)
    _build.check_tensor(rays, "rays", torch.float32, (None, 128, 8), dev)
    _build.check_tensor(w_lo, "w_lo", torch.int32, (nb,), dev)
    _build.check_tensor(w_hi, "w_hi", torch.int32, (nb,), dev)
    for t, name in ((tri_windows, "tri_windows"), (rays, "rays")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it as float4; its "
                             "data must be 16-byte aligned")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    return dev


def _launch(tri_windows, rays, w_lo, w_hi, cfg, chunk, stats):
    nb, nw = rays.shape[0], tri_windows.shape[0]
    item_end = chunk_item_end(w_lo, w_hi, nw, chunk)
    # The keys and, after them, the kernel's item counter: one fill with
    # the no-hit key on the current stream, before the launch.
    keys = torch.full((nb * 128 + 1,), NO_HIT_KEY, dtype=torch.int64,
                      device=rays.device)
    _build.launch("ugrt_primary_sweep", tri_windows, nw, rays, nb, w_lo, w_hi,
                  item_end, chunk, np.float32(cfg.epsilon),
                  int(cfg.quirks.abs_t), keys, stats)
    return keys[:nb * 128].view(nb, 128)


def primary_sweep_stats(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
                        chunk: int = 1):
    """The kernel's counts on these inputs (CUDA tensors only): the (ray,
    row) tests that its warps ran and skipped at the cell-key vote.  A
    measurement aid: it launches a counting build of the kernel and is no
    launch of the main path."""
    _check(tri_windows, rays, w_lo, w_hi, cfg=cfg, chunk=chunk)
    if rays.device.type != "cuda":
        raise ValueError("primary_sweep_stats: the counts are the CUDA "
                         "kernel's")
    stats = torch.zeros((2,), dtype=torch.int64, device=rays.device)
    _launch(tri_windows, rays, w_lo, w_hi, cfg, chunk, stats)
    tested, skipped = stats.tolist()
    return dict(tested=tested, skipped=skipped)


def primary_sweep_plain(tri_windows, rays, w_lo, w_hi, *,
                        cfg: RenderConfig, chunk: int = 1):
    """``primary_sweep`` in PyTorch ops (any device), in the op order of
    _primary_body (pallas_tracer.py:353-372), over the work items that the
    kernel takes for this ``chunk``."""
    nb = rays.shape[0]
    t_best = torch.full((nb * 128,), BIG, device=rays.device)
    f_best = torch.full((nb * 128,), MAXI, dtype=torch.int32,
                        device=rays.device)
    eps = np.float32(cfg.epsilon)
    for blk, tri in chunk_runs(tri_windows, w_lo, w_hi, chunk):
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


@_build.kernel(primary_sweep_plain, _check)
def primary_sweep(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
                  chunk: int = 1):
    """Per-ray (t [NB, 128] f32, face [NB, 128] int32): lex-min (t, face)
    over the admitted rows of each block's window range; t = 3e38 and
    face = 2^31-1 where there is none.  On the card both are views of
    the kernel's int64 keys.

    tri_windows: [NW, 128, 16] (pack_tri_windows; face ids of rows that
    can be admitted are >= 0); rays: [NB, 128, 8] (dir 0:3, cell key 3);
    w_lo/w_hi: [NB] int32 inclusive window ranges.  ``chunk``: windows
    per work item.
    """
    return unpack_key(_launch(tri_windows, rays, w_lo, w_hi, cfg, chunk,
                              None))
