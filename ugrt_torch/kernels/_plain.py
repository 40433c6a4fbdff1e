"""Shared machinery of the plain PyTorch sweep versions.

A sweep's work is the set of (ray block, window) items given by each
block's inclusive window range.  The plain versions expand those items,
evaluate them in chunks as [C, 128 rays, win triangles] tensors, and
combine per ray with order-independent reductions — lex-min (t, face)
for the primary sweeps, OR for the shadow sweep — so they equal the
kernels whatever order those take the items in.  K1 and K3 cut each
block's range into work items of at most ``chunk`` windows
(``chunk_item_end``), which their persistent CUDA blocks share out and
decode as ``chunk_windows`` does (csrc/sweep.cuh, decode_item); K2 walks
each block's range inside one CUDA block.
"""

from __future__ import annotations

import torch

BIG = 3.0e38          # "no hit" t
MAXI = 2**31 - 1      # "no hit" face id
_PAIRS_PER_CHUNK = 1 << 21   # (ray, triangle) pairs evaluated at once


def sweep_items(tri_windows, w_lo, w_hi):
    """Yield (blk [C] int64, tri [C, win, 16]) chunks of the items
    {(b, w) : max(w_lo[b], 0) <= w <= min(w_hi[b], NW - 1)}."""
    nw = tri_windows.shape[0]
    lo = torch.clamp(w_lo.long(), min=0)
    n = torch.clamp(torch.clamp(w_hi.long(), max=nw - 1) - lo + 1, min=0)
    yield from window_runs(tri_windows, torch.arange(n.shape[0],
                                                     device=n.device), lo, n)


def chunk_item_end(w_lo, w_hi, nw: int, chunk: int):
    """int32 [NB]: the inclusive prefix sum of each ray block's number of
    work items, ceil(n / chunk) for its n = |[max(w_lo, 0), min(w_hi,
    NW - 1)]| windows (none for an empty range).  Item i belongs to the
    first block b with item_end[b] > i; its windows start at
    max(w_lo[b], 0) + (i - item_end[b - 1]) * chunk.  The last entry is
    the number of items.  Device ops only: no host sync."""
    span = torch.clamp(w_hi, max=nw - 1) - torch.clamp(w_lo, min=0)
    n_items = torch.div(torch.clamp(span + chunk, min=0), chunk,
                        rounding_mode="floor")
    return torch.cumsum(n_items, 0, dtype=torch.int32)


def chunk_windows(item_end, w_lo, w_hi, nw: int, chunk: int):
    """(blk, w0, w1) int64 [items]: each work item's ray block and
    inclusive window range, decoded as the kernel decodes it."""
    end = item_end.long()
    item = torch.arange(int(end[-1]) if end.numel() else 0,
                        device=end.device)
    blk = torch.searchsorted(end, item, right=True)
    first = torch.where(blk > 0, end[blk - 1], 0)
    w0 = torch.clamp(w_lo.long()[blk], min=0) + (item - first) * chunk
    w1 = torch.minimum(torch.clamp(w_hi.long()[blk], max=nw - 1),
                       w0 + chunk - 1)
    return blk, w0, w1


def chunk_runs(tri_windows, w_lo, w_hi, chunk: int):
    """Yield (blk [C] int64, tri [C, win, 16]) chunks of the (ray block,
    window) pairs of the work items that the kernels take for ``chunk``:
    the same pairs as ``sweep_items``, reached through the item decode."""
    nw = tri_windows.shape[0]
    blk, w0, w1 = chunk_windows(chunk_item_end(w_lo, w_hi, nw, chunk), w_lo,
                                w_hi, nw, chunk)
    yield from window_runs(tri_windows, blk, w0, w1 - w0 + 1)


def window_runs(tri_windows, blk, w0, n):
    """Yield (blk [C] int64, tri [C, win, 16]) chunks of the (ray block,
    window) items of runs: run i is ray block blk[i] against the n[i]
    windows from w0[i] on."""
    pair_blk = torch.repeat_interleave(blk, n)
    start = torch.cumsum(n, 0) - n
    widx = (torch.repeat_interleave(w0 - start, n)
            + torch.arange(pair_blk.shape[0], device=blk.device))
    chunk = max(1, _PAIRS_PER_CHUNK // (128 * tri_windows.shape[1]))
    for s in range(0, pair_blk.shape[0], chunk):
        yield pair_blk[s:s + chunk], tri_windows[widx[s:s + chunk]]


def _ray_index(blk):
    lane = torch.arange(128, device=blk.device)
    return (blk[:, None] * 128 + lane[None, :]).reshape(-1)


def lexmin_into(t_best, f_best, blk, t, reject, face):
    """Fold the candidates t [C, 128, win] (face [C, 1, win] f32 ids) of
    items ``blk`` into the per-ray lex-min (t, face) arrays, in place."""
    keep = ~reject & (t < BIG)
    t = torch.where(keep, t, BIG)
    tmin = t.amin(dim=2)
    fmin = torch.where(keep & (t == tmin[..., None]), face.to(torch.int32),
                       MAXI).amin(dim=2)
    idx = _ray_index(blk)
    new_t = t_best.scatter_reduce(0, idx, tmin.reshape(-1), "amin")
    cand = torch.where(tmin.reshape(-1) == new_t[idx], fmin.reshape(-1),
                       MAXI)
    kept = torch.where(t_best == new_t, f_best, MAXI)
    f_best.copy_(kept.scatter_reduce(0, idx, cand, "amin"))
    t_best.copy_(new_t)


def or_into(flags, blk, hit):
    """OR the per-item flags hit [C, 128] into flags [NB * 128], in place."""
    flags.scatter_reduce_(0, _ray_index(blk), hit.reshape(-1).to(flags.dtype),
                          "amax")
