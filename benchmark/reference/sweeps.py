"""Frozen copy of ``ugrt_torch/kernels/_plain.py`` (lines 1-128), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Shared machinery of the plain PyTorch sweep versions.

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

import numpy as np
import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.vecmath import sqrt

BIG = 3.0e38          # "no hit" t
MAXI = 2**31 - 1      # "no hit" face id
_PAIRS_PER_CHUNK = 1 << 21   # (ray, triangle) pairs evaluated at once


def choose_sweep(kernel, plain, backend, device):
    """The sweep that a trace calls for ``backend`` (ugrt's ``backend=``
    of trace_primary / trace_shadow): None, the wrapper ``kernel``,
    which launches the CUDA kernel on CUDA tensors and runs the plain
    version on CPU ones; "kernel", the wrapper, on CUDA tensors only;
    "plain", the plain PyTorch version ``plain``, on any device."""
    if backend is None:
        return kernel
    if backend == "kernel":
        if device.type != "cuda":
            raise ValueError(f"backend='kernel' launches the CUDA kernel: "
                             f"it needs CUDA tensors, not {device}")
        return kernel
    if backend == "plain":
        return plain
    raise ValueError(f"unknown trace backend {backend!r} (None, 'kernel' "
                     "or 'plain')")


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


# ugrt_torch/kernels/primary_sweep.py:31-31
WIN = 128

# ugrt_torch/kernels/primary_sweep.py:125-164
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

# ugrt_torch/kernels/heavy_primary_sweep.py:102-139
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

# ugrt_torch/kernels/shadow_sweep.py:34-34
_T_MAX = np.float32(999999.9)   # intersectTri accept bound

# ugrt_torch/kernels/shadow_sweep.py:143-155
def shadow_sweep_plain(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
                       box: bool = False, chunk: int = 1,
                       serial: bool = False):
    """``shadow_sweep`` in PyTorch ops (any device), in the op order of
    _shadow_body (pallas_tracer.py:446-472), over the work items that the
    kernel takes for this ``chunk``.  ``serial`` changes only the order
    of the kernel's tests, so it changes nothing here."""
    nb = rays.shape[0]
    flags = torch.zeros((nb * 128,), dtype=torch.int32, device=rays.device)
    for blk, tri in chunk_runs(tri_windows, w_lo, w_hi, chunk):
        or_into(flags, blk, occludes(rays[blk], tri, cfg=cfg,
                                     box=box).any(dim=2))
    return flags.reshape(nb, 128)

# ugrt_torch/kernels/shadow_sweep.py:158-192
def occludes(ray, tri, *, cfg: RenderConfig, box: bool = False):
    """bool [C, 128, win]: whether row q of window tri[c] occludes ray
    ray[c, i] (ray [C, 128, 8], tri [C, win, 16]), in the op order of
    _shadow_body."""
    eps = np.float32(cfg.epsilon)
    shadow_eps = np.float32(cfg.shadow_epsilon)

    def rc(c):                                       # [C, 128 rays, 1]
        return ray[:, :, c, None]

    def tc(c):                                       # [C, 1, win tris]
        return tri[:, None, :, c]

    dx, dy, dz, dist_pt = rc(0), rc(1), rc(2), rc(3)
    det = dx * tc(0) + dy * tc(1) + dz * tc(2)
    inv_det = 1.0 / det
    u = (dx * tc(3) + dy * tc(4) + dz * tc(5)) * inv_det
    v = (dx * tc(6) + dy * tc(7) + dz * tc(8)) * inv_det
    t = tc(9) * inv_det
    if box:
        gx, gy = rc(5), rc(6)
        admitted = ((gx >= tc(11)) & (gx <= tc(12))
                    & (gy >= tc(13)) & (gy <= tc(14)))
    else:
        admitted = tc(10) == rc(4)
    reject = ((torch.abs(det) < eps) | (u < 0) | (u > 1) | (v < 0)
              | (u + v > 1) | ~admitted)
    hit = ~reject & (t != 0) & (t < _T_MAX)
    if not cfg.quirks.shadow_accept_negative_t:
        hit = hit & (t > 0)
    ox = t * dx
    oy = t * dy
    oz = t * dz
    dist_occ = sqrt(ox * ox + oy * oy + oz * oz)
    return hit & (dist_occ + shadow_eps < dist_pt)

# ugrt_torch/kernels/uniform_dda.py:49-49
COMPACT_EVERY = 4

# ugrt_torch/kernels/uniform_dda.py:178-189
def _advance(cell, t_max, alive, move, step, t_delta, dims):
    """One DDA step for the rays in ``move``: the axis of the nearest
    boundary (the first on ties) moves one cell; a ray leaving the grid
    dies.  Returns the new (cell, t_max, alive)."""
    onehot = torch.nn.functional.one_hot(t_max.argmin(-1), 3).to(torch.int32)
    cell_n = cell + onehot * step
    t_max_n = t_max + onehot.to(torch.float32) * t_delta
    out = ((cell_n < 0) | (cell_n >= dims)).any(-1)
    cell_n = torch.minimum(torch.clamp(cell_n, min=0), dims - 1)
    cell = torch.where(move[:, None], cell_n, cell)
    t_max = torch.where(move[:, None], t_max_n, t_max)
    return cell, t_max, alive & ~(move & out)

# ugrt_torch/kernels/uniform_dda.py:192-297
def uniform_dda_plain(ftab, grid: DeviceGrid, origins, dirs, active,
                      exclude_face, lo, hi, grid_dims, *, cfg: RenderConfig,
                      max_batches: int, eps: float, batch: int,
                      skip_k: int, width: int | None = None, stats=None):
    """``uniform_dda`` in PyTorch ops (any device): every ray in one set,
    compacted to the live rays; batches past the first run on the rays
    whose cell needs them.  ``width`` (the kernel's ray-to-warp map) has
    no effect here; ``ftab`` may also be [F, 9]."""
    from benchmark.reference.primary import moller_trumbore_t
    gx, gy, gz = grid_dims
    dev = origins.device
    f32 = torch.float32
    dims = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    cell_size = (hi - lo) / dims.to(f32)
    n = origins.shape[0]
    num_cells = gx * gy * gz
    cap, num_faces = grid.sorted_faces.shape[0], ftab.shape[0]
    B = batch
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    max_steps = gx + gy + gz
    compact_every = 1 if dev.type == "cpu" else COMPACT_EVERY

    # Clip each ray's entry to the AABB (slab test) and find its cell.
    inv_d = 1.0 / torch.where(dirs.abs() < 1e-20, 1e-20, dirs)
    t1 = (lo[None] - origins) * inv_d
    t2 = (hi[None] - origins) * inv_d
    t_near = torch.minimum(t1, t2).amax(-1)
    t_far = torch.maximum(t1, t2).amin(-1)
    t_enter = torch.clamp(t_near, min=0.0) + eps
    inside = (t_far > t_enter) & active.bool()

    best_t = torch.full((n,), BIG, dtype=f32, device=dev)
    best_f = torch.full((n,), -2, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    ids = inside.nonzero().squeeze(1)
    o, d, inv_d = origins[ids], dirs[ids], inv_d[ids]
    excl = exclude_face[ids].to(torch.int32)
    p0 = o + t_enter[ids][:, None] * d
    cell = torch.minimum(
        torch.clamp(((p0 - lo[None]) / cell_size[None]).to(torch.int32),
                    min=0), dims - 1)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    next_bound = lo[None] + (cell + (step > 0)).to(f32) * cell_size[None]
    t_max = (next_bound - o) * inv_d
    t_delta = torch.abs(cell_size[None] * inv_d)
    alive = torch.ones(ids.shape[0], dtype=torch.bool, device=dev)
    bt = torch.full((ids.shape[0],), BIG, dtype=f32, device=dev)
    bf = torch.full((ids.shape[0],), -2, dtype=torch.int32, device=dev)

    def cell_id(c):
        return torch.clamp((c[:, 0] * gy + c[:, 1]) * gz + c[:, 2], 0,
                           num_cells - 1).long()

    def test(b, rows, cnt, off, bt, bf):
        """Batch b of the cell's faces for the rays ``rows`` (a slice or
        an index); returns their new (bt, bf)."""
        idx = torch.clamp(off[:, None] + b * B + lane[None], 0, cap - 1)
        fidx = torch.clamp(grid.sorted_faces[idx.long()], 0, num_faces - 1)
        live = (lane[None] + b * B) < cnt[:, None]
        if stats is not None:   # the benchmark's count of the tests made
            stats["needed"] = stats.get("needed", 0) + int(live.sum())
        tri = ftab[fidx.long()]                                # [m, B, 9]
        t = moller_trumbore_t(o[rows][:, None, :] - tri[..., 0:3],
                              tri[..., 3:6], tri[..., 6:9],
                              d[rows][:, None, :], cfg, abs_t=False)[:, 0]
        bad = ~live | (t <= eps) | (fidx == excl[rows][:, None])
        tmin, k = torch.where(bad, BIG, t).min(dim=-1)
        upd = alive[rows] & (tmin < bt)
        return (torch.where(upd, tmin, bt),
                torch.where(upd, fidx.gather(1, k[:, None])[:, 0], bf))

    it = 0
    while it < max_steps and ids.numel():
        # Empty-space skipping: rays in empty cells advance, up to skip_k.
        for _ in range(skip_k):
            empty = alive & (grid.cell_count[cell_id(cell)] == 0)
            cell, t_max, alive = _advance(cell, t_max, alive, empty, step,
                                          t_delta, dims)
        t_exit = t_max.amin(-1)
        cid = cell_id(cell)
        cnt = torch.where(alive, grid.cell_count[cid], 0)
        off = grid.cell_offset[cid]
        overflow |= (cnt > max_batches * B).any()
        bt, bf = test(0, slice(None), cnt, off, bt, bf)
        for b in range(1, max_batches):
            sel = (cnt > b * B).nonzero().squeeze(1)
            if not sel.numel():
                break
            bt[sel], bf[sel] = test(b, sel, cnt[sel], off[sel], bt[sel],
                                    bf[sel])
        # DDA visits cells in increasing t, so a ray is done once its best
        # hit lies before the exit of the current cell.
        alive = alive & ~(bt <= t_exit + eps)
        cell, t_max, alive = _advance(cell, t_max, alive, alive, step,
                                      t_delta, dims)
        it += 1
        if it % compact_every == 0 or it == max_steps:
            best_t[ids], best_f[ids] = bt, bf
            keep = alive.nonzero().squeeze(1)
            ids, o, d, excl, cell, t_max, step, t_delta, alive, bt, bf = (
                x[keep] for x in (ids, o, d, excl, cell, t_max, step,
                                  t_delta, alive, bt, bf))

    hit = best_t < BIG
    return dict(t=torch.where(hit, best_t, -1.0),
                face_id=torch.where(hit, best_f, -2),
                overflow=overflow,
                steps=torch.full((), it, dtype=torch.int32, device=dev))

# ugrt_torch/kernels/segment_sum.py:34-34
_FRAC_BITS = 62

# ugrt_torch/kernels/segment_sum.py:50-59
def fixed_point(values):
    """(fixed, shift, total): ``values`` in 64-bit fixed point as the
    plain version sums them (core/gather.py): total = sum |v| in f64, exp
    from frexp(total), each value round(v 2^shift) with shift = 62 - exp,
    as int64."""
    v = values.double()
    total = v.abs().sum()
    _, exp = torch.frexp(total)                 # total < 2^exp
    shift = (_FRAC_BITS - exp).double()
    return torch.round(torch.ldexp(v, shift)).long(), shift, total

# ugrt_torch/kernels/segment_sum.py:62-75
def segment_sum_plain(values, idx, rows: int):
    """Deterministic ``out[r] = sum of values[i] over idx[i] == r``.

    values: [N, ...] floating point; idx: [N] int32 or int64 in [0, rows)
    (one outside raises, as ``index_add_`` does).  Returns [rows, ...] of
    ``values.dtype``.
    """
    fixed, shift, total = fixed_point(values)
    acc = torch.zeros((rows,) + tuple(values.shape[1:]), dtype=torch.int64,
                      device=values.device)
    acc.index_add_(0, idx.long(), fixed)
    out = torch.ldexp(acc.double(), -shift)
    out = torch.where(torch.isfinite(total), out, torch.nan)
    return out.to(values.dtype)

# ugrt_torch/kernels/segment_sum.py:78-82
def face_corner_sum_plain(values, fid, faces, rows: int):
    """``face_corner_sum``'s plain version: ``segment_sum_plain`` of the
    corners, ``values.reshape(-1, 3)`` keyed by ``faces[fid]``."""
    return segment_sum_plain(values.reshape(-1, 3),
                             faces[fid].reshape(-1).long(), rows)

# The trace modules call the kernels' wrappers by these names; in the
# reference every one is its plain version.
primary_sweep = primary_sweep_plain
heavy_primary_sweep = heavy_primary_sweep_plain
shadow_sweep = shadow_sweep_plain
segment_sum = segment_sum_plain
face_corner_sum = face_corner_sum_plain
uniform_dda = uniform_dda_plain

