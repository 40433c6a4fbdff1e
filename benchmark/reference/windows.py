"""Frozen copy of ``ugrt_torch/trace/windows.py`` (lines 1-193), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Triangle-window packing for the sweep kernels (torch mirror of the host
half of ugrt/trace/pallas_tracer.py).

The sorted pair array of a grid is packed once per sweep into fixed
windows of ``win`` rows x 16 f32 components — a reshape of the pair
order, not a per-ray gather — and the heavy list into a small table:

* ``pack_tri_windows``: [NW, win, 16] direct-form rows for K1
  (tvec 0:3, e1 3:6, e2 6:9, cell key 9, face id 10).
* ``pack_tri_windows_coeff``: [NW, win, 16] coefficient-form rows for
  K3 (a 0:3, b 3:6, c 6:9, k 9, cell key 10, footprint box 11:15 —
  empty (1, 0, 1, 0) for normal pairs).
* ``pack_heavy_windows``: [16, NWH * win] comp-major heavy table for K2
  (a, b, c, k, footprint 10:14, face id 14).
* ``pack_heavy_coeff_windows``: [NWH, win, 16] heavy rows in the K3
  layout (key -2 never matches; the footprint box admits rays).

Each 128-ray block's work is an inclusive window range: ``window_span``
for a pair span [lo, hi) of the sorted array, ``heavy_block_window_range``
for the spatially packed heavy windows.  K1 and K3 cut the ranges into
chunks that a persistent grid shares out (kernels/_plain.py,
chunk_item_end).  ugrt's window schedules (``make_windows`` /
``make_heavy_windows``, their SMEM packing and work capacities) have no
counterpart, so no shadow work can overflow.
"""

from __future__ import annotations

import torch

from benchmark.reference.vecmath import cross
from benchmark.reference.heavy import HeavyCoeffs

WIN = 128     # triangles per primary / heavy window
NCOMP = 16    # f32 components per triangle row


def _empty_box(like):
    """The empty footprint (x0, x1, y0, y1) = (1, 0, 1, 0), f32 on
    ``like``'s device, made by fills: no copy from host memory, which a
    captured frame (core.program) cannot record."""
    box = like.new_ones(4)
    box[1::2] = 0.0
    return box


def _face_edges(vertices, faces, origin):
    fv = vertices[faces.long()]                 # [F, 3, 3]
    v0 = fv[:, 0]
    return origin[None, :] - v0, fv[:, 1] - v0, fv[:, 2] - v0


def _pair_rows(per_face, grid, faces):
    """per_face [F, C] gathered to pair width; padding pairs zeroed."""
    fidx = torch.clamp(grid.sorted_faces, 0, faces.shape[0] - 1).long()
    return torch.where((grid.sorted_faces >= 0)[:, None], per_face[fidx],
                       0.0)


def _pad_rows(out, win: int, fill=None):
    """Pad [N, 16] rows to a multiple of ``win``; padding rows are zero
    except ``fill`` {column: value}."""
    pad = -out.shape[0] % win
    if pad:
        rows = out.new_zeros((pad, NCOMP))
        for col, val in (fill or {}).items():
            rows[:, col] = val
        out = torch.cat([out, rows])
    return out.reshape(-1, win, NCOMP)


def pack_tri_windows(vertices, faces, grid, origin, win: int = WIN):
    """[NW, win, 16] direct-form pair rows (pallas_tracer.py:98-132)."""
    tvec, e1, e2 = _face_edges(vertices, faces, origin)
    data = _pair_rows(torch.cat([tvec, e1, e2], dim=1), grid, faces)
    cap = data.shape[0]
    out = torch.cat(
        [data, grid.sorted_keys.float()[:, None],
         grid.sorted_faces.float()[:, None], data.new_zeros((cap, 5))],
        dim=1)
    return _pad_rows(out, win)


def pack_tri_windows_coeff(vertices, faces, grid, origin, win: int = WIN):
    """[NW, win, 16] coefficient-form pair rows (pallas_tracer.py:135-198).
    Padding rows keep the empty box (a zero box would contain cell 0)."""
    tvec, e1, e2 = _face_edges(vertices, faces, origin)
    c = cross(tvec, e1)
    prod = e2 * c
    k = prod[:, 0] + prod[:, 1] + prod[:, 2]
    data = _pair_rows(
        torch.cat([cross(e2, e1), cross(e2, tvec), c, k[:, None]], dim=1),
        grid, faces)
    cap = data.shape[0]
    box = _empty_box(data).expand(cap, 4)
    out = torch.cat([data, grid.sorted_keys.float()[:, None], box,
                     data.new_zeros((cap, 1))], dim=1)
    return _pad_rows(out, win, {11: 1.0, 13: 1.0})


def _live_rows(co: HeavyCoeffs):
    """Heavy coefficient columns with dead slots zeroed (det = 0) and the
    empty footprint, as [H, 10] (a, b, c, k) and [H, 4] f32."""
    live = co.live[:, None]
    abck = torch.where(live, torch.cat([co.a, co.b, co.c, co.k[:, None]],
                                       dim=1), 0.0)
    box = torch.where(live, co.ranges.float(), _empty_box(abck))
    return abck, box


def pack_heavy_windows(co: HeavyCoeffs, win: int = WIN):
    """[16, NWH * win] comp-major heavy table for K2
    (pallas_tracer.py:475-520): rows a, b, c, k, footprint, face id."""
    abck, box = _live_rows(co)
    face = torch.where(co.live, co.face, -1).float()[:, None]
    out = torch.cat([abck, box, face, abck.new_zeros((abck.shape[0], 1))],
                    dim=1)
    return _pad_rows(out, win, {10: 1.0, 12: 1.0, 14: -1.0}).reshape(
        -1, NCOMP).T.contiguous()


def pack_heavy_coeff_windows(co: HeavyCoeffs, win: int = WIN):
    """[NWH, win, 16] heavy rows in the K3 layout
    (pallas_tracer.py:201-237): key -2 never matches a ray cell; the
    footprint box admits exactly the rays of the face's cells."""
    abck, box = _live_rows(co)
    H = abck.shape[0]
    out = torch.cat([abck, abck.new_full((H, 1), -2.0), box,
                     abck.new_zeros((H, 1))], dim=1)
    return _pad_rows(out, win, {10: -2.0, 11: 1.0, 13: 1.0})


def spatial_reorder_heavy(co: HeavyCoeffs) -> HeavyCoeffs:
    """Stable permutation by footprint centre, gx-major, dead last
    (pallas_tracer.py:523-544), so each window's footprint union stays
    tight.  Shadow only: occlusion ORs, so order does not matter there."""
    cx = torch.div(co.ranges[:, 0] + co.ranges[:, 1], 2,
                   rounding_mode="floor")
    cy = torch.div(co.ranges[:, 2] + co.ranges[:, 3], 2,
                   rounding_mode="floor")
    key = torch.where(co.live, cx * 1024 + cy, 2**30)
    perm = torch.argsort(key, stable=True)
    return HeavyCoeffs(*(x[perm] for x in co))


def heavy_window_rects(co: HeavyCoeffs, win: int = WIN):
    """Per-window footprint union (x0, x1, y0, y1), each [NWH] int32
    (pallas_tracer.py:547-568); dead and padding faces add nothing."""
    big = 10**6
    r = co.ranges
    lo = torch.where(co.live[:, None], r, big)
    hi = torch.where(co.live[:, None], r, -1)
    pad = -r.shape[0] % win

    def reduce(x, fill, fn):
        x = torch.nn.functional.pad(x, (0, pad), value=fill)
        return fn(x.reshape(-1, win), dim=1).to(torch.int32)

    return (reduce(lo[:, 0], big, torch.amin), reduce(hi[:, 1], -1, torch.amax),
            reduce(lo[:, 2], big, torch.amin), reduce(hi[:, 3], -1, torch.amax))


def heavy_block_window_range(first_cell, last_cell, grid_y: int, rects):
    """Per-block inclusive heavy window range (w_lo, w_hi) [NB] int32
    (pallas_tracer.py:571-602): the windows whose footprint union the
    block's contiguous cell range can touch; empty when w_lo > w_hi
    (last_cell < 0 marks an all-sentinel block)."""
    wx0, wx1, wy0, wy1 = rects
    nw = wx0.shape[0]
    last = torch.clamp(last_cell, min=0)
    bx_lo = torch.div(first_cell, grid_y, rounding_mode="floor")
    bx_hi = torch.div(last, grid_y, rounding_mode="floor")
    one_row = bx_lo == bx_hi
    by_lo = torch.where(one_row, first_cell % grid_y, 0)
    by_hi = torch.where(one_row, last % grid_y, grid_y - 1)
    ov = ((bx_lo[:, None] <= wx1[None, :]) & (bx_hi[:, None] >= wx0[None, :])
          & (by_lo[:, None] <= wy1[None, :]) & (by_hi[:, None] >= wy0[None, :])
          & (last_cell >= 0)[:, None])
    widx = torch.arange(nw, dtype=torch.int32, device=wx0.device)[None, :]
    w_lo = torch.where(ov, widx, nw).amin(dim=1)
    w_hi = torch.where(ov, widx, -1).amax(dim=1)
    return w_lo.to(torch.int32), w_hi.to(torch.int32)


def window_span(lo, hi, win: int):
    """Inclusive window range [lo // win, (hi - 1) // win] covering the
    pair span [lo, hi) of each ray block; empty (w_hi < w_lo) when the
    span is.  Pairs of foreign cells inside boundary windows are
    rejected in the kernels by the cell-key test."""
    w_lo = torch.div(lo, win, rounding_mode="floor")
    w_hi = torch.where(hi > lo, torch.div(hi - 1, win, rounding_mode="floor"),
                       w_lo - 1)
    return w_lo.to(torch.int32), w_hi.to(torch.int32)
