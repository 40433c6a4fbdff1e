"""B2 — the triangle side of the shadow pass (CUDA: ``csrc/shadow_tris.cu``).

Everything of ``trace.shadow`` between B1's ray rows and K3's two
launches, for one light:

- the cell-key site's rows: ``trace.windows.pack_tri_windows_coeff`` of
  the light grid's pair array in ``SWIN``-row windows, and each 128-ray
  block's inclusive window range per slab (``window_span`` of the
  block's pair span, from ``cell_offset`` / ``cell_count`` at its first
  and last real cell);
- the heavy site's rows: the heavy list's coefficients
  (``trace.heavy.heavy_coeffs``) in their stable footprint-centre order
  (``spatial_reorder_heavy``), packed in ``HWIN``-row windows
  (``pack_heavy_coeff_windows``), and each block's inclusive window
  range against the windows' footprint unions (``heavy_window_rects``,
  ``heavy_block_window_range``).

The key column of the rows holds no slab, so one call gives every
slab's ranges.  A light grid without a heavy list (capacity 0: multi-slab
configs) gets no heavy rows and empty heavy ranges.  ugrt runs this side
as XLA ops around its Pallas sweep (ugrt/trace/shadow.py); no Pallas
kernel is replaced.

``shadow_tris`` launches the kernels for CUDA tensors and runs its plain
version ``shadow_tris_plain`` (the torch chain it replaces, any device)
only for CPU tensors (``_build.Kernel``); its results are bitwise the
plain version's.  ``trace.windows`` and ``trace.heavy`` keep those
functions for the primary trace, whose window layout and heavy table
differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.kernels import _build
from ugrt_torch.trace import heavy as theavy
from ugrt_torch.trace import windows as tw

SWIN = 256    # cell-key windows: shadow spans cover several windows
HWIN = 128    # heavy footprint-box windows
# The most heavy windows: the range launch keeps every window's footprint
# union (16 B) in a block's 48 KB of shared memory.
_MAX_HEAVY_WINDOWS = 3072


class ShadowTris(NamedTuple):
    """K3's triangle rows and each ray block's window ranges."""

    tri_w: torch.Tensor    # [NW, SWIN, 16] f32 cell-key site rows
    w_lo: torch.Tensor     # [NS, NB] int32: slab s's inclusive range ...
    w_hi: torch.Tensor     # ... of tri_w's windows (empty: w_hi < w_lo)
    tri_hw: torch.Tensor   # [NWH, HWIN, 16] f32 heavy rows (NWH 0: none)
    hlo: torch.Tensor      # [NB] int32 inclusive range of tri_hw's windows
    hhi: torch.Tensor


def _check(vertices, faces, light_grid: DeviceGrid, light_camcoords,
           first_cell, last_real, cfg: RenderConfig):
    dev = vertices.device
    nb = first_cell.shape[0] if first_cell.dim() == 1 else None
    i32 = torch.int32
    _build.check_tensor(vertices, "vertices", torch.float32, (None, 3), dev)
    _build.check_tensor(faces, "faces", i32, (None, 3), dev)
    _build.check_tensor(light_camcoords, "light_camcoords", torch.float32,
                        (None,), dev)
    _build.check_tensor(first_cell, "first_cell", i32, (nb,), dev)
    _build.check_tensor(last_real, "last_real", i32, (nb,), dev)
    g = light_grid
    _build.check_tensor(g.sorted_faces, "sorted_faces", i32, (None,), dev)
    cap = g.sorted_faces.shape[0]
    _build.check_tensor(g.sorted_keys, "sorted_keys", i32, (cap,), dev)
    ncells = cfg.cell_sentinel * cfg.num_slabs
    _build.check_tensor(g.cell_offset, "cell_offset", i32, (ncells,), dev)
    _build.check_tensor(g.cell_count, "cell_count", i32, (ncells,), dev)
    _build.check_tensor(g.heavy_faces, "heavy_faces", i32, (None,), dev)
    h = g.heavy_faces.shape[0]
    _build.check_tensor(g.heavy_count, "heavy_count", i32, (), dev)
    _build.check_tensor(g.heavy_ranges, "heavy_ranges", i32, (h, 4), dev)
    if g.heavy_ranges.data_ptr() % 16:
        raise ValueError("heavy_ranges: the kernel reads it as int4; its "
                         "data must be 16-byte aligned")
    if -(-h // HWIN) > _MAX_HEAVY_WINDOWS:
        raise ValueError(f"heavy_faces: at most {_MAX_HEAVY_WINDOWS * HWIN} "
                         f"slots, got {h}")
    if light_camcoords.shape[0] < 3:
        raise ValueError("light_camcoords: needs the position at [0:3]")
    if faces.shape[0] == 0:
        raise ValueError("faces: the scene has none")
    return dev


def shadow_tris_plain(vertices, faces, light_grid: DeviceGrid,
                      light_camcoords, first_cell, last_real,
                      cfg: RenderConfig) -> ShadowTris:
    """``shadow_tris`` in torch ops."""
    L = light_camcoords[0:3]
    NS, sentinel = cfg.num_slabs, cfg.cell_sentinel
    g = light_grid
    live = last_real >= 0
    k1 = torch.clamp(first_cell, 0, sentinel - 1).long() * NS
    k2 = torch.clamp(last_real, 0, sentinel - 1).long() * NS
    tri_w = tw.pack_tri_windows_coeff(vertices, faces, g, L, win=SWIN)
    spans = []
    for slab in range(NS):
        lo = torch.where(live, g.cell_offset[k1 + slab], 0)
        hi = torch.where(live, g.cell_offset[k2 + slab]
                         + g.cell_count[k2 + slab], 0)
        spans.append(tw.window_span(lo, hi, SWIN))
    w_lo, w_hi = (torch.stack(s) for s in zip(*spans))
    if g.heavy_faces.shape[0] > 0:
        co = tw.spatial_reorder_heavy(theavy.heavy_coeffs(
            vertices, faces, g.heavy_faces, g.heavy_count, L,
            g.heavy_ranges))
        tri_hw = tw.pack_heavy_coeff_windows(co, win=HWIN)
        hlo, hhi = tw.heavy_block_window_range(
            first_cell, last_real, cfg.grid_y, tw.heavy_window_rects(co, HWIN))
    else:
        tri_hw = vertices.new_zeros((0, HWIN, 16))
        hlo = torch.zeros_like(first_cell)
        hhi = torch.full_like(first_cell, -1)
    return ShadowTris(tri_w, w_lo, w_hi, tri_hw, hlo, hhi)


@_build.kernel(shadow_tris_plain, _check)
def shadow_tris(vertices, faces, light_grid: DeviceGrid, light_camcoords,
                first_cell, last_real, cfg: RenderConfig) -> ShadowTris:
    """K3's triangle rows of ``light_grid`` for the light at
    ``light_camcoords[0:3]`` and the window ranges of the ray blocks
    whose least and last real cells are ``first_cell`` / ``last_real``
    (B1's ``ShadowRays``; -1: a block of sentinel rays), as
    ``ShadowTris``."""
    g = light_grid
    dev = vertices.device
    cap = g.sorted_faces.shape[0]
    nw = -(-cap // SWIN)
    nb = first_cell.shape[0]
    h = g.heavy_faces.shape[0]
    nwh = -(-h // HWIN)
    i32 = torch.int32
    tri_w = torch.empty((nw, SWIN, 16), dtype=torch.float32, device=dev)
    spans = torch.empty((2, cfg.num_slabs, nb), dtype=i32, device=dev)
    tri_hw = torch.empty((nwh, HWIN, 16), dtype=torch.float32, device=dev)
    sorted_ranges = torch.empty((h, 4), dtype=i32, device=dev)
    heavy = torch.empty((2, nb), dtype=i32, device=dev)
    _build.launch("ugrt_shadow_tris", vertices, faces, faces.shape[0],
                  light_camcoords, g.sorted_faces, g.sorted_keys, cap, nw,
                  g.cell_offset, g.cell_count, first_cell, last_real, nb,
                  cfg.num_slabs, cfg.grid_y, cfg.cell_sentinel,
                  g.heavy_faces, g.heavy_count, g.heavy_ranges, h, nwh,
                  tri_w, spans, tri_hw, sorted_ranges, heavy)
    return ShadowTris(tri_w, spans[0], spans[1], tri_hw, heavy[0], heavy[1])
