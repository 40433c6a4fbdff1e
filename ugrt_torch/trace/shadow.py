"""Shadow pass (torch mirror of the kernel branch of ugrt/trace/shadow.py).

Every pixel's shadow ray runs from the light to the primary hit point
(misses included, with their garbage point eye - dir, as the reference
reorders all rays).  B1 (kernels/shadow_bin) bins the rays by
light-grid cell, sorts them stably, and lays them out as 128-ray blocks
of K3's rows; B2 (kernels/shadow_tris) packs the light grid's pairs and
heavy list into K3's triangle rows and gives each block its window
ranges; K3 (kernels/shadow_sweep) sweeps the blocks per slab over the
256-wide windows of the light grid's pair span of each block's cells
(admission by cell key), then over the 128-wide heavy windows whose
footprint union the block's cells touch (admission by footprint box).
The flags OR together and B1 scatters them back through the sort
permutation.  ``trace_shadow``'s ``backend`` is
ugrt's argument (shadow.py:250-256) with the port's values, as
``trace.primary``'s.

Rays whose direction leaves the light grid get the sentinel cell and
test no triangle (ugrt's defined divergence from the reference's
out-of-bounds read, SURVEY.md §3.5).  ugrt's XLA branch has no
counterpart.  ``build_packets`` carves the reference's cell-pure 64-ray
packets (its DecisionData reorder); it is not on the frame path, which
sweeps fixed 128-ray blocks of the sorted stream instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.vecmath import normalize, scalar
from ugrt_torch.dist import all_reduce
from ugrt_torch.grid import binning
from ugrt_torch.grid import build as gbuild
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.kernels._build import choose_sweep
from ugrt_torch.kernels.shadow_bin import (hit_points, shadow_rays,
                                          unpermute, window_angles)
from ugrt_torch.kernels.shadow_sweep import shadow_sweep
from ugrt_torch.kernels.shadow_tris import shadow_tris

# Windows per K3 work item at each site: the fastest of 1, 2, 4 and 8 on
# the flagship windowed frame (PERF.md, K3: the cell-key site walks 1.2
# windows per block on average, the box site 3.7 half-width ones for rays
# 92% shadowed, where longer items stop early more often).
SCHUNK = 1
HCHUNK = 4
# The cell-key site without a light window (reference and extent grids)
# takes K3's serial walk, whose work item should hold a block's whole
# range (5.63 windows a block on the flagship reference frame): its rays
# stop at the group that occluded their neighbour, and an item cut from
# the range would test them again.  The windowed grid's sites and every
# box site keep the block walk, which is faster there (CUDA kernel alone
# on the flagship frames, NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6):
# windowed key site 0.194-0.199 ms against the serial walk's 0.96-1.05
# at any chunk (1.2 windows a block, 1 row in 46 needed); windowed box
# site 0.240-0.241 at chunk 4 against 0.318-0.319; reference box site
# 0.095 against 0.91-0.93.
SERIAL_CHUNK = 16

# Windowed light-grid margin (fraction of the width per side) and width
# floor, as ugrt.trace.shadow defines them.
WINDOW_MARGIN = 2e-3
WINDOW_MIN_WIDTH = 1e-4


class ShadowWork(NamedTuple):
    """The reference's shadow-ray packets (ugrt/trace/shadow.py:66-70)."""

    packet_pos: torch.Tensor    # [Pcap] int32 start in sorted order (N pad)
    packet_count: torch.Tensor  # [Pcap] int32 rays in packet (<= 64, 0 pad)
    packet_cell: torch.Tensor   # [Pcap] int32 light cell (sentinel pad)
    overflow: torch.Tensor      # 0-d bool


def packet_capacity(cfg: RenderConfig, num_rays: int) -> int:
    """Packets <= light cells + N/64: every cell adds at most one partial
    packet on top of the full 64-ray ones."""
    return cfg.cell_sentinel + num_rays // cfg.max_rays_per_packet + 1


def build_packets(cells, cfg: RenderConfig):
    """Sort rays by light cell and carve cell-pure packets of at most
    ``max_rays_per_packet`` rays: the reference's DecisionData 6-step
    reorder (decision_data.h:171-271, ugrt/trace/shadow.py:90-144), a
    stable sort, head flags, the segmented rank (cummax), rank % 64 == 1
    packet starts, and compaction by sorting the marked positions.
    Not on the frame path (see the module docstring).

    cells: [N] int32 light-cell ids (cfg.cell_sentinel = out of grid).
    Returns (sorted_ray [N] int32 original ray index, ShadowWork of
    [pcap] int32 arrays, ``pcap = packet_capacity(cfg, N)``).
    """
    n = cells.shape[0]
    dev = cells.device
    sorted_cells, sorted_ray = torch.sort(cells, stable=True)

    pos = torch.arange(n, dtype=torch.int64, device=dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = sorted_cells[1:] != sorted_cells[:-1]
    seg_start = torch.cummax(torch.where(head, pos, -1), dim=0).values
    rank = pos - seg_start + 1   # 1-based in-segment rank (segmented scan)

    mrp = cfg.max_rays_per_packet
    start = (rank % mrp == 1) if mrp > 1 else torch.ones_like(head)

    pcap = packet_capacity(cfg, n)
    # Compact the start positions: sort the marked ones ascending, padded
    # with n to pcap + 1 so the last packet's next start is n.
    marked = torch.sort(torch.where(start, pos, n)).values
    padded = torch.full((max(n, pcap + 1),), n, dtype=torch.int64,
                        device=dev)
    padded[:n] = marked
    packet_pos = padded[:pcap]
    overflow = start.sum() > pcap

    # Packet extent = distance to the next start (a new segment always
    # starts a packet, so this never crosses a cell boundary).
    packet_count = torch.clamp(padded[1:pcap + 1] - packet_pos, 0, mrp)
    sentinel = cfg.cell_sentinel
    cell_at = sorted_cells[torch.clamp(packet_pos, 0, max(n - 1, 0))]
    packet_cell = torch.where((packet_pos < n) & (cell_at < sentinel),
                              cell_at, sentinel)
    packet_count = torch.where(packet_cell < sentinel, packet_count, 0)
    i32 = torch.int32
    return sorted_ray.to(i32), ShadowWork(
        packet_pos.to(i32), packet_count.to(i32), packet_cell.to(i32),
        overflow)


def light_extents(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                  margin: float = 1.001):
    """Per-frame (x_max, y_max) light-grid extents (0-d tensors): the max
    x/y angle of any hit point seen from the light (main.cu:174-185),
    NaN ignored, times ``margin``, clamped to [1e-3, pi]."""
    pts = hit_points(primary, primary_eye)
    d = normalize(pts - light_camcoords[0:3][None])
    xa = binning.x_angle(d, light_camcoords)
    ya = binning.y_angle(d, light_camcoords, cfg.quirks.y_forward_dot_typo)
    dev = pts.device
    zero, m = scalar(0.0, dev), scalar(margin, dev)
    xm = torch.where(torch.isnan(xa), zero, xa).amax() * m
    ym = torch.where(torch.isnan(ya), zero, ya).amax() * m
    lo, pi = scalar(1e-3, dev), scalar(math.pi, dev)
    return (torch.clamp(xm, lo, pi), torch.clamp(ym, lo, pi))


def apply_window_margin(x0, x1, y0, y1, margin: float = WINDOW_MARGIN):
    """Pad signed-angle bounds by ``margin`` of the width per side (width
    floored at WINDOW_MIN_WIDTH)."""
    def pad(lo, hi):
        w = torch.clamp(hi - lo, min=WINDOW_MIN_WIDTH)
        d = w * scalar(margin, w.device)
        return lo - d, hi + d

    x0, x1 = pad(x0, x1)
    y0, y1 = pad(y0, y1)
    return x0, x1, y0, y1


def light_window(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                 margin: float = WINDOW_MARGIN):
    """(x0, x1, y0, y1) 0-d tensors: the signed-angle window of the hit
    points seen from the light, NaN excluded, padded by ``margin``
    (B1's ``window_angles``, whose angles ``shadow_pass`` hands on to
    ``trace_shadow``)."""
    bounds, _ = window_angles(primary, primary_eye, light_camcoords)
    return apply_window_margin(*bounds, margin)


@profiler.spanned("trace.shadow", device=True)
def trace_shadow(vertices, faces, light_camcoords, light_grid: DeviceGrid,
                 primary, primary_eye, cfg: RenderConfig, *,
                 x_max=None, y_max=None, window=None, angles=None,
                 backend: str | None = None):
    """Per-pixel shadow flags [H, W] int32 (mod_light_rckernel semantics).

    x_max/y_max override the angular extent of the ray -> cell mapping;
    ``window`` selects the windowed parameterization.  Either must match
    what ``light_grid`` was built with, or cell keys disagree.
    ``angles``: windowed only, the rays' (sx, sy) from B1's
    ``window_angles`` on this ``primary``, which the binning then reuses.
    ``backend``: None, "kernel" or "plain" (``trace.primary``), for B1,
    B2 and both of K3's sites.
    """
    H, W = primary["t"].shape
    dev = primary["t"].device
    sweep = choose_sweep(shadow_sweep, backend, dev)
    rays_fn = choose_sweep(shadow_rays, backend, dev)
    tris_fn = choose_sweep(shadow_tris, backend, dev)
    unpermute_fn = choose_sweep(unpermute, backend, dev)
    NS = cfg.num_slabs
    sentinel = cfg.cell_sentinel

    # The rays sorted stably by light cell, and K3's rows of them (B1).
    with profiler.span("shadow.rays", device=True):
        rays = rays_fn(primary, primary_eye, light_camcoords, cfg,
                       x_max=x_max, y_max=y_max, window=window,
                       angles=angles)
    # K3's triangle rows at both sites and each block's ranges (B2).
    with profiler.span("shadow.tris", device=True):
        tris = tris_fn(vertices, faces, light_grid, light_camcoords,
                       rays.first_cell, rays.last_real, cfg)
    rows = rays.rows
    serial = window is None
    nb = rows.shape[0]
    shadow_blocks = torch.zeros((nb, 128), dtype=torch.int32, device=dev)
    for slab in range(NS):
        if slab:    # the rows carry slab 0's keys
            scell_blk = rays.scells.reshape(nb, 128)
            rows[:, :, 4] = torch.where(scell_blk < sentinel,
                                        (scell_blk * NS + slab).float(), -1.0)
        shadow_blocks |= sweep(tris.tri_w, rows, tris.w_lo[slab],
                               tris.w_hi[slab], cfg=cfg,
                               chunk=SERIAL_CHUNK if serial else SCHUNK,
                               serial=serial)

    if light_grid.heavy_faces.shape[0] > 0:
        shadow_blocks |= sweep(tris.tri_hw, rows, tris.hlo, tris.hhi,
                               cfg=cfg, box=True, chunk=HCHUNK)

    return unpermute_fn(shadow_blocks, rays.perm).reshape(H, W)


def shadow_pass(vertices, faces, primary, camcoords, light_camcoords,
                cfg: RenderConfig, *, capacity: int, num_lights: int,
                group=None):
    """Every light's shadow flags, OR-ed, as the reference's frame loop
    runs them (main.cu:160-201): per light, the light window or extents
    of ``cfg.light_grid_mode``, the spherical grid, then ``trace_shadow``.

    ``group``: the process group whose ranks' ``primary`` rays together
    make the image (``dist.mesh``, one strip per rank).  Each light's
    extents (MAX) or raw window (MIN / MAX, then the margin) are reduced
    over it, so every rank builds the whole image's light grid; each
    ray's flag is its own (ugrt mesh.py:58-60).  None: no collective.

    Returns (shadowed [H, W] int32, overflow (0-d bool: a light grid's
    pair or heavy-list capacity was exceeded), the camcoords that shade
    the frame: the last light's, else the camera's).
    """
    H, W = primary["t"].shape
    eye = camcoords[0:3]
    dev = camcoords.device
    shadowed = torch.zeros((H, W), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    shade_cc = camcoords
    mode = cfg.light_grid_mode
    # "extent" clamps geometry into edge cells and needs headroom (ugrt
    # renderer.py:70-75).
    lcap = 2 * capacity if mode == "extent" else capacity
    MIN, MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX
    for li in range(num_lights):
        lcc = light_camcoords[li]
        x_max = y_max = window = angles = None
        if mode == "extent":
            x_max, y_max = (all_reduce(a, MAX, group) for a in
                            light_extents(primary, eye, lcc, cfg))
        elif mode == "windowed":
            # The margin goes on after the reduction, so the window is
            # the one of all the image's rays.
            (x0, x1, y0, y1), angles = window_angles(primary, eye, lcc)
            window = apply_window_margin(
                all_reduce(x0, MIN, group), all_reduce(x1, MAX, group),
                all_reduce(y0, MIN, group), all_reduce(y1, MAX, group))
        lgrid = gbuild.build_spherical_grid(
            vertices, faces, lcc, cfg=cfg, capacity=lcap, x_max=x_max,
            y_max=y_max, window=window)
        sh = trace_shadow(vertices, faces, lcc, lgrid, primary, eye, cfg,
                          x_max=x_max, y_max=y_max, window=window,
                          angles=angles)
        shadowed = torch.maximum(shadowed, sh)
        overflow = overflow | lgrid.overflow
        shade_cc = lcc
    return shadowed, overflow, shade_cc
