"""Shadow pass (torch mirror of the kernel branch of ugrt/trace/shadow.py).

Every pixel's shadow ray runs from the light to the primary hit point
(misses included, with their garbage point eye - dir, as the reference
reorders all rays).  Rays are sorted stably by light-grid cell with the
hit point carried along, cut into 128-ray blocks, and swept by K3
(kernels/shadow_sweep): per slab over the 256-wide windows of the light
grid's pair span of each block's cells (admission by cell key), then
over the 128-wide heavy windows whose footprint union the block's cells
touch (admission by footprint box).  The flags OR together and scatter
back through the sort permutation.

Rays whose direction leaves the light grid get the sentinel cell and
test no triangle (ugrt's defined divergence from the reference's
out-of-bounds read, SURVEY.md §3.5).  ugrt's XLA branch and its
``build_packets`` (the reference's 64-ray packets) are not on this path.
"""

from __future__ import annotations

import math

import torch

from ugrt.config import RenderConfig
from ugrt_torch.core.vecmath import dot, normalize, sqrt
from ugrt_torch.grid import binning
from ugrt_torch.grid import build as gbuild
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.kernels.shadow_sweep import shadow_sweep
from ugrt_torch.trace import heavy as theavy
from ugrt_torch.trace import windows as tw

SWIN = 256    # cell-key windows: shadow spans cover several windows
HWIN = 128    # heavy footprint-box windows

# Windowed light-grid margin (fraction of the width per side) and width
# floor, as ugrt.trace.shadow defines them.
WINDOW_MARGIN = 2e-3
WINDOW_MIN_WIDTH = 1e-4


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _hit_points(primary, primary_eye):
    H, W = primary["t"].shape
    n = H * W
    return (primary_eye[None] + primary["t"].reshape(n)[:, None]
            * primary["ray_dir"].reshape(n, 3))


def light_extents(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                  margin: float = 1.001):
    """Per-frame (x_max, y_max) light-grid extents (0-d tensors): the max
    x/y angle of any hit point seen from the light (main.cu:174-185),
    NaN ignored, times ``margin``, clamped to [1e-3, pi]."""
    pts = _hit_points(primary, primary_eye)
    d = normalize(pts - light_camcoords[0:3][None])
    xa = binning.x_angle(d, light_camcoords)
    ya = binning.y_angle(d, light_camcoords, cfg.quirks.y_forward_dot_typo)
    dev = pts.device
    zero, m = _f32(0.0, dev), _f32(margin, dev)
    xm = torch.where(torch.isnan(xa), zero, xa).amax() * m
    ym = torch.where(torch.isnan(ya), zero, ya).amax() * m
    lo, pi = _f32(1e-3, dev), _f32(math.pi, dev)
    return (torch.clamp(xm, lo, pi), torch.clamp(ym, lo, pi))


def apply_window_margin(x0, x1, y0, y1, margin: float = WINDOW_MARGIN):
    """Pad signed-angle bounds by ``margin`` of the width per side (width
    floored at WINDOW_MIN_WIDTH)."""
    def pad(lo, hi):
        w = torch.clamp(hi - lo, min=WINDOW_MIN_WIDTH)
        d = w * _f32(margin, w.device)
        return lo - d, hi + d

    x0, x1 = pad(x0, x1)
    y0, y1 = pad(y0, y1)
    return x0, x1, y0, y1


def light_window(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                 margin: float = WINDOW_MARGIN):
    """(x0, x1, y0, y1) 0-d tensors: the signed-angle window of the hit
    points seen from the light, NaN excluded, padded by ``margin``."""
    pts = _hit_points(primary, primary_eye)
    d = normalize(pts - light_camcoords[0:3][None])
    sx, sy = binning.signed_xy_coords(d, light_camcoords)

    def lohi(s):
        ok = ~torch.isnan(s)
        return (torch.where(ok, s, 4.0).amin(),
                torch.where(ok, s, -4.0).amax())

    x0, x1 = lohi(sx)
    y0, y1 = lohi(sy)
    return apply_window_margin(x0, x1, y0, y1, margin)


def trace_shadow(vertices, faces, light_camcoords, light_grid: DeviceGrid,
                 primary, primary_eye, cfg: RenderConfig, *,
                 x_max=None, y_max=None, window=None):
    """Per-pixel shadow flags [H, W] int32 (mod_light_rckernel semantics).

    x_max/y_max override the angular extent of the ray -> cell mapping;
    ``window`` selects the windowed parameterization.  Either must match
    what ``light_grid`` was built with, or cell keys disagree.
    """
    H, W = primary["t"].shape
    n = H * W
    dev = primary["t"].device
    L = light_camcoords[0:3]
    NS = cfg.num_slabs
    sentinel = cfg.cell_sentinel
    if x_max is None:
        x_max = cfg.angular_extent
    if y_max is None:
        y_max = cfg.angular_extent

    pts = _hit_points(primary, primary_eye)
    if window is not None:
        cells = binning.ray_light_cells_windowed(
            pts, light_camcoords, cfg.grid_x, cfg.grid_y, window)
    else:
        cells = binning.ray_light_cells(
            pts, light_camcoords, cfg.grid_x, cfg.grid_y, x_max, y_max,
            cfg.quirks.y_forward_dot_typo)

    # Stable sort by light cell; per-ray math on the sorted points is
    # elementwise, so it commutes with the permutation bitwise.
    sorted_cells, perm = torch.sort(cells, stable=True)
    n_pad = -(-n // 128) * 128
    nb = n_pad // 128
    delta = pts[perm] - L[None]
    scells = torch.full((n_pad,), sentinel, dtype=torch.int32, device=dev)
    scells[:n] = sorted_cells
    scell_blk = scells.reshape(nb, 128)

    # Ray rows [NB, 128, 8]: dir 0:3, light-to-point distance 3, cell key
    # 4 (set per slab; -1 for sentinel rays), light cell (gx, gy) 5:7 for
    # the footprint test — sentinel rays get gx = grid_x, outside every
    # footprint.
    rows = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    rows[:n, 0:3] = normalize(delta)
    rows[:n, 3] = sqrt(dot(delta, delta))
    rows[:, 5] = torch.div(scells, cfg.grid_y, rounding_mode="floor").float()
    rows[:, 6] = (scells % cfg.grid_y).float()
    rows = rows.reshape(nb, 128, 8)

    first_cell = scell_blk[:, 0]          # sorted: the block's min cell
    last_real = torch.where(scell_blk < sentinel, scell_blk, -1).amax(dim=1)
    live = last_real >= 0
    k1 = torch.clamp(first_cell, 0, sentinel - 1).long() * NS
    k2 = torch.clamp(last_real, 0, sentinel - 1).long() * NS

    tri_w = tw.pack_tri_windows_coeff(vertices, faces, light_grid, L,
                                      win=SWIN)
    shadow_blocks = torch.zeros((nb, 128), dtype=torch.int32, device=dev)
    for slab in range(NS):
        rows[:, :, 4] = torch.where(scell_blk < sentinel,
                                    (scell_blk * NS + slab).float(), -1.0)
        lo = torch.where(live, light_grid.cell_offset[k1 + slab], 0)
        hi = torch.where(live, light_grid.cell_offset[k2 + slab]
                         + light_grid.cell_count[k2 + slab], 0)
        w_lo, w_hi = tw.window_span(lo, hi, SWIN)
        shadow_blocks |= shadow_sweep(tri_w, rows, w_lo, w_hi, cfg=cfg)

    if light_grid.heavy_faces.shape[0] > 0:
        co = theavy.heavy_coeffs(vertices, faces, light_grid.heavy_faces,
                                 light_grid.heavy_count, L,
                                 light_grid.heavy_ranges)
        co = tw.spatial_reorder_heavy(co)
        tri_hw = tw.pack_heavy_coeff_windows(co, win=HWIN)
        hlo, hhi = tw.heavy_block_window_range(
            first_cell, last_real, cfg.grid_y, tw.heavy_window_rects(co, HWIN))
        shadow_blocks |= shadow_sweep(tri_hw, rows, hlo, hhi, cfg=cfg,
                                      box=True)

    # Unpermute: a scatter by the sort permutation (unique indices, so
    # deterministic).
    shadowed = torch.empty((n,), dtype=torch.int32, device=dev)
    shadowed[perm] = shadow_blocks.reshape(n_pad)[:n]
    return shadowed.reshape(H, W)


def shadow_pass(vertices, faces, primary, camcoords, light_camcoords,
                cfg: RenderConfig, *, capacity: int, num_lights: int):
    """Every light's shadow flags, OR-ed, as the reference's frame loop
    runs them (main.cu:160-201): per light, the light window or extents
    of ``cfg.light_grid_mode``, the spherical grid, then ``trace_shadow``.

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
    for li in range(num_lights):
        lcc = light_camcoords[li]
        x_max = y_max = window = None
        if mode == "extent":
            x_max, y_max = light_extents(primary, eye, lcc, cfg)
        elif mode == "windowed":
            window = light_window(primary, eye, lcc, cfg)
        lgrid = gbuild.build_spherical_grid(
            vertices, faces, lcc, cfg=cfg, capacity=lcap, x_max=x_max,
            y_max=y_max, window=window)
        sh = trace_shadow(vertices, faces, lcc, lgrid, primary, eye, cfg,
                          x_max=x_max, y_max=y_max, window=window)
        shadowed = torch.maximum(shadowed, sh)
        overflow = overflow | lgrid.overflow
        shade_cc = lcc
    return shadowed, overflow, shade_cc
