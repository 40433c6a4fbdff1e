"""Per-face / per-ray grid binning math (torch mirror of
ugrt/grid/binning.py:30-329).

Everything stays float32 in ugrt's operation order.  The hazards:

* C truncation vs floor, both with NaN -> 0 (grid_kernel.cu casts);
  float -> int32 conversion saturates as XLA's does (+inf -> int32 max),
  where a bare ``.to(torch.int32)`` on the CPU would wrap to int32 min.
* the y-angle forward dot carries the reference's ``*`` typo
  (grid_kernel.cu:439, misc_kernel.cu:191) when the quirk is on.
* arccos is evaluated in float64 and rounded once (vecmath.acos); ugrt's
  XLA acos and the numpy oracle's arccos are float32 approximations that
  differ from it, and from each other, by up to 2 ulp, which can move a
  value across a cell boundary (the tests state the measured counts).
"""

from __future__ import annotations

import torch

from ugrt_torch.core.vecmath import (acos, dot, magnitude, normalize,
                                     scalar, transform_point)

_I32_MIN = -2147483648.0
_I32_LIM = 2147483648.0


def _sat_int32(x):
    """f32 -> int32 with XLA's saturating semantics (NaN handled by the
    callers): values at or past the int32 range clamp to its ends."""
    x = torch.clamp(x, _I32_MIN, _I32_LIM)
    return torch.clamp(x.to(torch.int64), max=2**31 - 1).to(torch.int32)


def _trunc_int(x):
    """C float->int cast: truncation toward zero; NaN -> 0."""
    x = torch.where(torch.isnan(x), scalar(0.0, x.device), x)
    return _sat_int32(torch.trunc(x))


def _floor_int(x):
    """floorf then int conversion, NaN -> 0."""
    x = torch.where(torch.isnan(x), scalar(0.0, x.device), x)
    return _sat_int32(torch.floor(x))


def mv_basis(camcoords):
    """Right/up/forward rows of the modelview rotation (grid_kernel.cu:370-383)."""
    mv = camcoords[16:32]
    return mv[0::4][:3], mv[1::4][:3], mv[2::4][:3]


def _typo_dot(tmp, forward):
    return (tmp[..., 0] * forward[0]
            + tmp[..., 1] * forward[1] * tmp[..., 2] * forward[2])


def block_x(vec, camcoords, grid_x: int, max_angle):
    """getEffective_x (grid_kernel.cu:395-421): NX/2 ± trunc((angle/max)*NX/2)."""
    right, up, forward = mv_basis(camcoords)
    up_dot = dot(vec, up[None])
    tmp = vec - up_dot[..., None] * up[None]
    tmp = tmp / magnitude(tmp)[..., None]
    angle = acos(dot(tmp, forward[None]))
    right_dot = dot(tmp, right[None])
    half = grid_x // 2
    dev = vec.device
    step = _trunc_int((angle / scalar(max_angle, dev)) * scalar(half, dev))
    return torch.where(right_dot > 0, half + step, half - step).to(torch.int32)


def block_y(vec, camcoords, grid_y: int, max_angle, y_typo: bool):
    """getEffective_y (grid_kernel.cu:452-479): truncation AFTER adding NY/2."""
    right, up, forward = mv_basis(camcoords)
    right_dot = dot(vec, right[None])
    tmp = vec - right_dot[..., None] * right[None]
    tmp = tmp / magnitude(tmp)[..., None]
    up_dot = dot(tmp, up[None])
    fwd_dot = _typo_dot(tmp, forward) if y_typo else dot(tmp, forward[None])
    angle = acos(fwd_dot)
    half = scalar(grid_y // 2, vec.device)
    step = (angle / scalar(max_angle, vec.device)) * half
    return _trunc_int(torch.where(up_dot > 0, half + step, half - step))


def x_angle(vec, camcoords):
    """get_x_angle (misc_kernel.cu:131-147)."""
    right, up, forward = mv_basis(camcoords)
    up_dot = dot(vec, up[None])
    tmp = vec - up_dot[..., None] * up[None]
    tmp = tmp / magnitude(tmp)[..., None]
    return acos(dot(tmp, forward[None]))


def y_angle(vec, camcoords, y_typo: bool):
    """get_y_angle (misc_kernel.cu:177-194) — has the typo."""
    right, up, forward = mv_basis(camcoords)
    right_dot = dot(vec, right[None])
    tmp = vec - right_dot[..., None] * right[None]
    tmp = tmp / magnitude(tmp)[..., None]
    fwd = _typo_dot(tmp, forward) if y_typo else dot(tmp, forward[None])
    return acos(fwd)


def _ranges(gxmin, gxmax, gymin, gymax, zmin, grid_x, grid_y):
    """Clamped per-face cell AABB and its cell count."""
    gxmin = torch.clamp(gxmin, 0, grid_x - 1)
    gymin = torch.clamp(gymin, 0, grid_y - 1)
    gxmax = torch.clamp(gxmax, 0, grid_x - 1)
    gymax = torch.clamp(gymax, 0, grid_y - 1)
    counts = ((gxmax - gxmin + 1) * (gymax - gymin + 1)).to(torch.int32)
    return dict(gxmin=gxmin, gxmax=gxmax, gymin=gymin, gymax=gymax,
                zmin=zmin, counts=counts)


def _vertex_ranges(bx, by, zmin, grid_x, grid_y):
    """Per-face AABB over the three vertices' cell coordinates."""
    return _ranges(bx.amin(dim=1), bx.amax(dim=1), by.amin(dim=1),
                   by.amax(dim=1), zmin, grid_x, grid_y)


def perspective_face_ranges(vertices, faces, camcoords, grid_x, grid_y):
    """DSKernel binning (grid_kernel.cu:164-243): clip-space AABB per
    face, the NDC min/max taken before the floor (NaN propagates to 0)."""
    v = vertices[faces.long()]                      # [F, 3, 3]
    view = transform_point(camcoords[16:32], v)
    ndc = transform_point(camcoords[32:48], view)
    half = scalar(0.5, v.device)

    def cell(c, n):
        return _floor_int((c + 1.0) * half * n)

    x, y = ndc[..., 0], ndc[..., 1]
    return _ranges(cell(x.amin(dim=1), grid_x), cell(x.amax(dim=1), grid_x),
                   cell(y.amin(dim=1), grid_y), cell(y.amax(dim=1), grid_y),
                   ndc[..., 2].amin(dim=1), grid_x, grid_y)


def spherical_face_ranges(vertices, faces, camcoords, grid_x, grid_y,
                          x_max, y_max, y_typo: bool):
    """DS_spherical_Kernel binning (grid_kernel.cu:481-659)."""
    eye = camcoords[0:3]
    d = vertices[faces.long()] - eye[None, None, :]
    radius = magnitude(d)
    dn = d / radius[..., None]
    blx = block_x(dn, camcoords, grid_x, x_max)
    bly = block_y(dn, camcoords, grid_y, y_max, y_typo)
    return _vertex_ranges(blx, bly, radius.amin(dim=1), grid_x, grid_y)


def signed_xy_coords(vec, camcoords):
    """Signed per-axis angles for the WINDOWED light-grid mode (correct
    forward dot; degenerate directions give NaN)."""
    right, up, forward = mv_basis(camcoords)

    up_dot = dot(vec, up[None])
    tx = vec - up_dot[..., None] * up[None]
    tx = tx / magnitude(tx)[..., None]
    xa = acos(torch.clamp(dot(tx, forward[None]), -1.0, 1.0))
    sx = torch.where(dot(tx, right[None]) > 0, xa, -xa)

    right_dot = dot(vec, right[None])
    ty = vec - right_dot[..., None] * right[None]
    ty = ty / magnitude(ty)[..., None]
    ya = acos(torch.clamp(dot(ty, forward[None]), -1.0, 1.0))
    sy = torch.where(dot(ty, up[None]) > 0, ya, -ya)
    return sx, sy


def _window_cells(sx, sy, window, grid_x, grid_y):
    x0, x1, y0, y1 = window
    bx = _floor_int((sx - x0) / (x1 - x0) * scalar(grid_x, sx.device))
    by = _floor_int((sy - y0) / (y1 - y0) * scalar(grid_y, sy.device))
    return bx, by


def windowed_face_ranges(vertices, faces, camcoords, grid_x, grid_y,
                         window):
    """Spherical binning over an affine signed-angle window (x0, x1, y0, y1)."""
    eye = camcoords[0:3]
    d = vertices[faces.long()] - eye[None, None, :]
    radius = magnitude(d)
    sx, sy = signed_xy_coords(d / radius[..., None], camcoords)
    bx, by = _window_cells(sx, sy, window, grid_x, grid_y)
    return _vertex_ranges(bx, by, radius.amin(dim=1), grid_x, grid_y)


def ray_light_cells_windowed(hit_points, camcoords, grid_x, grid_y, window):
    """Windowed-mode hit point -> light cell; outside/NaN -> sentinel."""
    d = normalize(hit_points - camcoords[0:3][None])
    return window_ray_cells(*signed_xy_coords(d, camcoords), window, grid_x,
                            grid_y)


def window_ray_cells(sx, sy, window, grid_x, grid_y):
    """The light cells of rays with signed angles (sx, sy) under the
    window; outside/NaN -> sentinel."""
    bx, by = _window_cells(sx, sy, window, grid_x, grid_y)
    inside = ((bx >= 0) & (bx < grid_x) & (by >= 0) & (by < grid_y)
              & ~torch.isnan(sx) & ~torch.isnan(sy))
    return torch.where(inside, bx * grid_y + by,
                       grid_x * grid_y).to(torch.int32)


def slab_bins(zmin, z_lo, z_hi, num_slabs: int):
    """SlabKernel (grid_kernel.cu:334-352)."""
    t = (zmin - z_lo) / (z_hi - z_lo)
    bins = _trunc_int(scalar(num_slabs, zmin.device) * t)
    bins = torch.where(zmin >= 0.0, bins, 0)
    return torch.clamp(bins, 0, num_slabs - 1).to(torch.int32)


def z_minmax(zmin_per_face):
    """Host z reduction (frustum_grid.h:225-241) on the device:
    z_lo = min over values >= 0 (init +2), z_hi = max over all (init -2)."""
    two = scalar(2.0, zmin_per_face.device)
    z_lo = torch.minimum(
        two, torch.where(zmin_per_face >= 0.0, zmin_per_face, two).amin())
    z_hi = torch.maximum(-two, zmin_per_face.amax())
    return z_lo, z_hi


def ray_light_cells(hit_points, camcoords, grid_x, grid_y, x_max, y_max,
                    y_typo: bool):
    """mapSort_Effective_kernel (misc_kernel.cu:255-296): cell ids
    blx*grid_y + bly, or the sentinel grid_x*grid_y outside the grid."""
    d = normalize(hit_points - camcoords[0:3][None])
    blx = block_x(d, camcoords, grid_x, x_max)
    bly = block_y(d, camcoords, grid_y, y_max, y_typo)
    inside = (blx >= 0) & (blx < grid_x) & (bly >= 0) & (bly < grid_y)
    return torch.where(inside, blx * grid_y + bly,
                       grid_x * grid_y).to(torch.int32)
