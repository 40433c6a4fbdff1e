"""B1 — the ray side of the shadow pass (CUDA: ``csrc/shadow_bin.cu``).

Everything of ``trace.shadow`` between the primary hit and K3's ray
rows, and the unpermute after K3:

- ``shadow_rays``: per ray the hit point, the light cell (the mode's map
  of ``grid.binning``), a stable sort of the rays by cell, then K3's ray
  rows [NB, 128, 8] and each 128-ray block's first cell and last real
  cell (``ShadowRays``);
- ``unpermute``: the sorted blocks' flags back in pixel order;
- ``window_angles``: the windowed mode's per-ray signed angles and their
  NaN-excluded bounds (``trace.shadow.light_window`` before the margin);
  ``shadow_rays`` takes the angles again (``angles=``) instead of
  computing them anew.

The mode follows what the call is given: ``window`` (windowed), else
``x_max`` / ``y_max`` (0-d tensors, extent mode; a Python float or
None, ``cfg.angular_extent``: reference mode).  ugrt runs this side as
XLA ops around its Pallas sweep (ugrt/trace/shadow.py); no Pallas
kernel is replaced.

Each wrapper launches the kernels for CUDA tensors and runs its plain
version (``*_plain``, the torch chain it replaces, any device) only for
CPU tensors (``_build.Kernel``); results are bitwise the plain
versions'.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.vecmath import dot, normalize, sqrt
from ugrt_torch.grid import binning
from ugrt_torch.kernels import _build

BLOCK = 128          # K3's ray block
_TILE = 2048         # csrc/shadow_bin.cu kTile
_RADIX = 256         # csrc/shadow_bin.cu kRadix


class ShadowRays(NamedTuple):
    """The sorted shadow rays, as K3 takes them."""

    rows: torch.Tensor        # [NB, 128, 8] f32: dir 0:3, distance 3,
    #                           key 4 (slab 0), gx 5, gy 6, 0
    scells: torch.Tensor      # [NB * 128] int32 sorted cells, sentinel pad
    perm: torch.Tensor        # [N] int32: slot j holds ray perm[j]
    first_cell: torch.Tensor  # [NB] int32: each block's least cell
    last_real: torch.Tensor   # [NB] int32: its last non-sentinel cell, or -1


def hit_points(primary, primary_eye):
    """[N, 3] eye + t * dir of every pixel (misses included)."""
    n = primary["t"].numel()
    return (primary_eye[None] + primary["t"].reshape(n)[:, None]
            * primary["ray_dir"].reshape(n, 3))


def _signed_angles(primary, primary_eye, light_camcoords):
    d = normalize(hit_points(primary, primary_eye)
                  - light_camcoords[0:3][None])
    return binning.signed_xy_coords(d, light_camcoords)


def _flat(primary):
    """(t [N], ray_dir [N, 3]) of ``primary``'s N rays."""
    n = primary["t"].numel()
    return primary["t"].reshape(n), primary["ray_dir"].reshape(n, 3)


def _check_angles(primary, primary_eye, light_camcoords):
    """Raise unless the rays, eye and light fit B1's kernels; returns
    their device."""
    t, dirs = _flat(primary)
    dev, n = t.device, t.numel()
    _build.check_tensor(t, "t", torch.float32, (n,), dev)
    _build.check_tensor(dirs, "ray_dir", torch.float32, (n, 3), dev)
    _build.check_tensor(primary_eye, "primary_eye", torch.float32, (3,), dev)
    _build.check_tensor(light_camcoords, "light_camcoords", torch.float32,
                        (None,), dev)
    if light_camcoords.shape[0] < 32:
        raise ValueError("light_camcoords: needs the modelview at [16:32]")
    return dev


def _check_rays(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                *, x_max=None, y_max=None, window=None, angles=None):
    dev = _check_angles(primary, primary_eye, light_camcoords)
    if angles is not None and window is None:
        raise ValueError("shadow_rays: angles= is the windowed mode's")
    return dev


def _check_unpermute(flags, perm):
    dev = perm.device
    _build.check_tensor(perm, "perm", torch.int32, (None,), dev)
    _build.check_tensor(flags, "flags", torch.int32, (None, BLOCK), dev)
    if flags.numel() < perm.numel():
        raise ValueError("unpermute: fewer flags than rays")
    return dev


def window_angles_plain(primary, primary_eye, light_camcoords):
    """``window_angles`` in torch ops."""
    sx, sy = _signed_angles(primary, primary_eye, light_camcoords)

    def lohi(s):
        ok = ~torch.isnan(s)
        return (torch.where(ok, s, 4.0).amin(),
                torch.where(ok, s, -4.0).amax())

    return (*lohi(sx), *lohi(sy)), (sx, sy)


@_build.kernel(window_angles_plain, _check_angles)
def window_angles(primary, primary_eye, light_camcoords):
    """((x0, x1, y0, y1) 0-d f32, (sx, sy) [N] f32): every ray's signed
    angles seen from the light (``binning.signed_xy_coords``; NaN for a
    degenerate direction) and their bounds over the rays where they are
    not NaN (4 and -4 where none is), before any margin."""
    t, dirs = _flat(primary)
    n = t.numel()
    sx = torch.empty((n,), dtype=torch.float32, device=t.device)
    sy = torch.empty_like(sx)
    partials = torch.empty((4 * -(-n // _TILE),), dtype=torch.float32,
                           device=t.device)
    bounds = torch.empty((4,), dtype=torch.float32, device=t.device)
    _build.launch("ugrt_shadow_window", t, dirs, primary_eye,
                  light_camcoords, n, sx, sy, partials, bounds)
    return tuple(bounds[k] for k in range(4)), (sx, sy)


def shadow_rays_plain(primary, primary_eye, light_camcoords,
                      cfg: RenderConfig, *, x_max=None, y_max=None,
                      window=None, angles=None) -> ShadowRays:
    """``shadow_rays`` in torch ops."""
    n = primary["t"].numel()
    dev = primary["t"].device
    sentinel = cfg.cell_sentinel
    pts = hit_points(primary, primary_eye)
    if window is not None:
        if angles is None:
            angles = _signed_angles(primary, primary_eye, light_camcoords)
        cells = binning.window_ray_cells(*angles, window, cfg.grid_x,
                                         cfg.grid_y)
    else:
        cells = binning.ray_light_cells(
            pts, light_camcoords, cfg.grid_x, cfg.grid_y,
            cfg.angular_extent if x_max is None else x_max,
            cfg.angular_extent if y_max is None else y_max,
            cfg.quirks.y_forward_dot_typo)

    # Stable sort by light cell; per-ray math on the sorted points is
    # elementwise, so it commutes with the permutation bitwise.
    sorted_cells, perm = torch.sort(cells, stable=True)
    n_pad = -(-n // BLOCK) * BLOCK
    nb = n_pad // BLOCK
    delta = pts[perm] - light_camcoords[0:3][None]
    scells = torch.full((n_pad,), sentinel, dtype=torch.int32, device=dev)
    scells[:n] = sorted_cells
    scell_blk = scells.reshape(nb, BLOCK)

    # Sentinel rays get key -1 and gx = grid_x, outside every footprint.
    rows = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    rows[:n, 0:3] = normalize(delta)
    rows[:n, 3] = sqrt(dot(delta, delta))
    rows[:, 4] = torch.where(scells < sentinel,
                             (scells * cfg.num_slabs).float(), -1.0)
    rows[:, 5] = torch.div(scells, cfg.grid_y, rounding_mode="floor").float()
    rows[:, 6] = (scells % cfg.grid_y).float()
    last_real = torch.where(scell_blk < sentinel, scell_blk, -1).amax(dim=1)
    return ShadowRays(rows.reshape(nb, BLOCK, 8), scells,
                      perm.to(torch.int32), scell_blk[:, 0].contiguous(),
                      last_real)


@_build.kernel(shadow_rays_plain, _check_rays)
def shadow_rays(primary, primary_eye, light_camcoords, cfg: RenderConfig,
                *, x_max=None, y_max=None, window=None,
                angles=None) -> ShadowRays:
    """The shadow rays of ``primary`` ({"t": [...], "ray_dir": [..., 3]},
    N rays) toward the light at ``light_camcoords[0:3]``, sorted stably
    by light cell (``ShadowRays``).  ``window``: (x0, x1, y0, y1) 0-d
    tensors, the windowed map; else ``x_max`` / ``y_max``, the extent of
    the reference map.  ``angles``: windowed only, (sx, sy) from
    ``window_angles`` on the same rays."""
    t, dirs = _flat(primary)
    n, dev = t.numel(), t.device
    if window is not None:
        win = [_scalar(w, f"window[{k}]", dev) for k, w in enumerate(window)]
        if angles is not None:
            for a, name in zip(angles, ("sx", "sy")):
                _build.check_tensor(a, name, torch.float32, (n,), dev)
        (xp, xv), (yp, yv) = (None, 0.0), (None, 0.0)
    else:
        win = [None] * 4
        (xp, xv), (yp, yv) = (_extent(v, cfg, dev) for v in (x_max, y_max))
    sx, sy = angles if angles is not None else (None, None)
    n_pad = -(-n // BLOCK) * BLOCK
    nb = n_pad // BLOCK
    i32 = torch.int32
    scratch = torch.empty((4 * n + _RADIX * (-(-n // _TILE) + 1),),
                          dtype=i32, device=dev)
    scells = torch.empty((n_pad,), dtype=i32, device=dev)
    perm = torch.empty((n,), dtype=i32, device=dev)
    rows = torch.empty((nb, BLOCK, 8), dtype=torch.float32, device=dev)
    first_cell = torch.empty((nb,), dtype=i32, device=dev)
    last_real = torch.empty((nb,), dtype=i32, device=dev)
    _build.launch("ugrt_shadow_rays", t, dirs, primary_eye, light_camcoords,
                  n, cfg.grid_x, cfg.grid_y, cfg.num_slabs,
                  int(cfg.quirks.y_forward_dot_typo), xp, yp, np.float32(xv),
                  np.float32(yv), *win, sx, sy,
                  scratch, scells, perm, rows, first_cell, last_real)
    return ShadowRays(rows, scells, perm, first_cell, last_real)


def unpermute_plain(flags, perm):
    """``unpermute`` in torch ops: a scatter by the sort permutation
    (unique indices, so deterministic)."""
    out = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    out[perm.long()] = flags.reshape(-1)[:perm.numel()]
    return out


@_build.kernel(unpermute_plain, _check_unpermute)
def unpermute(flags, perm):
    """[N] int32 out with out[perm[j]] = flags[j] (``flags`` the sorted
    blocks' [NB, 128] flags; slots past N are pad)."""
    out = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    _build.launch("ugrt_shadow_unpermute", flags, perm, perm.numel(), out)
    return out


def _extent(v, cfg: RenderConfig, dev):
    """(0-d tensor, 0) for an extent mode's tensor, (None, the value) for
    a number or None (``cfg.angular_extent``), as the kernel takes them."""
    v = cfg.angular_extent if v is None else v
    if isinstance(v, torch.Tensor):
        return _scalar(v, "x_max / y_max", dev), 0.0
    return None, v


def _scalar(x, name, dev):
    _build.check_tensor(x, name, torch.float32, (), dev)
    return x
