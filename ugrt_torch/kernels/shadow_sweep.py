"""K3 — shadow sweep (CUDA: ``csrc/shadow_sweep.cu``).

Replaces ugrt's Pallas ``shadow_sweep`` (ugrt/trace/pallas_tracer.py:
_shadow_kernel + _shadow_body, :390-472) at both of its call sites in
ugrt/trace/shadow.py: the cell-key sweep over 256-wide windows of
``pack_tri_windows_coeff`` (:455) and, with ``box=True``, the heavy
sweep over 128-wide ``pack_heavy_coeff_windows`` admitted by footprint
box (:481).  Per ray: 1 if any admitted triangle occludes the segment
from the light to the ray's surface point, else 0.

The work is a list of items: each ray block's inclusive window range
cut into chunks of at most ``chunk`` windows (``_plain.chunk_item_end``,
shared with K1).  The kernel's persistent blocks take items from a
device counter; the plain version walks the same items.  Items merge
by OR, so the result does not depend on ``chunk``, nor on the kernel's
walk (``serial``).

``shadow_sweep`` launches the kernel for CUDA tensors and runs
``shadow_sweep_plain`` only for CPU tensors.  ``shadow_sweep_stats``
launches the kernel's counting build and returns what it ran
(``STATS``).
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.vecmath import sqrt
from ugrt_torch.kernels import _build
from ugrt_torch.kernels._plain import chunk_item_end, chunk_runs, or_into

_T_MAX = np.float32(999999.9)   # intersectTri accept bound
# The counting build's counts, in the order of csrc/shadow_sweep.cu's
# enum Stat.  A warp step is one pass of the test arithmetic over a
# warp's 32 lanes.
STATS = ("items", "unstaged_windows", "known_rays", "vote_skipped_steps",
         "executed_steps", "live_tests", "prefilter_skipped_steps",
         "divided_steps", "divided_tests", "hint_steps", "hint_hits",
         "deferred_rays")
HINTS = 1024   # the serial walk's hint slots (csrc/shadow_sweep.cu, kHints)


def _check(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
           box: bool = False, chunk: int = 1, serial: bool = False):
    dev = rays.device
    nb = rays.shape[0] if rays.dim() == 3 else None
    _build.check_tensor(tri_windows, "tri_windows", torch.float32,
                        (None, None, 16), dev)
    if tri_windows.shape[1] % 4:
        raise ValueError("tri_windows: window width must be a multiple of 4")
    _build.check_tensor(rays, "rays", torch.float32, (None, 128, 8), dev)
    _build.check_tensor(w_lo, "w_lo", torch.int32, (nb,), dev)
    _build.check_tensor(w_hi, "w_hi", torch.int32, (nb,), dev)
    if tri_windows.data_ptr() % 16:
        raise ValueError("tri_windows: the kernel reads it as float4; its "
                         "data must be 16-byte aligned")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    if serial and tri_windows.shape[1] % 32:
        raise ValueError("tri_windows: the serial walk takes windows of a "
                         "multiple of 32 rows")
    return dev


def _launch(tri_windows, rays, w_lo, w_hi, cfg, box, chunk, serial, stats):
    nb, nw = rays.shape[0], tri_windows.shape[0]
    item_end = chunk_item_end(w_lo, w_hi, nw, chunk)
    # The flags, the item counter and, for the serial walk, pass 2's item
    # counter and ray count and the hint slots: one zero fill on the
    # current stream, before the launch.  Pass 2's rays (``rest``, one
    # slot a ray) need no fill.
    buf = torch.zeros((nb * 128 + (3 + HINTS if serial else 1),),
                      dtype=torch.int32, device=rays.device)
    rest = cols = None
    if serial:
        rest = torch.empty((nb * 128, 4), dtype=torch.int32,
                           device=rays.device)
        # The serial walk's lanes read 32 rows' component k at once.
        cols = tri_windows.reshape(-1, 32, 16).transpose(1, 2).contiguous()
    _build.launch("ugrt_shadow_sweep", tri_windows, cols, nw,
                  tri_windows.shape[1], rays, nb, w_lo, w_hi, item_end, chunk,
                  np.float32(cfg.epsilon), np.float32(cfg.shadow_epsilon),
                  int(cfg.quirks.shadow_accept_negative_t), int(box),
                  int(serial), buf, rest, nb * 128 if serial else 0, stats)
    return buf[:nb * 128].view(nb, 128)


def shadow_sweep_stats(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
                       box: bool = False, chunk: int = 1,
                       serial: bool = False):
    """The kernel's counts on these inputs (CUDA tensors only), by the
    names of ``STATS``.  A warp step is one pass over a warp's 32 lanes:
    a row against 32 rays (block walk) or a ray against 32 rows (serial
    walk).  The counts: work items run; windows left unstaged because all
    of a block's rays were occluded (block walk); rays already flagged
    when their item began (serial walk); warp steps skipped at the
    admission vote, and executed; the lanes of executed steps that admit
    their row and still need it (tests); steps skipped at the t-free
    vote; steps that ran the division and their tests past the t-free
    test; the serial walk's steps on a hinted group, those that occluded
    the ray, and the rays its second pass walked.  A measurement aid: it
    launches a counting build of the kernel and is no launch of the main
    path."""
    _check(tri_windows, rays, w_lo, w_hi, cfg=cfg, box=box, chunk=chunk,
           serial=serial)
    if rays.device.type != "cuda":
        raise ValueError("shadow_sweep_stats: the counts are the CUDA "
                         "kernel's")
    stats = torch.zeros((len(STATS),), dtype=torch.int64, device=rays.device)
    _launch(tri_windows, rays, w_lo, w_hi, cfg, box, chunk, serial, stats)
    return dict(zip(STATS, stats.tolist()))


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


@_build.kernel(shadow_sweep_plain, _check)
def shadow_sweep(tri_windows, rays, w_lo, w_hi, *, cfg: RenderConfig,
                 box: bool = False, chunk: int = 1, serial: bool = False):
    """Per-ray occlusion flags [NB, 128] int32.

    tri_windows: [NW, win, 16] coefficient rows; rays: [NB, 128, 8]
    (dir 0:3, light-to-point distance 3, cell key 4, gx 5, gy 6);
    w_lo/w_hi: [NB] int32 inclusive window ranges.  A row is a candidate
    when its key equals the ray's (box=False) or its footprint box holds
    the ray's (gx, gy) (box=True).  ``chunk``: windows per work item.
    ``serial``: the kernel's serial walk (each warp takes its rays one
    after another, 32 rows a step, the group that occluded the ray before
    first; a second pass walks the rays that group missed) instead of
    its block walk (each warp takes a row against its 32 rays a step);
    the flags are the same.
    """
    return _launch(tri_windows, rays, w_lo, w_hi, cfg, box, chunk, serial,
                   None)


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
