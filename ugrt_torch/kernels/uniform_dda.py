"""D1 — uniform-grid DDA of the reflection rays (CUDA:
``csrc/uniform_dda.cu``).

Replaces ugrt's ``trace_uniform_dda`` (ugrt/trace/reflect.py:56-250).  It
is not a Pallas kernel but XLA control flow: a ``lax.map`` over ray
chunks, a ``lax.while_loop`` per chunk (:229), a ``lax.fori_loop`` of
empty-cell skips and a ``lax.cond`` per triangle batch.  Per ray: slab
entry into the grid's AABB, Amanatides–Woo steps through the uniform
grid of ``grid.build.build_uniform_grid``, up to ``skip_k`` empty cells
skipped per step, the cell's faces tested in batches of ``batch`` up to
``max_batches`` batches (``moller_trumbore_t`` with signed t; hits at
t <= eps and on the ray's own face rejected; strictly smaller t
replaces), done once the best t lies before the cell's exit (+ eps).
Returns dict(t [N] (-1: miss), face_id [N] int32 (-2: miss), overflow
(0-d bool: an alive ray's cell held more than max_batches * batch
faces), steps (0-d int32: the most DDA steps any ray began)).

The kernel runs one thread per ray with no host read; the lanes of a
warp stage each cell's faces in shared memory together and each tests
its own ray on them (the source's note says how).  Its face table is
``trace.reflect.face_table``'s [F, 12] (v0, e1, e2 and 3 pad columns,
rows of 48 bytes); the plain version reads the first nine columns and
takes [F, 9] as well.  Given the image ``width`` of rays in row-major
pixel order, a warp takes an 8x4 pixel tile.  The plain version runs
every ray in one set of PyTorch ops, compacted to the live rays (host
reads) every step on the CPU and every ``COMPACT_EVERY`` steps
elsewhere; a ray's result depends on that ray alone, so both give the
same (t, face_id, overflow).  ``steps`` follows the CPU's count in the
kernel; the plain version on the card counts to its last compaction.

``uniform_dda`` launches the kernel for CUDA tensors and runs
``uniform_dda_plain`` only for CPU tensors (``_build.Kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.vecmath import scalar
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.kernels import _build
from ugrt_torch.kernels._plain import BIG
from ugrt_torch.trace.primary import moller_trumbore_t

# DDA steps between compactions of the plain version's live set off the
# CPU (each is a host read); on the CPU a read costs nothing and every
# step compacts.
COMPACT_EVERY = 4
# Columns of the kernel's face table: (v0, e1, e2) and 3 of padding.
FACE_COLS = 12


def _check(ftab, grid: DeviceGrid, origins, dirs, active, exclude_face, lo,
           hi, grid_dims, *, cfg: RenderConfig, max_batches: int, eps: float,
           batch: int, skip_k: int, width: int | None = None):
    dev = origins.device
    n = origins.shape[0] if origins.dim() == 2 else None
    gx, gy, gz = grid_dims
    _build.check_tensor(ftab, "ftab", torch.float32, (None, FACE_COLS),
                        dev)
    if dev.type == "cuda" and ftab.data_ptr() % 16:
        raise ValueError("ftab: rows must start 16-byte aligned")
    _build.check_tensor(grid.cell_count, "cell_count", torch.int32,
                        (gx * gy * gz,), dev)
    _build.check_tensor(grid.cell_offset, "cell_offset", torch.int32,
                        (gx * gy * gz,), dev)
    _build.check_tensor(grid.sorted_faces, "sorted_faces", torch.int32,
                        (None,), dev)
    _build.check_tensor(origins, "origins", torch.float32, (None, 3), dev)
    _build.check_tensor(dirs, "dirs", torch.float32, (n, 3), dev)
    _build.check_tensor(active, "active", torch.bool, (n,), dev)
    _build.check_tensor(exclude_face, "exclude_face", torch.int32, (n,),
                        dev)
    _build.check_tensor(lo, "lo", torch.float32, (3,), dev)
    _build.check_tensor(hi, "hi", torch.float32, (3,), dev)
    for name, v in (("max_batches", max_batches), ("batch", batch)):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    if not isinstance(skip_k, int) or skip_k < 0:
        raise ValueError(f"skip_k must be an int >= 0, got {skip_k!r}")
    return dev


def _tile_width(n, width):
    """The image width the kernel maps 8x4 pixel tiles with, or 0 (32
    consecutive rays a warp) when ``width`` is None or its tiles do not
    cover the n rays exactly."""
    if width is None or width <= 0 or width % 8 or n % (4 * width):
        return 0
    return width


def _launch(ftab, grid, origins, dirs, active, exclude_face, lo, hi,
            grid_dims, cfg, max_batches, eps, batch, skip_k, width,
            counts=None):
    """Launch the kernel; ``counts``: (ray tests [n] i32, warp work
    [warps, 3] i64) for the counting build."""
    n = origins.shape[0]
    gx, gy, gz = grid_dims
    t = torch.empty((n,), dtype=torch.float32, device=origins.device)
    face = torch.empty((n,), dtype=torch.int32, device=origins.device)
    # (overflow, most steps, the persistent grid's tile counter), zeroed
    # on the current stream before the launch.
    flags = torch.zeros((3,), dtype=torch.int32, device=origins.device)
    ray_tests, warp_work = counts if counts is not None else (None, None)
    _build.launch("ugrt_uniform_dda", ftab, ftab.shape[0], grid.cell_count,
                  grid.cell_offset, grid.sorted_faces,
                  grid.sorted_faces.shape[0], origins, dirs, active,
                  exclude_face, lo, hi, n, _tile_width(n, width), gx, gy, gz,
                  batch, max_batches, skip_k, np.float32(eps),
                  np.float32(cfg.epsilon), t, face, flags, ray_tests,
                  warp_work)
    return dict(t=t, face_id=face, overflow=flags[0] != 0, steps=flags[1])


def uniform_dda_stats(ftab, grid: DeviceGrid, origins, dirs, active,
                      exclude_face, lo, hi, grid_dims, *, cfg: RenderConfig,
                      max_batches: int, eps: float, batch: int,
                      skip_k: int, width: int | None = None):
    """The kernel's work on these inputs (CUDA tensors only), from its
    counting build: ``needed``, the (ray, face) tests its rays run;
    ``staged_lane_slots``, the lane slots its warps spend on staged faces
    (32 per staged face: the warp waits while the lanes of the face's
    cell test it); ``cells``, the distinct cells its warps serve, and
    ``rounds``, the warp rounds that test any face (``cells / rounds``
    distinct cells a round).  Beside them ``lockstep_lane_slots``, what
    a kernel of one ray a lane, whose lanes fetch and test their faces
    in lockstep, would spend on the same tests: 32 x the most tests of
    any ray of each 32 consecutive rays.  A measurement aid: its launch
    is no launch of the main path."""
    _check(ftab, grid, origins, dirs, active, exclude_face, lo, hi,
           grid_dims, cfg=cfg, max_batches=max_batches, eps=eps, batch=batch,
           skip_k=skip_k, width=width)
    if origins.device.type != "cuda":
        raise ValueError("uniform_dda_stats: runs the CUDA kernel, and takes "
                         "CUDA tensors only")
    n = origins.shape[0]
    tests = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    work = torch.zeros((-(-n // 32), 3), dtype=torch.int64,
                       device=origins.device)
    _launch(ftab, grid, origins, dirs, active, exclude_face, lo, hi,
            grid_dims, cfg, max_batches, eps, batch, skip_k, width,
            (tests, work))
    slots, cells, rounds = (int(x) for x in work.sum(dim=0))
    per_warp = torch.nn.functional.pad(tests, (0, -n % 32)).view(-1, 32)
    return dict(needed=int(tests.sum(dtype=torch.int64)),
                staged_lane_slots=slots, cells=cells, rounds=rounds,
                lockstep_lane_slots=32 * int(per_warp.amax(dim=1).sum()))


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


def uniform_dda_plain(ftab, grid: DeviceGrid, origins, dirs, active,
                      exclude_face, lo, hi, grid_dims, *, cfg: RenderConfig,
                      max_batches: int, eps: float, batch: int,
                      skip_k: int, width: int | None = None):
    """``uniform_dda`` in PyTorch ops (any device): every ray in one set,
    compacted to the live rays; batches past the first run on the rays
    whose cell needs them.  ``width`` (the kernel's ray-to-warp map) has
    no effect here; ``ftab`` may also be [F, 9]."""
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
                steps=scalar(it, dev, torch.int32))


@_build.kernel(uniform_dda_plain, _check)
def uniform_dda(ftab, grid: DeviceGrid, origins, dirs, active, exclude_face,
                lo, hi, grid_dims, *, cfg: RenderConfig, max_batches: int,
                eps: float, batch: int, skip_k: int, width: int | None = None):
    """Trace rays through a uniform grid (see the module docstring).

    ftab: [F, 12] f32 per-face (v0, e1, e2, pad); grid: the uniform
    DeviceGrid (cell_count, cell_offset, sorted_faces); origins/dirs:
    [N, 3] f32; active: [N] bool; exclude_face: [N] int32 (self-hit);
    lo/hi: [3] f32 grid AABB; grid_dims: (gx, gy, gz); width: the image
    width when the rays are an image's pixels in row-major order (the
    kernel then gives each warp an 8x4 pixel tile)."""
    return _launch(ftab, grid, origins, dirs, active, exclude_face, lo, hi,
                   grid_dims, cfg, max_batches, eps, batch, skip_k, width)
