"""Reflection rays through the world-space uniform grid (torch mirror of
ugrt/trace/reflect.py:43-283).

From each primary hit, the mirror direction about the SIGNED geometric
normal oriented against the incoming ray; then a 3-D DDA
(Amanatides–Woo) through the uniform grid of
``grid.build.build_uniform_grid``.  Per DDA step each live ray first
skips up to ``skip_k`` empty cells, then tests its cell's faces in
batches of B (``moller_trumbore_t`` with signed t) up to ``max_batches``
batches, keeps the min t and the first face reaching it (strictly
smaller t replaces), and stops once that t lies before the cell's exit
(+ eps).  Hits at t <= eps and on the ray's own face are rejected;
misses report t = -1 and face -2.  A cell deeper than max_batches * B
faces sets ``overflow``.

ugrt chunks the rays (``lax.map``) and runs a ``lax.while_loop`` per
chunk for the TPU's memory and control flow.  A ray's (t, face) depends
on that ray alone and the step bound gx + gy + gz is global, so here
every ray runs in one set that is compacted to the live rays (one host
read); batches past the first run on the rays whose cell needs them.
Dead rays never change, so on the card the set is compacted only every
``COMPACT_EVERY`` steps, which saves host reads and changes nothing.
"""

from __future__ import annotations

import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.vecmath import dot, normalize
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.trace.primary import moller_trumbore_t

BIG = 3.0e38
# DDA steps between compactions of the live set on the card (each is a
# host read); on the CPU a read costs nothing and every step compacts.
COMPACT_EVERY = 4


def reflect_directions(primary):
    """Mirror reflection of the primary ray at the hit normal, the
    normal first oriented against the incoming direction:
    n <- -sign(d.n) n, r = d - 2 (d.n) n."""
    d = primary["ray_dir"]
    n = primary["normal"]
    s = torch.where(dot(d, n) > 0, -1.0, 1.0)[..., None]
    n = n * s
    return d - 2.0 * dot(d, n)[..., None] * n


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


def trace_uniform_dda(vertices, faces, grid: DeviceGrid, origins, dirs,
                      active, exclude_face, aabb_min, aabb_max,
                      grid_dims, cfg: RenderConfig, *,
                      max_batches: int = 4, eps: float = 1e-4,
                      batch: int | None = None, skip_k: int = 6):
    """Trace rays through a uniform grid with 3-D DDA.

    origins/dirs: [N, 3] float32; active: [N] bool; exclude_face: [N]
    int32 face to ignore (self-hit).  ``batch`` defaults to
    cfg.tri_batch.  Returns dict(t [N] (-1: miss), face_id [N] int32
    (-2: miss), overflow (0-d bool tensor), steps (DDA steps run))."""
    gx, gy, gz = grid_dims
    dev = origins.device
    f32 = torch.float32
    lo = torch.as_tensor(aabb_min, dtype=f32, device=dev)
    hi = torch.as_tensor(aabb_max, dtype=f32, device=dev)
    dims = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    cell_size = (hi - lo) / dims.to(f32)
    n = origins.shape[0]
    num_cells = gx * gy * gz
    cap, num_faces = grid.sorted_faces.shape[0], faces.shape[0]
    B = batch if batch is not None else cfg.tri_batch
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    max_steps = gx + gy + gz
    compact_every = 1 if dev.type == "cpu" else COMPACT_EVERY

    # Per-face corner table (v0, e1, e2).
    fv = vertices[faces.long()]
    ftab = torch.cat([fv[:, 0], fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]],
                     dim=1)

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
                overflow=overflow, steps=it)


def reflection_pass(vertices, faces, primary_refined, uniform_grid,
                    aabb_min, aabb_max, grid_dims, cfg: RenderConfig,
                    primary_eye, *, max_batches: int = 4,
                    batch: int | None = None):
    """Second-level trace: reflect the primary hits (their ``normal``
    signed, not the abs quirk's) and trace the uniform grid.  Returns
    per-pixel dict(t, face_id, ray_dir, origin) of the reflection hit,
    shapes [H, W(, 3)], with ``overflow`` and ``steps``."""
    H, W = primary_refined["t"].shape
    n = H * W
    t = primary_refined["t"].reshape(n)
    d = primary_refined["ray_dir"].reshape(n, 3)
    face = primary_refined["face_id"].reshape(n)

    origins = primary_eye[None] + t[:, None] * d
    rdir = normalize(reflect_directions(dict(
        ray_dir=d, normal=primary_refined["normal"].reshape(n, 3))))
    res = trace_uniform_dda(vertices, faces, uniform_grid, origins, rdir,
                            face >= 0, face, aabb_min, aabb_max, grid_dims,
                            cfg, max_batches=max_batches, batch=batch)
    return dict(t=res["t"].reshape(H, W), face_id=res["face_id"].reshape(H, W),
                ray_dir=rdir.reshape(H, W, 3), origin=origins.reshape(H, W, 3),
                overflow=res["overflow"], steps=res["steps"])
