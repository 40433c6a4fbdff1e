"""Primary-ray tracing over the perspective grid (torch mirror of the
kernel branch of ugrt/trace/primary.py:201-443).

Per slab, K1 (kernels/primary_sweep) sweeps each block of two 8x8 tiles
(128 rays) over the windows of its two cells' pair span, in work items
of at most PCHUNK windows; K2 (kernels/heavy_primary_sweep) sweeps every
ray over the heavy list and its (t, face) merges by lex-min into slab 0.  Then the sequential slab
scan with the isWithin reprojection (trace_kernel.cu:56-82) picks each
ray's hit, and a per-face normal table gives the normals.  Misses report
t = -1, face_id = -2, normal = -1 (trace_kernel.cu:254-263).

ugrt's XLA work-item branch (primary.py:60-198, :310-334) has no
counterpart: on the CPU the sweeps run their plain PyTorch versions.
``backend`` is ugrt's argument of that name (primary.py:201-204) with
the port's values: None (the kernels on CUDA tensors, the plain versions
on CPU ones), "kernel" (CUDA tensors only) or "plain" (the plain
versions on any device; bench's parity gate holds the two apart).
"""

from __future__ import annotations

import torch

from ugrt_torch.api import profiler
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.camera import primary_ray_dirs
from ugrt_torch.core.vecmath import cross, dot, normalize, transform_point
from ugrt_torch.grid.build import DeviceGrid
from ugrt_torch.kernels._build import choose_sweep
from ugrt_torch.kernels.heavy_primary_sweep import heavy_primary_sweep
from ugrt_torch.kernels.primary_sweep import primary_sweep
from ugrt_torch.trace import heavy as theavy
from ugrt_torch.trace import windows as tw

# Windows per K1 work item: the fastest of 1, 2, 4 and 8 on the flagship
# frame (PERF.md, K1: 1.43 windows per ray block on average, 85 at most).
PCHUNK = 1


def moller_trumbore_t(tvec, e1, e2, ray_d, cfg: RenderConfig,
                      abs_t: bool | None = None):
    """Batched intersectTriUV t (ugrt/trace/primary.py:92-114,
    trace_kernel.cu:4-45) in ugrt's op order.

    tvec/e1/e2: [..., K, 3]; ray_d: [..., R, 3].  Returns t [..., R, K]
    with 0 for rejects and |t| under the abs_t quirk; ``abs_t=False``
    keeps the signed t (the reflection DDA's test)."""
    if abs_t is None:
        abs_t = cfg.quirks.abs_t
    pvec = cross(ray_d[..., :, None, :], e2[..., None, :, :])
    det = dot(e1[..., None, :, :], pvec)
    inv_det = 1.0 / det
    u = dot(tvec[..., None, :, :], pvec) * inv_det
    qvec = cross(tvec[..., None, :, :], e1[..., None, :, :])
    v = dot(ray_d[..., :, None, :], qvec) * inv_det
    t = dot(e2[..., None, :, :], qvec) * inv_det
    if abs_t:
        t = torch.abs(t)
    reject = ((torch.abs(det) < cfg.epsilon) | (u < 0) | (u > 1) | (v < 0)
              | (u + v > 1))
    return torch.where(reject, 0.0, t)


def face_normals(vertices, faces):
    """[F, 3] signed geometric normals, normalize(normalize(e1) x
    normalize(e2)) (trace_kernel.cu:241-243 without the abs quirk)."""
    fv = vertices[faces.long()]
    return normalize(cross(normalize(fv[:, 1] - fv[:, 0]),
                           normalize(fv[:, 2] - fv[:, 0])))


def tile_rays(dirs, cfg: RenderConfig):
    """[H, W, C] -> [tiles, tile_y * tile_x, C], tile = bx * tiles_y + by
    (trace_kernel.cu:91,138: in-tile ray ty * 8 + tx, x-major cells)."""
    ty, tx = cfg.tile_y, cfg.tile_x
    h, w = dirs.shape[:2]
    d = dirs.reshape(h // ty, ty, w // tx, tx, *dirs.shape[2:])
    d = d.permute(2, 0, 1, 3, *range(4, d.dim()))
    return d.reshape((w // tx) * (h // ty), ty * tx, *dirs.shape[2:])


def untile(img_tiled, cfg: RenderConfig, tiles_x: int, tiles_y: int):
    """[tiles, tile_y * tile_x, ...] -> [h, w, ...] (inverse of tile_rays)."""
    ty, tx = cfg.tile_y, cfg.tile_x
    trailing = img_tiled.shape[2:]
    d = img_tiled.reshape(tiles_x, tiles_y, ty, tx, *trailing)
    d = d.permute(1, 2, 0, 3, *range(4, 4 + len(trailing)))
    return d.reshape(tiles_y * ty, tiles_x * tx, *trailing)


@profiler.spanned("trace.primary", device=True)
def trace_primary(vertices, faces, camcoords, grid: DeviceGrid,
                  cfg: RenderConfig, *, bx0: int = 0, n_bx: int | None = None,
                  backend: str | None = None):
    """Full primary trace.  Returns per-pixel t [H, w], face_id [H, w]
    int32, normal [H, w, 3] and ray_dir [H, w, 3].

    ``bx0`` / ``n_bx`` select a strip of tile columns (ugrt/trace/
    primary.py:203-233): only tiles bx in [bx0, bx0 + n_bx) are traced,
    and the outputs cover image columns [bx0 * 8, (bx0 + n_bx) * 8).  The
    grid is the whole image's.  Default: the whole image (w = W).  Every
    ray's result is its own, so strips side by side equal the whole
    image bit for bit (``dist.mesh`` renders one strip per rank).
    ``backend``: which sweeps run K1 and K2 (module docstring)."""
    H, W = cfg.screen_height, cfg.screen_width
    if (W // cfg.tile_x != cfg.grid_x or H // cfg.tile_y != cfg.grid_y
            or cfg.tile_x * cfg.tile_y != 64):
        raise ValueError("screen tiles must be 8x8 and match the grid "
                         "(main.cu.h:10-28)")
    tiles_y = cfg.grid_y
    if n_bx is None:
        n_bx = cfg.grid_x
    if not (0 <= bx0 and 1 <= n_bx and bx0 + n_bx <= cfg.grid_x):
        raise ValueError(f"strip bx0={bx0}, n_bx={n_bx} is not inside the "
                         f"{cfg.grid_x} tile columns")
    NS = cfg.num_slabs
    num_tiles = n_bx * tiles_y
    if num_tiles % 2:
        raise ValueError("the sweeps pack two 64-ray tiles per 128-ray "
                         "block: n_bx * grid_y must be even")
    nb = num_tiles // 2
    dev = camcoords.device
    sweep = choose_sweep(primary_sweep, backend, dev)
    heavy_sweep = choose_sweep(heavy_primary_sweep, backend, dev)
    # The strip's first cell: cells are x-major (bx * grid_y + by) with
    # NS slabs each.  Keys travel as f32, exact below 2^24.
    c0 = bx0 * tiles_y * NS

    eye = camcoords[0:3]
    dirs = primary_ray_dirs(camcoords, W, H)[
        :, bx0 * cfg.tile_x:(bx0 + n_bx) * cfg.tile_x]
    rays_t = tile_rays(dirs, cfg)                            # [T, 64, 3]
    tri_w = tw.pack_tri_windows(vertices, faces, grid, eye)

    # Ray rows [NB, 128, 8]: dir 0:3, cell key 3, the tile's grid cell
    # (gx, gy) 4:6 for the heavy footprint test.
    tiles = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    rows = torch.zeros((num_tiles, 64, 8), dtype=torch.float32, device=dev)
    rows[:, :, 0:3] = rays_t
    rows[:, :, 4] = (bx0 + tiles // tiles_y).float()[:, None]
    rows[:, :, 5] = (tiles % tiles_y).float()[:, None]
    rows = rows.reshape(nb, 128, 8)
    blocks = torch.arange(nb, dtype=torch.int64, device=dev)

    t_slabs, f_slabs = [], []
    for s in range(NS):
        rows[:, :, 3] = (c0 + tiles * NS + s).float().reshape(
            nb, 2, 1).expand(nb, 2, 64).reshape(nb, 128)
        k1 = c0 + 2 * blocks * NS + s
        k2 = c0 + (2 * blocks + 1) * NS + s
        lo = grid.cell_offset[k1]
        hi = grid.cell_offset[k2] + grid.cell_count[k2]
        w_lo, w_hi = tw.window_span(lo, hi, tw.WIN)
        t_blk, f_blk = sweep(tri_w, rows, w_lo, w_hi, cfg=cfg, chunk=PCHUNK)
        t_slabs.append(t_blk.reshape(num_tiles, 64))
        f_slabs.append(f_blk.reshape(num_tiles, 64))
    t_cell = torch.stack(t_slabs, dim=1)                     # [T, NS, 64]
    f_cell = torch.stack(f_slabs, dim=1)

    if grid.heavy_faces.shape[0] > 0:
        co = theavy.heavy_coeffs(vertices, faces, grid.heavy_faces,
                                 grid.heavy_count, eye, grid.heavy_ranges)
        table = tw.pack_heavy_windows(co)
        t_hb, f_hb = heavy_sweep(grid.heavy_count, table, rows, cfg=cfg)
        # K2 already reports face 2^31-1 wherever t is 3e38 (no hit).
        t_h = t_hb.reshape(num_tiles, 64)
        f_h = f_hb.reshape(num_tiles, 64)
        # Heavy faces live in slab 0 (the split needs num_slabs == 1).
        t_c0, f_c0 = t_cell[:, 0], f_cell[:, 0]
        take_h = (t_h < t_c0) | ((t_h == t_c0) & (f_h < f_c0))
        t_cell[:, 0] = torch.where(take_h, t_h, t_c0)
        f_cell[:, 0] = torch.where(take_h, f_h, f_c0)

    # Sequential slab scan with the isWithin(done) state machine.
    mvp = camcoords[48:64]
    oldt = torch.full((num_tiles, 64), 99999999.9, dtype=torch.float32,
                      device=dev)
    win = torch.full((num_tiles, 64), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((num_tiles, 64), dtype=torch.int32, device=dev)
    for s in range(NS):
        m, wk = t_cell[:, s], f_cell[:, s]
        upd = (done != 2) & (m < oldt)
        oldt = torch.where(upd, m, oldt)
        win = torch.where(upd, wk, win)
        done = torch.where(upd, 1, done)
        pt = eye[None, None, :] + oldt[..., None] * rays_t
        zbin = torch.floor(transform_point(mvp, pt)[..., 2] * NS)
        done = torch.where((done == 1) & (zbin == float(s)), 2, done)

    ok = done == 2
    face_id = torch.where(ok, win, -2).to(torch.int32)

    # Geometric normals from a per-face table (the same op sequence per
    # face as per pixel, so bitwise equal to the per-pixel form).
    fnrm = face_normals(vertices, faces)
    if cfg.quirks.abs_normal:
        fnrm = torch.abs(fnrm)
    nrm = fnrm[torch.clamp(face_id, min=0).long()]
    nrm = torch.where(ok[..., None], nrm, -1.0)
    t_out = torch.where(ok, oldt, -1.0)

    return dict(t=untile(t_out, cfg, n_bx, tiles_y),
                face_id=untile(face_id, cfg, n_bx, tiles_y),
                normal=untile(nrm, cfg, n_bx, tiles_y),
                ray_dir=dirs)
