"""Flagship line-item profile with chained timing (the counterpart of
scripts/profile_chain.py).

    python -m ugrt_torch.micro.profile_chain

Workload: the script's own, nothing cut: ``RenderConfig()`` (1024x1024
over a 128x128 grid, the **reference** light grid, the CLI's default),
the 73,824-face procedural cathedral (a 75,000 target), bench's camera
and light (aspect 1) and the pair capacity of ``cfg.pair_capacity``.

Every line item is a ``core.program.Program`` over a closure of its one
tensor input, timed by ``micro._timing.chain_ms`` over ``N`` = 5 calls
(call k's input carries a zero-valued dependency on call k-1's output;
one synchronize ends the window), as ``bench.breakdown_ms`` times its
stages.  Each prints host-clock ms and CUDA-event ms, and its program is
cleared after use.  The items follow the script's order on the port's
functions (``LINE_ITEMS``), with the lines of the TPU-era scripts that
profile_chain.py and bench's ``--breakdown`` leave out (the floor that
every item pays, their round-trip line; the ray directions and tiling;
the merge of K1's and K2's hits, the counterpart of profile_primary.py's
segment-min combine), and the glue around the sweeps (the normals).
The shadow rays' binning, sort, rows and unpermute, which the script
times as five items, are B1's two launches here; the triangle side's
rows and ranges are B2's, timed beside ``pack_tri_windows_coeff`` and
B2's plain version (the torch chain it replaced).  The sweeps and B1 go
through their wrappers, as the frame's do: the CUDA kernels on the
card, their plain versions on the CPU.  K1, K2 and K3 alone take the inputs the frame hands them
(``micro.k3_chunks.record_sweeps`` on an eager frame).

Statistics (profile_chain.py:44-47, :103, :218-240): the pairs and heavy
faces of both grids; the windows that the port's ``window_span`` ranges
give K1 and K3's cell-key site per 128-ray block (they replace ugrt's
``make_windows`` items, which the port has no counterpart of); rays in
the light grid, distinct cells, the most rays in a cell and its 99th
percentile; light-grid cells occupied, the most triangles in a cell and
the mean over occupied cells.

The last line of stdout is one JSON object: the rows, the statistics and
the card.  It runs on the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ugrt_torch import bridge
from ugrt_torch.bench import CAMERA, LIGHT
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.camera import primary_ray_dirs
from ugrt_torch.core.program import Program
from ugrt_torch.core.vecmath import transform_point
from ugrt_torch.grid import binning
from ugrt_torch.grid import build as gbuild
from ugrt_torch.kernels.heavy_primary_sweep import heavy_primary_sweep
from ugrt_torch.kernels.primary_sweep import primary_sweep
from ugrt_torch.kernels.shadow_bin import shadow_rays, unpermute
from ugrt_torch.kernels.shadow_sweep import shadow_sweep
from ugrt_torch.kernels.shadow_tris import SWIN, shadow_tris
from ugrt_torch.micro._common import card_line, main_device
from ugrt_torch.micro._timing import chain_ms
from ugrt_torch.micro.k3_chunks import record_sweeps
from ugrt_torch.scene import procedural
from ugrt_torch.trace import heavy as theavy
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import shadow as tshadow
from ugrt_torch.trace import windows as tw

N = 5
LINE_ITEMS = (
    "program floor (1-element op)",
    "grid build persp",
    "grid build spherical",
    "  persp ranges (binning)",
    "  sph ranges (binning)",
    "  persp expand+sort+csr",
    "  sort int64 [cap]",
    "primary full",
    "primary full (heavy off)",
    "  ray dirs + tile_rays",
    "  pack_tri_windows",
    "  K1 primary_sweep",
    "  heavy: pack_heavy_windows + K2 1M",
    "  (t, face) lex-min merge K1/K2",
    "  slab-scan reprojection 1M",
    "  face normals + per-pixel gather",
    "shadow full",
    "shadow full (heavy off)",
    "  B1 shadow_rays (bin, sort, rows) 1M",
    "  B1 unpermute 1M",
    "  K3 shadow_sweep, box site",
    "  pack_tri_windows_coeff",
    "  B2 shadow_tris (rows, heavy rows, ranges)",
    "  B2's plain chain (shadow_tris_plain)",
    "  K3 shadow_sweep, key site",
)
STATS = ("faces", "capacity", "persp_pairs", "persp_heavy", "sph_pairs",
         "sph_heavy", "primary_blocks", "primary_windows", "shadow_blocks",
         "shadow_windows", "rays", "rays_in_grid", "distinct_cells",
         "max_rays_per_cell", "p99_rays_per_cell", "light_cells_occupied",
         "max_tris_per_cell", "mean_tris_per_occupied_cell")


def window_count(w_lo, w_hi, nw: int) -> int:
    """Windows in the inclusive ranges [max(w_lo, 0), min(w_hi, nw - 1)]
    (empty where w_hi < w_lo), as the sweeps walk them."""
    n = (torch.clamp(w_hi.long(), max=nw - 1)
         - torch.clamp(w_lo.long(), min=0) + 1)
    return int(torch.clamp(n, min=0).sum())


def heavy_off(grid):
    """``grid`` without its heavy list (profile_chain.py:80-84)."""
    dev = grid.heavy_faces.device
    return grid._replace(
        heavy_faces=torch.full((0,), -1, dtype=torch.int32, device=dev),
        heavy_ranges=torch.zeros((0, 4), dtype=torch.int32, device=dev))


def run(cfg: RenderConfig, scene, device, n: int = N):
    """Time every line item on ``scene`` at ``cfg`` (module docstring).
    Returns ([(name, host ms, CUDA-event ms or None)] in LINE_ITEMS'
    order, the statistics dict)."""
    device = torch.device(device)
    x = bridge.scene_to_torch(scene, device)
    verts, faces = x["vertices"], x["faces"]
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)
    lp = bridge.from_numpy(LIGHT.eye, device, np.float32)
    cap = cfg.pair_capacity(scene.num_faces)
    eye, L = cc[0:3], lcc[0:3]
    H, W = cfg.screen_height, cfg.screen_width
    npx = H * W
    ext, typo = cfg.angular_extent, cfg.quirks.y_forward_dot_typo
    rows = []

    def t(name, fn, arg):
        program = Program(fn, static=())
        try:
            timing, out = chain_ms(program, arg, n=n)
        finally:
            program.clear()
        rows.append((name, timing.host_ms, timing.event_ms))
        ev = ("" if timing.event_ms is None
              else f"  (CUDA events {timing.event_ms:9.4f})")
        print(f"{name:40s} {timing.host_ms:9.4f} ms{ev}", flush=True)
        return out

    # The kernels' inputs, as the frame hands them.
    calls = record_sweeps((verts, faces, x["mat_index"], x["materials"], cc,
                           lcc[None], lp), cfg, cap)
    (k1_args, k1_kw), = calls["k1"]
    (k2_args, k2_kw), = calls["k2"]
    k3_sites = {bool(kw.get("box")): (args, kw) for args, kw in calls["k3"]}

    # What any item costs beyond its work: the program's input copy,
    # replay and output clone and the chain's dependency, on one element
    # (profile_breakdown.py's "fence roundtrip", subtracted from all).
    t("program floor (1-element op)", lambda z: z + 1,
      torch.zeros((1,), dtype=torch.float32, device=device))

    # ---------------- grid builds ----------------
    grid = t("grid build persp", lambda v: gbuild.build_perspective_grid(
        v, faces, cc, cfg=cfg, capacity=cap), verts)
    lgrid = t("grid build spherical", lambda v: gbuild.build_spherical_grid(
        v, faces, lcc, cfg=cfg, capacity=cap), verts)
    t("  persp ranges (binning)", lambda v: binning.perspective_face_ranges(
        v, faces, cc, cfg.grid_x, cfg.grid_y), verts)
    t("  sph ranges (binning)", lambda v: binning.spherical_face_ranges(
        v, faces, lcc, cfg.grid_x, cfg.grid_y, ext, ext, typo), verts)

    def expand_sort_persp(v):
        rr = binning.perspective_face_ranges(v, faces, cc, cfg.grid_x,
                                             cfg.grid_y)
        lr, *_ = gbuild._split_heavy(rr, cfg.heavy_threshold,
                                     cfg.heavy_capacity)
        z_lo, z_hi = binning.z_minmax(lr["zmin"])
        gz = binning.slab_bins(lr["zmin"], z_lo, z_hi, cfg.num_slabs)
        return gbuild._expand_and_sort(lr, gz, cfg, cap)

    t("  persp expand+sort+csr", expand_sort_persp, verts)
    # _sorted_csr sorts packed int64 (cell key << 32 | face) keys.
    t("  sort int64 [cap]", lambda k: torch.sort(k + 1, stable=True).values,
      torch.zeros((cap,), dtype=torch.int64, device=device))

    # ---------------- primary internals ----------------
    prim = t("primary full", lambda v: tprimary.trace_primary(
        v, faces, cc, grid, cfg), verts)
    grid_nh = heavy_off(grid)
    t("primary full (heavy off)", lambda v: tprimary.trace_primary(
        v, faces, cc, grid_nh, cfg), verts)
    rays_t = t("  ray dirs + tile_rays", lambda c: tprimary.tile_rays(
        primary_ray_dirs(c, W, H), cfg), cc)
    t("  pack_tri_windows", lambda v: tw.pack_tri_windows(
        v, faces, grid, eye), verts)
    tri_w, ray_rows, w_lo, w_hi = k1_args
    t_k1, f_k1 = t("  K1 primary_sweep", lambda r: primary_sweep(
        tri_w, r, w_lo, w_hi, **k1_kw), ray_rows)
    h_count, _, h_rows = k2_args
    co = theavy.heavy_coeffs(verts, faces, grid.heavy_faces,
                             grid.heavy_count, eye, grid.heavy_ranges)
    t_k2, f_k2 = t("  heavy: pack_heavy_windows + K2 1M",
                   lambda r: heavy_primary_sweep(
                       h_count, tw.pack_heavy_windows(co), r, **k2_kw),
                   h_rows)

    def merge(th):
        tc, fc = t_k1.reshape(-1), f_k1.reshape(-1)
        fh = f_k2.reshape(-1)
        th = th.reshape(-1)
        take = (th < tc) | ((th == tc) & (fh < fc))
        return torch.where(take, th, tc), torch.where(take, fh, fc)

    t("  (t, face) lex-min merge K1/K2", merge, t_k2)
    mvp = cc[48:64]

    def slab_scan(tt):
        pt = eye[None, None, :] + tt[..., None] * rays_t
        return torch.floor(transform_point(mvp, pt)[..., 2] * cfg.num_slabs)

    t("  slab-scan reprojection 1M", slab_scan,
      torch.ones(rays_t.shape[:2], dtype=torch.float32, device=device))
    fid = prim["face_id"]

    def normals(v):
        fnrm = tprimary.face_normals(v, faces)
        if cfg.quirks.abs_normal:
            fnrm = torch.abs(fnrm)
        return fnrm[torch.clamp(fid, min=0).long()]

    t("  face normals + per-pixel gather", normals, verts)

    # ---------------- shadow internals ----------------
    t("shadow full", lambda v: tshadow.trace_shadow(
        v, faces, lcc, lgrid, prim, eye, cfg), verts)
    lgrid_nh = heavy_off(lgrid)
    t("shadow full (heavy off)", lambda v: tshadow.trace_shadow(
        v, faces, lcc, lgrid_nh, prim, eye, cfg), verts)
    rays = t("  B1 shadow_rays (bin, sort, rows) 1M",
             lambda tt: shadow_rays(dict(t=tt, ray_dir=prim["ray_dir"]), eye,
                                    lcc, cfg), prim["t"])
    t("  B1 unpermute 1M", lambda flags: unpermute(flags, rays.perm),
      torch.zeros(rays.rows.shape[:2], dtype=torch.int32, device=device))
    cells = rays.scells[:npx]
    (tri_h, rows_s, hlo, hhi), kw = k3_sites[True]
    t("  K3 shadow_sweep, box site", lambda r: shadow_sweep(
        tri_h, r, hlo, hhi, **kw), rows_s)
    t("  pack_tri_windows_coeff", lambda v: tw.pack_tri_windows_coeff(
        v, faces, lgrid, L, win=SWIN), verts)
    t("  B2 shadow_tris (rows, heavy rows, ranges)", lambda v: shadow_tris(
        v, faces, lgrid, lcc, rays.first_cell, rays.last_real, cfg), verts)
    t("  B2's plain chain (shadow_tris_plain)", lambda v: shadow_tris.plain(
        v, faces, lgrid, lcc, rays.first_cell, rays.last_real, cfg), verts)
    (tri_k, rows_s, klo, khi), kw = k3_sites[False]
    t("  K3 shadow_sweep, key site", lambda r: shadow_sweep(
        tri_k, r, klo, khi, **kw), rows_s)

    # ---------------- statistics ----------------
    cells_h = bridge.to_numpy(cells)
    live = cells_h < cfg.cell_sentinel
    _, per_cell = np.unique(cells_h[live], return_counts=True)
    lc = bridge.to_numpy(lgrid.cell_count)
    stats = dict(
        faces=scene.num_faces, capacity=cap,
        persp_pairs=int(grid.total_pairs), persp_heavy=int(grid.heavy_count),
        sph_pairs=int(lgrid.total_pairs), sph_heavy=int(lgrid.heavy_count),
        primary_blocks=int(w_lo.shape[0]),
        primary_windows=window_count(w_lo, w_hi, tri_w.shape[0]),
        shadow_blocks=int(klo.shape[0]),
        shadow_windows=window_count(klo, khi, tri_k.shape[0]),
        rays=npx, rays_in_grid=int(live.sum()),
        distinct_cells=int(per_cell.size),
        max_rays_per_cell=int(per_cell.max()) if per_cell.size else 0,
        p99_rays_per_cell=(float(np.percentile(per_cell, 99))
                           if per_cell.size else 0.0),
        light_cells_occupied=int((lc > 0).sum()),
        max_tris_per_cell=int(lc.max()),
        mean_tris_per_occupied_cell=(float(lc[lc > 0].mean())
                                     if (lc > 0).any() else 0.0))
    s = stats
    print(f"  pairs persp: {s['persp_pairs']}/{cap}  heavy: "
          f"{s['persp_heavy']}", flush=True)
    print(f"  pairs sph:   {s['sph_pairs']}/{cap}  heavy: "
          f"{s['sph_heavy']}", flush=True)
    for site in ("primary", "shadow"):
        nb, nwin = s[f"{site}_blocks"], s[f"{site}_windows"]
        print(f"  {site} windows (window_span ranges; the port's "
              f"counterpart of make_windows' live items): {nwin} over {nb} "
              f"ray blocks, {nwin / nb:.2f} per block", flush=True)
    print(f"  rays in grid: {s['rays_in_grid']}/{npx}; distinct cells: "
          f"{s['distinct_cells']}; max rays/cell: {s['max_rays_per_cell']}; "
          f"p99: {s['p99_rays_per_cell']:.0f}", flush=True)
    print(f"  light-grid cells occupied: {s['light_cells_occupied']}; max "
          f"tris/cell: {s['max_tris_per_cell']}; mean(occ): "
          f"{s['mean_tris_per_occupied_cell']:.1f}", flush=True)
    return rows, stats


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    device = main_device()
    cfg = RenderConfig()
    scene = procedural.cathedral(num_faces_target=75000)
    print("faces:", scene.num_faces, "device:", card_line(), flush=True)
    rows, stats = run(cfg, scene, device)
    print(json.dumps(dict(rows=rows, stats=stats,
                          device=torch.cuda.get_device_name(device))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
