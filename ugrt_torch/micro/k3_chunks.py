"""The sweep kernels on the card: K1, K2 or K3 timed on the inputs of the
flagship frames, per chunk size, the reflection DDA D1 on the flagship
reflective frame's rays, or the probes S2 and S3 on their scripts'
workloads, per variant, against another tree's kernel.

    python -m ugrt_torch.micro.k3_chunks [--kernel k1|k2|k3|d1|s2|s3]
        [--parent DIR] [--chunks 1 2 4 8] [--out results.json]
        [--inputs saved.pt] [--seed N] [--frames]

Renders one flagship frame (1024², 128x128 grid, the 75k-triangle
procedural cathedral, spot) per light-grid mode, windowed and reference,
and records the inputs of the chosen kernel: K1 (primary sweep) and K2
(heavy primary sweep) once per frame (the primary grid does not depend
on the light-grid mode), K3 (shadow sweep) at both of its sites (cell
key and footprint box).  It adds synthetic cases: for K1
``skewed_primary_case`` (one ray block whose cells span 120 windows next
to empty ranges and two-cell blocks), for K3 ``skewed_case`` (one ray
block whose cells span hundreds of windows next to blocks with empty
ranges, and the same with every real ray occluded) and
``reference_case`` (shaped like the reference light grid's key site: a
few cells of long ranges, most rays occluded at random rows of their
range, some never, blocks that straddle two cells).  For each of K3's
cell-key sites and cases it prints ``occluder_profile``: where each ray
meets its first occluder, through the plain version's tests.  S2
(``tile_sweep``) and S3 (``heavy_sweep_v1/v2/v3``) take their scripts'
workloads (``micro.pallas_micro``, ``micro.micro_heavy``) instead.  D1
takes the reflection rays of one flagship reflective frame (reference
mode, spot, ugrt's reflection defaults: 32^3 uniform grid, batches of 32
up to 8), in pixel order and in a seeded random order (a warp's lanes in
distinct cells), each tree given the face table as wide as its kernel
reads it and the image width where its wrapper takes one.  Then it times
the kernel on those inputs in fresh processes, one per tree: with
``--parent DIR`` (an unpacked checkout of another commit) in the order
parent, this tree, this tree, parent, so that the two kernels meet the
card in turns.  A kernel with a ``chunk`` argument is timed at every
chunk size, S2 at every variant and ``wchunk`` (8, 64), S3 at every
layout and ``mb``, others once.  Every result is held against that
tree's plain version on the same inputs (K1, K2, D1, S2, S3 bitwise; K3
exactly; K3 in both of its walks where the tree has them, its ``serial``
walk labelled so).  Prints one line per site and process, with the
device time of each CUDA kernel of a call (torch.profiler) and the
counts of the counting builds a tree has (K1, K2, K3, D1, S3), and
writes them all to ``--out``.  With ``--frames``, then, in the same
turns, each tree's flagship frame and reflective frame with the
reference light grid (``bench_reflective.run``) and ``python -m
ugrt_torch.bench --pi-extent --skip-parity``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

# K3's synthetic cases: cells of the light grid, pair rows per cell, and
# the ray blocks around the one whose cells span the whole pair array.
SKEW_CELLS = 1600
SKEW_ROWS_PER_CELL = 48        # 300 windows of 256 rows
SKEW_NORMAL_BLOCKS = 24
SKEW_EMPTY_BLOCKS = 16
SKEW_WIN = 256
# K3's reference-like case: rows of each light cell (several windows of
# 256 each), rays of each cell, occluding triangles among each cell's
# rows.
REF_ROWS = (700, 1100, 450, 1300, 900)
REF_RAYS = (1000, 1500, 700, 1300, 900)
REF_OCCLUDERS = 24
# K1's synthetic case: 1280 cells of 12 pair rows, 120 windows of 128.
PSKEW_CELLS = 1280
PSKEW_ROWS_PER_CELL = 12
PSKEW_WIN = 128

# Each kernel: (its wrapper module, the wrapper, the trace module and
# attribute the wrapper is called through on the frame path).
KERNELS = {
    "k1": ("primary_sweep", "primary_sweep", "primary"),
    "k2": ("heavy_primary_sweep", "heavy_primary_sweep", "primary"),
    "k3": ("shadow_sweep", "shadow_sweep", "shadow"),
}
# The probes: the micro module whose workload they take.
PROBES = {"s2": "pallas_micro", "s3": "micro_heavy"}


def _blocks(rng, n_cells, normal_cells):
    """The synthetic cases' ray blocks, as their sorted cells [128] or
    None (empty): one block with 128 distinct cells spread over all
    ``n_cells`` between two empty ones, normal blocks (``normal_cells``
    of them), more empty blocks, then the rest of the normal blocks."""
    normal = [normal_cells(c) for c in
              rng.integers(0, n_cells - 3, SKEW_NORMAL_BLOCKS)]
    blocks = [None, np.sort(rng.choice(n_cells, 128, replace=False)), None]
    blocks += normal[:SKEW_NORMAL_BLOCKS // 2]
    blocks += [None] * (SKEW_EMPTY_BLOCKS - 2)
    blocks += normal[SKEW_NORMAL_BLOCKS // 2:]
    return blocks


def _ranges(blocks, rows_per_cell, win, nw):
    """Each block's inclusive window range: its cells' pair span, empty
    ranges of both kinds (w_lo past the end, w_lo 0) for empty blocks, and
    the last block's range running past the last window."""
    nb = len(blocks)
    w_lo = np.zeros(nb, np.int32)
    w_hi = np.full(nb, -1, np.int32)
    for b, cells in enumerate(blocks):
        if cells is None:
            w_lo[b] = nw if b % 2 else 0
            continue
        lo = cells[0] * rows_per_cell
        hi = (cells[-1] + 1) * rows_per_cell
        w_lo[b], w_hi[b] = lo // win, (hi - 1) // win
    w_hi[-1] = nw + 5                           # clamped to the last window
    return w_lo, w_hi


def _to(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def skewed_case(device, seed=0, all_occluded=False):
    """(tri [NW, 256, 16], rays [NB, 128, 8], w_lo, w_hi) for K3's
    cell-key site, from numpy ``seed``.

    Each of SKEW_CELLS cells holds SKEW_ROWS_PER_CELL random coefficient
    rows, sorted by cell as the light grid's pair array.  Ray block 1
    holds 128 rays in 128 distinct cells spread over all cells, so its
    window range is the whole array while it needs a few rows of each
    window; it sits between blocks with empty ranges (sentinel rays,
    w_hi < w_lo, as ``windows.window_span`` and
    ``heavy_block_window_range`` mark them), one block whose range runs
    past the last window, and blocks of one to three cells.  With
    ``all_occluded`` every ray points along +z and each cell's first row
    occludes it, so every item can stop early."""
    rng = np.random.default_rng(seed)
    n_rows = SKEW_CELLS * SKEW_ROWS_PER_CELL
    tri = np.zeros((n_rows, 16), np.float32)
    tri[:, 0:3] = rng.standard_normal((n_rows, 3))
    tri[:, 3:9] = rng.standard_normal((n_rows, 6)) * 2
    tri[:, 9] = rng.standard_normal(n_rows) * 4
    tri[:, 10] = np.repeat(np.arange(SKEW_CELLS), SKEW_ROWS_PER_CELL)
    tri[:, 11:15] = (1.0, 0.0, 1.0, 0.0)        # empty footprint box
    if all_occluded:
        first = np.arange(SKEW_CELLS) * SKEW_ROWS_PER_CELL
        # det = 1, u = v = 0.25, t = 1 for a ray along +z.
        tri[first, 0:10] = (0, 0, 1, 0, 0, 0.25, 0, 0, 0.25, 1)
    tri = tri.reshape(-1, SKEW_WIN, 16)
    nw = tri.shape[0]

    blocks = _blocks(rng, SKEW_CELLS,
                     lambda c: np.sort(rng.integers(c, c + 3, 128)))
    nb = len(blocks)
    rays = np.zeros((nb, 128, 8), np.float32)
    dirs = rng.standard_normal((nb, 128, 3))
    if all_occluded:
        dirs[:] = (0.0, 0.0, 1.0)
    rays[:, :, 0:3] = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays[:, :, 3] = rng.uniform(1.0, 10.0, (nb, 128))
    for b, cells in enumerate(blocks):
        rays[b, :, 4] = -1.0 if cells is None else cells
    w_lo, w_hi = _ranges(blocks, SKEW_ROWS_PER_CELL, SKEW_WIN, nw)
    return _to(device, tri, rays, w_lo, w_hi)


def reference_case(device, seed=0):
    """(tri [NW, 256, 16], rays [NB, 128, 8], w_lo, w_hi) shaped like K3's
    cell-key site under the reference light grid, from numpy ``seed``.

    REF_CELLS cells hold long runs of rows (REF_ROWS, several windows of
    256 each), sorted by cell as the light grid's pair array, the last
    window padded with never-admitted rows (key -1, zero coefficients);
    the rays of each cell (REF_RAYS) fill consecutive 128-ray blocks, so
    some blocks straddle two cells, and sentinel rays (cell -1, an empty
    range) fill the last block.  A ray is a pixel (X, Y) of its cell's
    scanline grid, direction (X, Y, 1) normalized, 3 to 10 from its
    point.  Each cell's rows are random triangles whose t lies far past
    every point (they never occlude, but some pass the u and v tests),
    and among them, at random rows, REF_OCCLUDERS triangles of the plane
    z = 1 over random parts of the (X, Y) grid: det = d_z, u = s (X - x0),
    v = s (Y - y0), t = 1 / d_z.  So most rays are occluded at random rows
    of their range, neighbouring rays often by the same row, and some
    (about one in ten) by none."""
    rng = np.random.default_rng(seed)
    starts = np.concatenate([[0], np.cumsum(REF_ROWS)])
    n_rows = int(starts[-1])
    tri = np.zeros((-(-n_rows // SKEW_WIN) * SKEW_WIN, 16), np.float32)
    tri[:, 10] = -1.0                            # padding: no ray admits it
    tri[:, 11:15] = (1.0, 0.0, 1.0, 0.0)         # empty footprint box
    tri[:n_rows, 0:9] = rng.standard_normal((n_rows, 9))
    tri[:n_rows, 9] = rng.choice([-1.0, 1.0], n_rows) * 1e4
    side = int(np.ceil(np.sqrt(max(REF_RAYS))))
    for cell, (r0, r1) in enumerate(zip(starts[:-1], starts[1:])):
        tri[r0:r1, 10] = cell
        rows = rng.choice(np.arange(r0, r1), REF_OCCLUDERS, replace=False)
        x0 = rng.uniform(-1.2, 1.0, REF_OCCLUDERS)
        y0 = rng.uniform(-1.2, 1.0, REF_OCCLUDERS)
        s = 1.0 / rng.uniform(0.5, 1.3, REF_OCCLUDERS)    # legs 1 / s
        tri[rows, 0:10] = np.stack(
            [np.zeros_like(s), np.zeros_like(s), np.ones_like(s),
             s, np.zeros_like(s), -s * x0,
             np.zeros_like(s), s, -s * y0, np.ones_like(s)], axis=1)
    tri = tri.reshape(-1, SKEW_WIN, 16)
    nw = tri.shape[0]

    n_real = sum(REF_RAYS)
    nb = -(-(n_real + 1) // 128)
    rays = np.zeros((nb * 128, 8), np.float32)
    rays[:, 4] = -1.0
    rays[:, 0:3] = (0.0, 0.0, 1.0)
    cells = np.full(nb * 128, -1)
    at = 0
    for cell, n in enumerate(REF_RAYS):
        i = np.arange(n)
        # The cell's pixels in scanline order over [-1, 1]^2.
        xy = np.stack([i % side, i // side], 1) / (side - 1) * 2 - 1
        d = np.concatenate([xy, np.ones((n, 1))], 1)
        rays[at:at + n, 0:3] = d / np.linalg.norm(d, axis=1, keepdims=True)
        rays[at:at + n, 4] = cell
        cells[at:at + n] = cell
        at += n
    rays[:, 3] = rng.uniform(3.0, 10.0, nb * 128)
    blk = cells.reshape(nb, 128)
    last = np.where(blk >= 0, blk, -1).max(axis=1)
    live = last >= 0
    lo = np.where(live, starts[np.clip(blk[:, 0], 0, None)], 0)
    hi = np.where(live, starts[np.clip(last, 0, None) + 1], 0)
    w_lo = lo // SKEW_WIN
    w_hi = np.where(hi > lo, (hi - 1) // SKEW_WIN, w_lo - 1)
    return _to(device, tri, rays.reshape(nb, 128, 8),
               w_lo.astype(np.int32), w_hi.astype(np.int32))


def skewed_primary_case(device, seed=0):
    """(tri [NW, 128, 16], rays [NB, 128, 8], w_lo, w_hi) for K1, from
    numpy ``seed``.

    Each of PSKEW_CELLS cells holds PSKEW_ROWS_PER_CELL direct-form rows
    (tvec = -v0 for rays from the origin, e1, e2, cell key, face id),
    sorted by cell as the perspective grid's pair array: triangles about
    the cell's direction at distances 2-10, so that the cell's rays hit
    some of them.  Face ids are a random permutation, and each cell's
    last row repeats its first row's triangle, so equal t with different
    faces occur, some across a window boundary (two work items).  The
    ray blocks are those of ``skewed_case``: ray block 1 holds 128 rays
    in 128 distinct cells spread over all cells (a range of all 120
    windows, 32 cells per warp), between blocks with empty ranges; the
    others are two-cell blocks as on the frame path (one cell per 64-ray
    tile, so a warp's rays share one cell), and the last block's range
    runs past the last window."""
    rng = np.random.default_rng(seed)
    n_rows = PSKEW_CELLS * PSKEW_ROWS_PER_CELL
    cell_dir = rng.standard_normal((PSKEW_CELLS, 3)) * (0.4, 0.4, 0.2)
    cell_dir[:, 2] += 1.0
    cell_dir /= np.linalg.norm(cell_dir, axis=1, keepdims=True)
    row_cell = np.repeat(np.arange(PSKEW_CELLS), PSKEW_ROWS_PER_CELL)
    centre = cell_dir[row_cell] * rng.uniform(2.0, 10.0, (n_rows, 1))
    e1 = rng.standard_normal((n_rows, 3))
    e2 = rng.standard_normal((n_rows, 3))
    tri = np.zeros((n_rows, 16), np.float32)
    tri[:, 0:3] = (e1 + e2) / 3 - centre        # tvec = origin - v0
    tri[:, 3:6] = e1
    tri[:, 6:9] = e2
    tri[:, 9] = row_cell
    tri[:, 10] = rng.permutation(n_rows)
    first = np.arange(PSKEW_CELLS) * PSKEW_ROWS_PER_CELL
    tri[first + PSKEW_ROWS_PER_CELL - 1, 0:9] = tri[first, 0:9]
    tri = tri.reshape(-1, PSKEW_WIN, 16)
    nw = tri.shape[0]

    blocks = _blocks(rng, PSKEW_CELLS,
                     lambda c: np.repeat([c, c + 1], 64))
    nb = len(blocks)
    rays = np.zeros((nb, 128, 8), np.float32)
    for b, cells in enumerate(blocks):
        if cells is None:
            rays[b, :, 0:3] = rng.standard_normal((128, 3))
            rays[b, :, 3] = -1.0
            continue
        rays[b, :, 0:3] = (cell_dir[cells]
                           + rng.standard_normal((128, 3)) * 0.05)
        rays[b, :, 3] = cells
    rays[:, :, 0:3] /= np.linalg.norm(rays[:, :, 0:3], axis=-1,
                                      keepdims=True)
    w_lo, w_hi = _ranges(blocks, PSKEW_ROWS_PER_CELL, PSKEW_WIN, nw)
    return _to(device, tri, rays, w_lo, w_hi)


def flagship_frame(seed):
    """(scene, the frame bodies' tensor arguments on the card): the
    flagship 75k-triangle procedural cathedral from ``seed``, bench.py's
    camera and light (aspect 1)."""
    from ugrt_torch import bridge
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.scene import procedural

    camera = CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                        up=(0.0, 0.0, 1.0))
    light = CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0))
    scene = procedural.cathedral(num_faces_target=75000, seed=seed)
    fovy = RenderConfig().fovy_deg
    t = bridge.scene_to_torch(scene, "cuda")
    return scene, (
        t["vertices"], t["faces"], t["mat_index"], t["materials"],
        bridge.camcoords_to_torch(camera, fovy, 1.0, "cuda"),
        bridge.camcoords_to_torch(light, fovy, 1.0, "cuda")[None],
        bridge.from_numpy(light.eye, "cuda", np.float32))


def record_sweeps(frame_args, cfg, capacity: int, kernels=tuple(KERNELS)):
    """{kernel: [(args, kwargs) of each call]} of the sweep wrappers
    ``kernels`` (keys of KERNELS) in one eager frame of ``cfg`` (spot,
    one light; ``render_frame``, the body of Renderer.render's program:
    a capture cannot copy its inputs out), each argument a copy.  Each
    wrapper is replaced in its trace module for the frame's length."""
    from ugrt_torch.api.renderer import render_frame

    seen = {k: [] for k in kernels}
    saved = []

    def recorder(kernel, sweep):
        def record(*args, **kw):
            seen[kernel].append(([x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in args], kw))
            return sweep(*args, **kw)
        return record

    try:
        for kernel in kernels:
            _, attr, trace = KERNELS[kernel]
            tmod = importlib.import_module(f"ugrt_torch.trace.{trace}")
            saved.append((tmod, attr, getattr(tmod, attr)))
            setattr(tmod, attr, recorder(kernel, getattr(tmod, attr)))
        render_frame(*frame_args, cfg=cfg, capacity=capacity, num_lights=1,
                     use_spot=True)
    finally:
        for tmod, attr, sweep in reversed(saved):
            setattr(tmod, attr, sweep)
    return seen


def capture(path, seed, kernel):
    """Record ``kernel``'s inputs on the flagship frames and save them
    with its synthetic cases (on the CPU) to ``path``; for a probe, its
    script's workload."""
    if kernel in PROBES:
        mod = importlib.import_module(f"ugrt_torch.micro.{PROBES[kernel]}")
        sites = {"script": dict(args=list(mod.make_workload("cpu")), kw={})}
        torch.save(sites, path)
        return sites
    if kernel == "d1":
        sites = capture_dda(seed)
        torch.save(sites, path)
        return sites

    from ugrt_torch.config import RenderConfig

    scene, frame_args = flagship_frame(seed)
    sites = {}
    for mode in ("windowed", "reference"):
        cfg = dataclasses.replace(RenderConfig(), light_grid_mode=mode)
        calls = record_sweeps(frame_args, cfg,
                              cfg.pair_capacity(scene.num_faces), (kernel,))
        for args, kw in calls[kernel]:
            box = bool(kw.get("box"))
            name = (f"{mode} {'box' if box else 'key'}" if kernel == "k3"
                    else mode)
            sites.setdefault(name, dict(
                args=[x.cpu() for x in args],
                kw=dict(box=box) if kernel == "k3" else {},
                serial=bool(kw.get("serial"))))
    if kernel == "k1":
        sites["skewed"] = dict(args=list(skewed_primary_case("cpu", seed)),
                               kw={})
    if kernel == "k3":
        for name, occ in (("skewed", False), ("skewed all-occluded", True)):
            sites[name] = dict(args=list(skewed_case("cpu", seed, occ)),
                               kw=dict(box=False), serial=False)
        sites["reference-like"] = dict(args=list(reference_case("cpu", seed)),
                                       kw=dict(box=False), serial=True)
        cfg = RenderConfig()
        for name, site in sites.items():
            if not site["kw"]["box"]:
                print(f"{name}: {gap_items(*site['args'])}", flush=True)
            prof = occluder_profile(*(x.cuda() for x in site["args"]),
                                    cfg, box=site["kw"]["box"])
            print(f"{name}: occluders {json.dumps(prof)}", flush=True)
    torch.save(sites, path)
    return sites


def capture_dda(seed):
    """D1's sites: the arguments of its one call in a flagship reflective
    frame (reference mode, spot), on the CPU, the grid as a dict of its
    fields, in pixel order ("flagship reference") and shuffled by numpy
    ``seed`` ("flagship shuffled")."""
    from ugrt_torch.api.renderer import render_frame_reflective
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.trace import reflect as treflect

    scene, frame_args = flagship_frame(seed)
    cfg = RenderConfig()
    seen = []
    dda = treflect.uniform_dda

    def record(*args, **kw):
        seen.append((args, kw))
        return dda(*args, **kw)

    treflect.uniform_dda = record
    try:
        render_frame_reflective.fn(
            *frame_args, cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
            num_lights=1, use_spot=True)
    finally:
        treflect.uniform_dda = dda
    (args, kw), = seen
    ftab, grid, *rays = (x.cpu() if isinstance(x, torch.Tensor) else x
                         for x in args[:8])
    grid = {f: getattr(grid, f).cpu() for f in grid._fields}
    kw = {k: v for k, v in kw.items() if k != "cfg"}
    pick = torch.from_numpy(np.random.default_rng(seed).permutation(
        rays[0].shape[0]))
    shuffled = [x[pick].contiguous() for x in rays[:4]] + rays[4:]
    return {name: dict(args=[ftab, grid, *r], dims=tuple(args[8]), kw=kw)
            for name, r in (("flagship reference", rays),
                            ("flagship shuffled", shuffled))}


def time_dda(path, iters):
    """Time this process's D1 (whichever tree is on the path) on the saved
    sites; one record per site."""
    from ugrt_torch.grid.build import DeviceGrid
    from ugrt_torch.kernels import uniform_dda as kdda
    from ugrt_torch.micro._common import card_line, compare, cuda_ms

    cfg = types.SimpleNamespace(epsilon=1e-21)
    cols = getattr(kdda, "FACE_COLS", 9)
    wide = "width" in inspect.signature(kdda.uniform_dda).parameters
    records = []
    for name, site in torch.load(path).items():
        ftab, grid, *rays = site["args"]
        args = [ftab[:, :cols].contiguous().cuda(),
                DeviceGrid(**{f: v.cuda() for f, v in grid.items()}),
                *(x.cuda() for x in rays), site["dims"]]
        kw = dict(site["kw"], cfg=cfg)
        if not wide:
            kw.pop("width", None)
        want = kdda.uniform_dda_plain(*args, **kw)

        def run():
            return kdda.uniform_dda(*args, **kw)

        got = run()
        keys = ("t", "face_id", "overflow")
        mism, _ = compare(tuple(got[k] for k in keys),
                          tuple(want[k] for k in keys))
        rec = dict(site=name, kernel="d1", tree=os.getcwd(),
                   card=card_line(), hits=int((want["face_id"] >= 0).sum()),
                   mismatches={"wrapper": mism},
                   ms={"wrapper": cuda_ms(run, iters)},
                   device_ms={"wrapper": device_ms(run)},
                   stats={"wrapper": kdda.uniform_dda_stats(*args, **kw)})
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def gap_items(tri, rays, w_lo, w_hi):
    """How many of a cell-key sweep's (ray block, window) items hold no
    row of any cell of the block's rays (a window's cells lie between its
    least and greatest key), and so could be skipped."""
    from ugrt_torch.kernels._plain import chunk_item_end, chunk_windows

    nw = tri.shape[0]
    blk, w, _ = chunk_windows(chunk_item_end(w_lo, w_hi, nw, 1), w_lo, w_hi,
                              nw, 1)
    keys = tri[..., 10]
    cells = torch.sort(rays[..., 4], dim=1).values[blk].contiguous()
    lo = torch.searchsorted(cells, keys.amin(1)[w, None].contiguous())
    hi = torch.searchsorted(cells, keys.amax(1)[w, None].contiguous(),
                            right=True)
    gap = int((hi <= lo).sum())
    return f"{gap} of {blk.shape[0]} items hold no row of the block's cells"


def occluder_profile(tri, rays, w_lo, w_hi, cfg, box=False, group=32):
    """Where each ray of a K3 site meets its first occluder, through the
    plain version's tests (``shadow_sweep.occludes``) on the site's own
    inputs: a dict of the rays with a cell, those shadowed and those no
    row occludes; the tests they admit; the tests left if every ray
    stopped at its first occluder; the tests the OR needs (every
    admitted test of a ray no row occludes, one of each shadowed ray); the first occluder's row in the ray's
    walk (rows from the start of its block's range) and its rank among
    the ray's admitted rows, as percentiles; the blocks whose every
    shadowed-or-not ray is settled in the first window (all occluded
    there); and how often a shadowed ray is also occluded in the
    ``group``-row group (aligned in its window) that first occluded the
    ray before it in its warp, or the last shadowed ray before it."""
    from ugrt_torch.kernels._plain import window_runs
    from ugrt_torch.kernels.shadow_sweep import occludes

    dev = rays.device
    nb, nw, win = rays.shape[0], tri.shape[0], tri.shape[1]
    lo = torch.clamp(w_lo.long(), min=0)
    n = torch.clamp(torch.clamp(w_hi.long(), max=nw - 1) - lo + 1, min=0)
    blocks = torch.arange(nb, device=dev)
    pair_blk = torch.repeat_interleave(blocks, n)
    pair_w = (torch.repeat_interleave(lo - (torch.cumsum(n, 0) - n), n)
              + torch.arange(pair_blk.shape[0], device=dev))
    q = torch.arange(win, device=dev)
    n_adm, first_q, adm_before, gmask = [], [], [], []
    bits = 1 << torch.arange(win // group, device=dev)
    for blk, t in window_runs(tri, blocks, lo, n):
        ray = rays[blk]
        occ = occludes(ray, t, cfg=cfg, box=box)
        if box:
            gx, gy = ray[:, :, 5, None], ray[:, :, 6, None]
            adm = ((gx >= t[:, None, :, 11]) & (gx <= t[:, None, :, 12])
                   & (gy >= t[:, None, :, 13]) & (gy <= t[:, None, :, 14]))
        else:
            adm = t[:, None, :, 10] == ray[:, :, 4, None]
        fq = torch.where(occ, q, win).amin(dim=2)
        n_adm.append(adm.sum(dim=2))
        first_q.append(fq)
        adm_before.append((adm & (q < fq[..., None])).sum(dim=2))
        g = occ.reshape(*occ.shape[:2], -1, group).any(dim=3)
        gmask.append((g.long() * bits).sum(dim=2))
    n_adm, first_q, adm_before, gmask = (torch.cat(x) for x in (
        n_adm, first_q, adm_before, gmask))
    npair = pair_blk.shape[0]
    # Per ray: its admitted rows, its first occluding pair (npair: none)
    # and the admitted rows of its block's pairs before that pair.
    total = torch.zeros((nb, 128), dtype=torch.long, device=dev)
    total.index_add_(0, pair_blk, n_adm.long())
    pidx = torch.arange(npair, device=dev)[:, None].expand(-1, 128)
    first = torch.full((nb, 128), npair, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, pair_blk[:, None].expand(-1, 128),
                          torch.where(first_q < win, pidx, npair), "amin")
    before = torch.cumsum(n_adm.long(), 0) - n_adm.long()
    start = (torch.cumsum(n, 0) - n).clamp(max=max(npair - 1, 0))
    live = rays[:, :, 4] >= 0
    shadowed = live & (first < npair)
    lane = torch.arange(128, device=dev).expand(nb, -1)
    f = first.clamp(max=max(npair - 1, 0))
    fq = first_q[f, lane].long()
    rank = before[f, lane] - before[start] + adm_before[f, lane]
    row = (pair_w[f] - lo[:, None]) * win + fq
    stop_tests = int(torch.where(shadowed, rank + 1, total)[live].sum())

    def pct(x):
        if not x.numel():
            return {}
        x = x.double()
        return {p: round(float(torch.quantile(x, p / 100)), 3)
                for p in (10, 25, 50, 75, 90, 99)}

    # The group that first occluded the ray before each one in its warp
    # (lanes 32k .. 32k + 31 of a block), and that of the last shadowed
    # ray before it.
    gid = f * (win // group) + fq // group
    w_sh = shadowed.reshape(-1, 32)
    idx = torch.arange(32, device=dev).expand(w_sh.shape[0], -1)
    last = torch.cummax(torch.where(w_sh, idx, -1), dim=1).values
    last = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)

    def hint_rate(src):                      # src: [warps, 32] lane or -1
        ok = w_sh & (src >= 0)
        s = src.clamp(min=0)
        g = torch.gather(gid.reshape(-1, 32), 1, s)
        p_ = g // (win // group)
        bit = g % (win // group)
        lanes = torch.arange(128, device=dev).reshape(4, 32).repeat(nb, 1)
        m = gmask[p_.clamp(max=max(npair - 1, 0)), lanes]
        hit = ((m >> bit) & 1).bool() & ok
        return int(hit.sum()), int(ok.sum())

    prev = idx - 1
    prev = torch.where(torch.gather(w_sh, 1, prev.clamp(min=0)) & (prev >= 0),
                       prev, -1)
    h_prev, n_prev = hint_rate(prev)
    h_last, n_last = hint_rate(last)
    blk_live = live.any(dim=1)
    settled = (~live | (shadowed & (first == start[:, None]))).all(dim=1)
    return dict(
        rays=int(live.sum()), shadowed=int(shadowed.sum()),
        never_occluded=int((live & ~shadowed).sum()),
        admitted_tests=int(total[live].sum()), stop_at_first_tests=stop_tests,
        needed_tests=int(torch.where(shadowed, 1, total)[live].sum()),
        first_occluder_walk_row=pct(row[shadowed]),
        first_occluder_admitted_rank=pct(rank[shadowed]),
        first_occluder_share_of_admitted=pct(
            (rank + 1)[shadowed].double() / total[shadowed].double()),
        walk_rows=pct(((n * win)[:, None].expand(-1, 128))[live]),
        blocks=int(blk_live.sum()),
        blocks_occluded_in_first_window=int((settled & blk_live).sum()),
        same_group_as_previous_lane=[h_prev, n_prev],
        same_group_as_last_shadowed=[h_last, n_last])


def device_ms(fn, iters=5):
    """{CUDA kernel: mean device ms per fn() call} under torch.profiler:
    the wrapper's kernel apart from its small torch ops."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def _calls(kernel, chunks):
    """[(label, wrapper, its kwargs, plain, plain's kwargs, counting build
    or None)] of ``kernel`` in this process's tree, one per configuration
    timed."""
    if kernel == "s2":
        from ugrt_torch.kernels import tile_pipeline as tp

        return [(f"{v} wchunk={w}", tp.tile_sweep, dict(variant=v, wchunk=w),
                 tp.tile_sweep_plain, dict(variant=v), None)
                for v in tp.VARIANTS for w in (8, 64)]
    if kernel == "s3":
        from ugrt_torch.kernels import heavy_variants as hv
        from ugrt_torch.kernels.heavy_primary_sweep import (
            heavy_primary_sweep_plain)

        stats = getattr(hv, "heavy_sweep_stats", None)
        return [(f"{v} mb={mb}", getattr(hv, f"heavy_sweep_{v}"),
                 dict(mb=mb), heavy_primary_sweep_plain, {},
                 stats and functools.partial(stats, v))
                for v in ("v1", "v2", "v3") for mb in hv.MBS]
    module, attr, _ = KERNELS[kernel]
    mod = importlib.import_module(f"ugrt_torch.kernels.{module}")
    fn, plain = getattr(mod, attr), getattr(mod, f"{attr}_plain")
    stats = getattr(mod, f"{attr}_stats", None)
    params = inspect.signature(fn).parameters
    if "serial" in params:
        # K3's two walks, each at every chunk size.
        return [(f"{c}{' serial' if s else ''}", fn, dict(chunk=c, serial=s),
                 plain, {}, stats) for s in (False, True) for c in chunks]
    if "chunk" in params:
        return [(str(c), fn, dict(chunk=c), plain, {}, stats) for c in chunks]
    return [("None", fn, {}, plain, {}, stats)]


def time_sites(path, kernel, chunks, iters):
    """Time this process's wrapper of ``kernel`` (whichever tree is on the
    path) on the saved inputs; one record per site."""
    from ugrt_torch.micro._common import card_line, compare, cuda_ms

    # Any object with these fields is a config to either tree's wrapper.
    cfg = types.SimpleNamespace(
        epsilon=1e-21, shadow_epsilon=1e-3,
        quirks=types.SimpleNamespace(shadow_accept_negative_t=True,
                                     abs_t=True))
    calls = _calls(kernel, chunks)
    records = []
    for name, site in torch.load(path).items():
        args = [x.cuda() for x in site["args"]]
        kw = dict(site["kw"], **({} if kernel == "s2" else dict(cfg=cfg)))
        rec = dict(site=name, kernel=kernel, tree=os.getcwd(),
                   card=card_line(), ms={}, mismatches={},
                   frame_walk="serial" if site.get("serial") else "block")
        wants = {}
        for label, fn, fkw, plain, pkw, stats in calls:
            key = tuple(sorted(pkw.items()))
            if key not in wants:
                want = plain(*args, **kw, **pkw)
                wants[key] = want if isinstance(want, tuple) else (want,)
            want = wants[key]
            if kernel == "k3":
                rec["occluded"] = int(want[0].sum())
            elif kernel != "s2":
                rec["hits"] = int((want[0] < 3e38).sum())
            ck = dict(kw, **fkw)
            got = fn(*args, **ck)
            mism, _ = compare(got if isinstance(got, tuple) else (got,), want)
            rec["mismatches"][label] = mism
            rec["ms"][label] = cuda_ms(lambda: fn(*args, **ck), iters)
            rec.setdefault("device_ms", {})[label] = device_ms(
                lambda: fn(*args, **ck))
            if stats is not None:
                rec.setdefault("stats", {})[label] = stats(*args, **ck)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def time_frames(iters):
    """This process's tree (whichever is on the path): the flagship frame
    and reflective frame with the reference light grid
    (``bench_reflective.run``, both replays chained), as one JSON line."""
    import tempfile

    from ugrt_torch.config import RenderConfig
    from ugrt_torch.micro import bench_reflective
    from ugrt_torch.micro._common import card_line
    from ugrt_torch.scene import procedural

    cfg = dataclasses.replace(RenderConfig(), light_grid_mode="reference")
    scene = procedural.cathedral(num_faces_target=75000)
    with tempfile.TemporaryDirectory() as d:
        res = bench_reflective.run(cfg, scene, torch.device("cuda"),
                                   out_path=os.path.join(d, "frame.png"),
                                   iters=iters)
    print(json.dumps(dict(
        tree=os.getcwd(), card=card_line(), overflow=res["overflow"],
        reference_frame_ms=res["base_ms"],
        reference_frame_ms_events=res["base_ms_events"],
        reflective_frame_ms=res["reflective_ms"],
        reflective_frame_ms_events=res["reflective_ms_events"])), flush=True)


def frames_in_turns(trees, here):
    """Each tree's reference and reflective frames (``time_frames``) and
    ``python -m ugrt_torch.bench --pi-extent --skip-parity``, in fresh
    processes in the order of ``trees``; one record per tree."""
    records = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree))
        rec = {}
        for argv in ([str(Path(__file__).resolve()), "--time-frames"],
                     ["-m", "ugrt_torch.bench", "--pi-extent",
                      "--skip-parity"]):
            proc = subprocess.run([sys.executable, *argv], cwd=tree, env=env,
                                  capture_output=True, text=True,
                                  check=False)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                raise SystemExit(f"{' '.join(argv)} in {tree} failed "
                                 f"({proc.returncode})")
            last = json.loads(proc.stdout.strip().splitlines()[-1])
            if "detail" in last:
                rec.update(pi_extent_step_ms=last["detail"]["step_ms_chained"],
                           pi_extent_step_ms_events=last["detail"][
                               "step_ms_chained_events"])
            else:
                rec.update(last)
        rec["tree"] = "parent" if tree != here else "this"
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted({*KERNELS, *PROBES, "d1"}),
                    default="k3")
    ap.add_argument("--parent", help="root of another tree to time beside "
                    "this one")
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--inputs", help="where the captured inputs are saved, "
                    "in a directory .gitignore lists (default "
                    "_archive/<kernel>_inputs.pt)")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-only", action="store_true",
                    help="time the saved inputs in this process and stop")
    ap.add_argument("--frames", action="store_true",
                    help="also time each tree's reference and reflective "
                    "frames and bench --pi-extent, in the same turns")
    ap.add_argument("--time-frames", action="store_true",
                    help="time the frames in this process and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_chunks needs an NVIDIA GPU")
    if args.time_frames:
        time_frames(10)
        return 0
    inputs = str(Path(args.inputs or f"_archive/{args.kernel}_inputs.pt")
                 .resolve())
    if args.time_only:
        if args.kernel == "d1":
            time_dda(inputs, args.iters)
        else:
            time_sites(inputs, args.kernel, args.chunks, args.iters)
        return 0

    here = Path(__file__).resolve().parents[2]
    Path(inputs).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    capture(inputs, args.seed, args.kernel)
    print(f"captured in {time.perf_counter() - t0:.1f} s", flush=True)
    trees = [here] if args.parent is None else [
        Path(args.parent).resolve(), here, here, Path(args.parent).resolve()]
    records = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-only",
             "--kernel", args.kernel, "--inputs", inputs, "--iters",
             str(args.iters), "--chunks", *map(str, args.chunks)],
            cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
            capture_output=True, text=True, check=False)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"timing in {tree} failed ({proc.returncode})")
        for line in proc.stdout.splitlines():
            rec = json.loads(line)
            rec["tree"] = "parent" if tree != here else "this"
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.frames:
        records += frames_in_turns(trees, here)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    bad = [r for r in records if any(r.get("mismatches", {}).values())
           or r.get("overflow")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
