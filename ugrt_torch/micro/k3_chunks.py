"""The sweep kernels on the card: K1, K2 or K3 timed on the inputs of the
flagship frames, per chunk size, or the probes S2 and S3 on their
scripts' workloads, per variant, against another tree's kernel.

    python -m ugrt_torch.micro.k3_chunks [--kernel k1|k2|k3|s2|s3]
        [--parent DIR] [--chunks 1 2 4 8] [--out results.json]
        [--inputs saved.pt] [--seed N]

Renders one flagship frame (1024², 128x128 grid, the 75k-triangle
procedural cathedral, spot) per light-grid mode, windowed and
reference, and records the inputs of the chosen kernel: K1 (primary
sweep) and K2 (heavy primary sweep) once per frame (the primary grid
does not depend on the light-grid mode), K3 (shadow sweep) at both of
its sites (cell key and footprint box).  It adds synthetic cases: for K1
``skewed_primary_case`` (one ray block whose cells span 120 windows next
to empty ranges and two-cell blocks), for K3 ``skewed_case`` (one ray
block whose cells span hundreds of windows next to blocks with empty
ranges, and the same with every real ray occluded).  S2 (``tile_sweep``)
and S3 (``heavy_sweep_v1/v2/v3``) take their scripts' workloads
(``micro.pallas_micro``, ``micro.micro_heavy``) instead.  Then it times
the kernel on those inputs in fresh processes, one per tree: with
``--parent DIR`` (an unpacked checkout of another commit) in the order
parent, this tree, this tree, parent, so that the two kernels meet the
card in turns.  A kernel with a ``chunk`` argument is timed at every
chunk size, S2 at every variant and ``wchunk`` (8, 64), S3 at every
layout and ``mb``, others once.  Every result is held against that
tree's plain version on the same inputs (K1, K2, S2, S3 bitwise; K3
exactly).  Prints one line per site and process, with the device time of
each CUDA kernel of a call (torch.profiler) and the warp counts of the
counting builds a tree has (K1, K2, S3), and writes them all to
``--out``.
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


def capture(path, seed, kernel):
    """Record ``kernel``'s inputs on the flagship frames and save them
    with its synthetic cases (on the CPU) to ``path``; for a probe, its
    script's workload."""
    if kernel in PROBES:
        mod = importlib.import_module(f"ugrt_torch.micro.{PROBES[kernel]}")
        sites = {"script": dict(args=list(mod.make_workload("cpu")), kw={})}
        torch.save(sites, path)
        return sites

    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.scene import procedural

    camera = CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                        up=(0.0, 0.0, 1.0))
    light = CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0))
    scene = procedural.cathedral(num_faces_target=75000, seed=seed)
    _, attr, trace = KERNELS[kernel]
    tmod = importlib.import_module(f"ugrt_torch.trace.{trace}")
    sweep = getattr(tmod, attr)
    sites = {}

    for mode in ("windowed", "reference"):
        def record(*args, **kw):
            box = bool(kw.get("box"))
            name = (f"{mode} {'box' if box else 'key'}" if kernel == "k3"
                    else mode)
            sites.setdefault(name, dict(
                args=[x.cpu() for x in args],
                kw=dict(box=box) if kernel == "k3" else {}))
            return sweep(*args, **kw)

        cfg = dataclasses.replace(RenderConfig(), light_grid_mode=mode)
        setattr(tmod, attr, record)
        try:
            Renderer(scene, cfg, device="cuda").render(
                camera, [light], light.eye, use_spot=True)
        finally:
            setattr(tmod, attr, sweep)
    if kernel == "k1":
        sites["skewed"] = dict(args=list(skewed_primary_case("cpu", seed)),
                               kw={})
    if kernel == "k3":
        for name, occ in (("skewed", False), ("skewed all-occluded", True)):
            sites[name] = dict(args=list(skewed_case("cpu", seed, occ)),
                               kw=dict(box=False))
        for name, site in sites.items():
            if not site["kw"]["box"]:
                print(f"{name}: {gap_items(*site['args'])}", flush=True)
    torch.save(sites, path)
    return sites


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
    if "chunk" in inspect.signature(fn).parameters:
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
                   card=card_line(), ms={}, mismatches={})
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted({*KERNELS, *PROBES}),
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_chunks needs an NVIDIA GPU")
    inputs = str(Path(args.inputs or f"_archive/{args.kernel}_inputs.pt")
                 .resolve())
    if args.time_only:
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    bad = [r for r in records if any(r["mismatches"].values())]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
