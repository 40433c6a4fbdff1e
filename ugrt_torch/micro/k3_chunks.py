"""K3's work split on the card: the shadow sweep timed on the inputs of
the flagship frames, per chunk size, against another tree's K3.

    python -m ugrt_torch.micro.k3_chunks [--parent DIR] [--chunks 1 2 4 8]
        [--out results.json] [--inputs saved.pt] [--seed N]

Renders one flagship frame (1024², 128x128 grid, the 75k-triangle
procedural cathedral, spot) per light-grid mode, windowed and
reference, records the inputs of K3 at both of its sites (cell key and
footprint box), adds two synthetic cases (``skewed_case``: one ray block
whose cells span hundreds of windows next to blocks with empty ranges,
and the same with every real ray occluded), and saves them.  Then it
times ``shadow_sweep`` on those inputs in fresh processes, one per
tree: with ``--parent DIR`` (an unpacked checkout of another commit) in
the order parent, this tree, this tree, parent, so that the two kernels
meet the card in turns.  This tree's kernel is timed at every chunk
size; a kernel without the ``chunk`` argument once.  Every result is
held against that tree's ``shadow_sweep_plain`` on the same inputs.
Prints one line per site and process and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
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

# The synthetic cases: cells of the light grid, pair rows per cell, and
# the ray blocks around the one whose cells span the whole pair array.
SKEW_CELLS = 1600
SKEW_ROWS_PER_CELL = 48        # 300 windows of 256 rows
SKEW_NORMAL_BLOCKS = 24
SKEW_EMPTY_BLOCKS = 16
SKEW_WIN = 256


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

    blocks = []                                 # (cells [128] or None)
    normal = [np.sort(rng.integers(c, c + 3, 128)) for c in
              rng.integers(0, SKEW_CELLS - 3, SKEW_NORMAL_BLOCKS)]
    blocks += [None, np.sort(rng.choice(SKEW_CELLS, 128, replace=False)),
               None]
    blocks += normal[:SKEW_NORMAL_BLOCKS // 2]
    blocks += [None] * (SKEW_EMPTY_BLOCKS - 2)
    blocks += normal[SKEW_NORMAL_BLOCKS // 2:]
    nb = len(blocks)
    rays = np.zeros((nb, 128, 8), np.float32)
    dirs = rng.standard_normal((nb, 128, 3))
    if all_occluded:
        dirs[:] = (0.0, 0.0, 1.0)
    rays[:, :, 0:3] = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays[:, :, 3] = rng.uniform(1.0, 10.0, (nb, 128))
    w_lo = np.zeros(nb, np.int32)
    w_hi = np.full(nb, -1, np.int32)
    for b, cells in enumerate(blocks):
        if cells is None:
            rays[b, :, 4] = -1.0
            w_lo[b] = nw if b % 2 else 0        # both kinds of empty range
            continue
        rays[b, :, 4] = cells
        lo = cells[0] * SKEW_ROWS_PER_CELL
        hi = (cells[-1] + 1) * SKEW_ROWS_PER_CELL
        w_lo[b], w_hi[b] = lo // SKEW_WIN, (hi - 1) // SKEW_WIN
    w_hi[-1] = nw + 5                           # clamped to the last window
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (tri, rays, w_lo, w_hi))


def capture(path, seed):
    """Record K3's inputs on the flagship frames and save them with the
    synthetic cases (on the CPU) to ``path``."""
    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.scene import procedural
    from ugrt_torch.trace import shadow as tshadow

    camera = CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                        up=(0.0, 0.0, 1.0))
    light = CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0))
    scene = procedural.cathedral(num_faces_target=75000, seed=seed)
    sites = {}
    sweep = tshadow.shadow_sweep

    for mode in ("windowed", "reference"):
        def record(tri, rays, w_lo, w_hi, *, cfg, box=False, **kw):
            name = f"{mode} {'box' if box else 'key'}"
            sites.setdefault(name, dict(args=[x.cpu() for x in (
                tri, rays, w_lo, w_hi)], box=box))
            return sweep(tri, rays, w_lo, w_hi, cfg=cfg, box=box, **kw)

        cfg = dataclasses.replace(RenderConfig(), light_grid_mode=mode)
        tshadow.shadow_sweep = record
        try:
            Renderer(scene, cfg, device="cuda").render(
                camera, [light], light.eye, use_spot=True)
        finally:
            tshadow.shadow_sweep = sweep
    for name, occ in (("skewed", False), ("skewed all-occluded", True)):
        sites[name] = dict(args=list(skewed_case("cpu", seed, occ)),
                           box=False)
    for name, site in sites.items():
        if not site["box"]:
            print(f"{name}: {gap_items(*site['args'])}", flush=True)
    torch.save(sites, path)
    return sites


def gap_items(tri, rays, w_lo, w_hi):
    """How many of a cell-key sweep's (ray block, window) items hold no
    row of any cell of the block's rays (a window's cells lie between its
    least and greatest key), and so could be skipped."""
    from ugrt_torch.kernels.shadow_sweep import chunk_item_end, chunk_windows

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


def time_sites(path, chunks, iters):
    """Time this process's ``shadow_sweep`` (whichever tree is on the
    path) on the saved inputs; one record per site."""
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.micro._common import card_line, compare, cuda_ms

    # Any object with these fields is a config to either tree's wrapper.
    cfg = types.SimpleNamespace(
        epsilon=1e-21, shadow_epsilon=1e-3,
        quirks=types.SimpleNamespace(shadow_accept_negative_t=True))
    has_chunk = "chunk" in inspect.signature(k3.shadow_sweep).parameters
    records = []
    for name, site in torch.load(path).items():
        args = [x.cuda() for x in site["args"]]
        kw = dict(cfg=cfg, box=site["box"])
        want = k3.shadow_sweep_plain(*args, **kw)
        rec = dict(site=name, tree=os.getcwd(), card=card_line(),
                   occluded=int(want.sum()), ms={}, mismatches={})
        for c in (chunks if has_chunk else [None]):
            ck = dict(kw, chunk=c) if c else kw
            mism, _ = compare((k3.shadow_sweep(*args, **ck),), (want,))
            rec["mismatches"][str(c)] = mism
            rec["ms"][str(c)] = cuda_ms(lambda: k3.shadow_sweep(*args, **ck),
                                        iters)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of another tree to time beside "
                    "this one")
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--inputs", default="_archive/k3_inputs.pt",
                    help="where the captured inputs are saved (in a "
                    "directory .gitignore lists)")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-only", action="store_true",
                    help="time the saved inputs in this process and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_chunks needs an NVIDIA GPU")
    inputs = str(Path(args.inputs).resolve())
    if args.time_only:
        time_sites(inputs, args.chunks, args.iters)
        return 0

    here = Path(__file__).resolve().parents[2]
    Path(inputs).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    capture(inputs, args.seed)
    print(f"captured in {time.perf_counter() - t0:.1f} s", flush=True)
    trees = [here] if args.parent is None else [
        Path(args.parent).resolve(), here, here, Path(args.parent).resolve()]
    records = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-only",
             "--inputs", inputs, "--iters", str(args.iters), "--chunks",
             *map(str, args.chunks)],
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
