"""G1, the gathers' fixed-point segment sum, on the card: the inputs the
flagship step gives it, what they ask of a kernel, and its time against
another tree's.

    python -m ugrt_torch.micro.gather_bwd [--parent DIR] [--iters N]
        [--inputs saved.pt] [--out results.json]

Runs one eager windowed flagship step (``render_and_grad.fn`` on
``ugrt_torch.bench``'s workload: 1024², the 73,824-face procedural
cathedral, spot, a zero target) and records the inputs of each call of
``core.gather.segment_sum``, the backward of ``gather_rows``: the corner
gather (``trace/refine.py``: [H*W*3, 3] cotangents into the vertices)
and the material gather (``shade/shaders.py``: [H*W, 6] into the
materials).  For each it prints ``profile``: the contributions that are
exactly zero after rounding to the fixed point, and how the indices fall
in the 32-element groups a warp's lanes take (distinct rows a group,
contributions that share their row with another lane of the group, and
the global atomics a warp-aggregated kernel issues: one per distinct row
and column of a group whose sum is not zero, against ``index_add_``'s
one per contribution).

Then, in a fresh process per tree (with ``--parent DIR``, an unpacked
checkout of another commit, in the order parent, this tree, this tree,
parent), on the recorded inputs: the tree's ``segment_sum`` (what the
step runs), its plain version and ``index_add_`` of the fixed-point
values alone, each as CUDA-event ms over back-to-back calls and as the
device time and launches of each CUDA kernel of one call
(torch.profiler); the tree's ``segment_sum`` held bitwise to its plain
version.  In the same process the windowed flagship frame without the
bounce (``bench_reflective.run``, chained), and beside it ``python -m
ugrt_torch.bench --skip-parity`` (the step's replay, chained and
fenced).  One JSON line per tree; all go to ``--out``.  Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

WARP = 32
# The flagship step's gathers (bench's workload): pixels, vertices of the
# 73,824-face cathedral, materials.
PIXELS = 1024 * 1024
VERTICES = 39030
FACES = 73824
MATERIALS = 5


def _values(rng, n, cols, binades=20):
    """[n, cols] f32 cotangents across ``binades`` binades below 1."""
    v = rng.normal(size=(n, cols)) * 2.0 ** rng.integers(-binades, 0,
                                                         size=(n, 1))
    return v.astype(np.float32)


def _pixel_patches(rng, count, w=8, h=4):
    """[PIXELS] int64 of 1024² pixels in row-major order, each 8x4 patch
    of them one value drawn from [0, count)."""
    patch = rng.integers(0, count, size=(1024 // h, 1024 // w))
    return np.repeat(np.repeat(patch, h, axis=0), w, axis=1).reshape(-1)


def flagship_cases(device, seed=0) -> dict:
    """{name: (values, idx, rows)} at the flagship step's two shapes, made
    from ``seed``: the material gather's [1,048,576, 6] into 5 rows (its
    first three columns zero, as the Ka quirk leaves them; materials by
    8x4 pixel patches) and the corner gather's [3,145,728, 3] into 39,030
    vertices (each patch one face of random corners); a tenth of the
    pixels miss, with zero cotangents on row 0 or face 0's corners."""
    rng = np.random.default_rng(seed)
    miss = rng.random(PIXELS) < 0.1
    mat = np.where(miss, 0, _pixel_patches(rng, MATERIALS))
    vm = _values(rng, PIXELS, 6)
    vm[:, :3] = 0
    vm[miss] = 0
    faces = rng.integers(0, VERTICES, size=(FACES, 3))
    corners = faces[np.where(miss, 0, _pixel_patches(rng, FACES))]
    vc = _values(rng, PIXELS * 3, 3)
    vc[np.repeat(miss, 3)] = 0
    return {name: (torch.from_numpy(v).to(device),
                   torch.from_numpy(i.reshape(-1).astype(np.int64)).to(device),
                   rows)
            for name, v, i, rows in (("material", vm, mat, MATERIALS),
                                     ("corner", vc, corners, VERTICES))}


def skewed_cases(device, seed=0, n=200_000, cutoff=4096) -> dict:
    """{name: (values, idx, rows)} of ``n`` elements each (but "empty"),
    made from ``seed``: every contribution on one row, in a table that
    fits shared memory and in one that does not; runs of equal rows of
    31, 33, 255 and 257 elements (across warp and block edges); tables
    of rows * 3 entries just below and just above ``cutoff`` (the
    kernel's SHARED_ENTRIES); cotangents across 40 binades with one
    huge value; a non-finite total (inf, NaN); N = 0; 1, 6 and 9
    columns; and n / 20 elements of 96 columns, rows too wide for the
    kernel's shared hash table (its global table)."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(np.arange(n), rng.choice([31, 33, 255, 257], n))[:n]
    below, above = (cutoff - 1) // 3, cutoff // 3 + 1
    cases = {
        "one row, shared": (_values(rng, n, 6), np.full(n, 2), MATERIALS),
        "one row, large": (_values(rng, n, 3), np.full(n, 12345), VERTICES),
        "runs 31-257": (_values(rng, n, 3), runs, int(runs[-1]) + 1),
        "cutoff below": (_values(rng, n, 3), rng.integers(0, below, n),
                         below),
        "cutoff above": (_values(rng, n, 3), rng.integers(0, above, n),
                         above),
        "40 binades": (_values(rng, n, 3, binades=40), rng.integers(0, 300, n),
                       300),
        "inf": (_values(rng, n, 3), rng.integers(0, 300, n), 300),
        "nan": (_values(rng, n, 3), rng.integers(0, 300, n), 300),
        "empty": (np.zeros((0, 3), np.float32), np.zeros(0, np.int64), 10),
        "1 column": (_values(rng, n, 1)[:, 0], rng.integers(0, 500, n), 500),
        "6 columns": (_values(rng, n, 6), rng.integers(0, 5000, n), 5000),
        "9 columns": (_values(rng, n, 9).reshape(n, 3, 3),
                      rng.integers(0, 3000, n), 3000),
        "96 columns": (_values(rng, n // 20, 96),
                       rng.integers(0, 100, n // 20), 100),
    }
    cases["40 binades"][0][n // 2] = 1e3
    cases["inf"][0][n // 3, 1] = np.inf
    cases["nan"][0][n // 5, 2] = np.nan
    return {name: (torch.from_numpy(v).to(device),
                   torch.from_numpy(i.astype(np.int64)).to(device), rows)
            for name, (v, i, rows) in cases.items()}


def record_inputs(args: dict | None = None, kw: dict | None = None) -> dict:
    """{site: dict(values, idx, rows)} of the segment sums of one eager
    step ``render_and_grad.fn(**args, **kw)``, as the backward hands them
    over ("material": rows = the materials', else "corner").  By default
    the windowed flagship step of ``ugrt_torch.bench``'s workload."""
    from ugrt_torch import bench
    from ugrt_torch.core import gather
    from ugrt_torch.diff.render_grad import render_and_grad

    if args is None:
        w = bench.workload("cuda")
        args = bench.step_inputs(w, torch.device("cuda"))
        kw = dict(cfg=w.cfg, capacity=w.capacity, num_lights=1,
                  use_spot=True)
    sites, original = {}, gather.segment_sum

    def record(values, idx, rows):
        site = ("material" if rows == args["materials"].shape[0]
                else "corner")
        sites[site] = dict(values=values.detach().clone(), idx=idx.clone(),
                           rows=rows)
        return original(values, idx, rows)

    gather.segment_sum = record
    try:
        render_and_grad.fn(**args, **kw)
    finally:
        gather.segment_sum = original
    torch.cuda.synchronize()
    return sites


def profile(values, idx, rows: int) -> dict:
    """What these inputs ask of a kernel (module docstring)."""
    from ugrt_torch.kernels.segment_sum import fixed_point

    n = idx.numel()
    c = values.numel() // max(n, 1)
    fixed, _, total = fixed_point(values.reshape(n, c))
    zero = fixed == 0
    groups = (n + WARP - 1) // WARP
    pad = groups * WARP - n
    lanes = torch.cat([idx, idx.new_full((pad,), -1)]).reshape(groups, WARP)
    srt = lanes.sort(dim=1).values
    starts = torch.ones_like(srt, dtype=torch.bool)
    starts[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = starts.sum(1) - (srt[:, 0] < 0).long()
    # Each lane's (group, row) key; a row's sum within its group.
    key = torch.arange(groups, device=idx.device).repeat_interleave(
        WARP)[:n] * rows + idx
    uniq, inv, counts = torch.unique(key, return_inverse=True,
                                     return_counts=True)
    sums = torch.zeros((uniq.numel(), c), dtype=torch.int64,
                       device=idx.device).index_add_(0, inv, fixed)
    shared = counts[inv] > 1
    return dict(
        n=n, columns=c, rows=rows, total=float(total),
        contributions=n * c, zero_contributions=int(zero.sum()),
        all_zero_elements=int(zero.all(1).sum()),
        distinct_rows_per_group=float(distinct.double().mean()),
        distinct_rows_per_group_max=int(distinct.max()),
        elements_sharing_their_row_in_group=int(shared.sum()),
        group_atomics_nonzero=int((sums != 0).sum()),
        group_atomics=int(uniq.numel()) * c,
        rows_touched=int(torch.unique(idx).numel()))


def device_kernels(fn, iters: int = 5) -> dict:
    """{CUDA kernel or copy: [mean device ms a call, launches a call]} of
    fn() under torch.profiler, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.self_device_time_total / 1e3 / iters, e.count / iters]
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def _tree_functions():
    """(segment_sum as the step calls it, its plain version) in this
    process's tree: the kernel's wrapper where the tree has one, else
    core.gather's index_add_ version (both)."""
    try:
        from ugrt_torch.kernels import segment_sum as tree_g1
    except ImportError:
        from ugrt_torch.core import gather
        return gather.segment_sum, gather.segment_sum
    return tree_g1.segment_sum, tree_g1.segment_sum_plain


def time_inputs(path: str, iters: int) -> dict:
    """This process's tree on the saved inputs, then its windowed frame
    (module docstring)."""
    from ugrt_torch import bench
    from ugrt_torch.micro import bench_reflective
    from ugrt_torch.micro._common import card_line, cuda_ms

    fn, plain = _tree_functions()
    rec = dict(tree=os.getcwd(), card=card_line(), sites={})
    for site, s in torch.load(path).items():
        values, idx, rows = s["values"].cuda(), s["idx"].cuda(), s["rows"]
        want = plain(values, idx, rows)
        fixed = s["fixed"].cuda()
        acc_shape = (rows,) + tuple(values.shape[1:])

        def index_add():
            return torch.zeros(acc_shape, dtype=torch.int64,
                               device=values.device).index_add_(0, idx, fixed)

        def mismatches(f):
            got = f(values, idx, rows)
            return int((got.view(torch.int32)
                        != want.view(torch.int32)).sum())

        rec["sites"][site] = dict(
            mismatches=mismatches(fn),
            ms=cuda_ms(lambda: fn(values, idx, rows), iters),
            plain_ms=cuda_ms(lambda: plain(values, idx, rows), iters),
            index_add_ms=cuda_ms(index_add, iters),
            kernels=device_kernels(lambda: fn(values, idx, rows)),
            plain_kernels=device_kernels(lambda: plain(values, idx, rows)),
            index_add_kernels=device_kernels(index_add))
    w = bench.workload("cuda")
    with tempfile.TemporaryDirectory() as d:
        res = bench_reflective.run(w.cfg, w.scene, torch.device("cuda"),
                                   out_path=os.path.join(d, "f.png"),
                                   reflective=False)
    rec.update(windowed_frame_ms=res["base_ms"],
               windowed_frame_ms_events=res["base_ms_events"])
    return rec


def in_turns(trees, here, inputs: str, iters: int) -> list:
    """Each tree's ``time_inputs`` and ``python -m ugrt_torch.bench
    --skip-parity`` in fresh processes, in the order of ``trees``."""
    records = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree))
        rec = {}
        for argv in ([str(Path(__file__).resolve()), "--time-only",
                      "--inputs", inputs, "--iters", str(iters)],
                     ["-m", "ugrt_torch.bench", "--skip-parity"]):
            proc = subprocess.run([sys.executable, *argv], cwd=tree, env=env,
                                  capture_output=True, text=True,
                                  check=False)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                raise SystemExit(f"{' '.join(argv)} in {tree} failed "
                                 f"({proc.returncode})")
            last = json.loads(proc.stdout.strip().splitlines()[-1])
            if "detail" in last:
                d = last["detail"]
                rec.update({k: d[k] for k in (
                    "step_ms_chained", "step_ms_chained_events",
                    "step_ms_fenced", "step_ms_fenced_events")})
            else:
                rec.update(last)
        rec["tree"] = "parent" if tree != here else "this"
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of another tree to time beside "
                    "this one")
    ap.add_argument("--inputs", help="where the recorded inputs are saved, "
                    "in a directory .gitignore lists (default "
                    "_archive/g1_inputs.pt)")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--time-only", action="store_true",
                    help="time the saved inputs in this process and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_bwd needs an NVIDIA GPU")
    inputs = str(Path(args.inputs or "_archive/g1_inputs.pt").resolve())
    if args.time_only:
        print(json.dumps(time_inputs(inputs, args.iters)), flush=True)
        return 0

    from ugrt_torch.kernels.segment_sum import fixed_point
    from ugrt_torch.micro._common import card_line

    here = Path(__file__).resolve().parents[2]
    Path(inputs).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sites = record_inputs()
    for s in sites.values():
        s["fixed"] = fixed_point(s["values"])[0]
    torch.save({k: {n: (x.cpu() if torch.is_tensor(x) else x)
                    for n, x in s.items()} for k, s in sites.items()},
               inputs)
    records = []
    for site, s in sites.items():
        rec = dict(site=site, card=card_line(), **profile(
            s["values"], s["idx"], s["rows"]))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print(f"recorded and profiled in {time.perf_counter() - t0:.1f} s",
          flush=True)
    trees = [here] if args.parent is None else [
        Path(args.parent).resolve(), here, here, Path(args.parent).resolve()]
    records += in_turns(trees, here, inputs, args.iters)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    bad = [r for r in records for s in r.get("sites", {}).values()
           if s["mismatches"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
