"""G1, the step's fixed-point segment sums, on the card: the inputs the
flagship step gives them, what they ask of the kernel, and their time
against another tree's.

    python -m ugrt_torch.micro.gather_bwd [--parent DIR] [--iters N]
        [--out results.json]

Runs one eager windowed flagship step (``render_and_grad.fn`` on
``ugrt_torch.bench``'s workload: 1024², the 73,824-face procedural
cathedral, spot, a zero target) and records the inputs of its two sums
(``record_inputs``): the corner sum, the backward of
``gather_face_data`` (``trace/refine.py``: [H*W, 9] cotangents keyed by
face, ``face_corner_sum``), and the material sum, the backward of
``gather_rows`` (``shade/shaders.py``: [H*W, 6] into the materials,
``segment_sum``).  For each it prints ``profile``: the contributions
that are exactly zero after rounding to the fixed point, and the keys
(faces, or rows) as the accumulate pass's warps meet them, 32 elements
a step: distinct keys a step, the steps of one key and of several, the
runs a warp carries across its steps, the flushes, their non-zero
additions to the block's table and the blocks' non-zero additions to
the global accumulator, and the keys and rows touched.

Then, in a fresh process per tree (with ``--parent DIR``, an unpacked
checkout of another commit, in the order parent, this tree, this tree,
parent), each tree records its own step's sums (a tree before the
face-keyed sum sums the corners by vertex) and times on them: the
sum the step runs, its plain version and ``index_add_`` of the
fixed-point values alone, each as CUDA-event ms over back-to-back calls,
the sum as a CUDA graph replay, and the device time and launches of each
CUDA kernel of one call (torch.profiler); the sum held bitwise to its
plain version.  In the same process the windowed flagship frame without
the bounce (``bench_reflective.run``, chained), and beside it ``python
-m ugrt_torch.bench --skip-parity`` (the step's replay, chained and
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


def _pixel_patches(rng, count, w=8, h=4, pixels=PIXELS, width=1024):
    """[pixels] int64 of an image ``width`` wide in row-major order (its
    last row cut short), each w x h patch of it one value drawn from [0,
    count)."""
    rows = -(-pixels // width)
    patch = rng.integers(0, count, size=(-(-rows // h), width // w))
    return np.repeat(np.repeat(patch, h, axis=0), w,
                     axis=1).reshape(-1)[:pixels]


def _runs(rng, count, n, lengths):
    """[n] int64: runs of a value drawn from [0, count), each run's length
    drawn from ``lengths``."""
    runs = np.repeat(rng.integers(0, count, n), rng.choice(lengths, n))
    return runs[:n]


def _torch_case(device, *arrays_and_rows):
    """A case's numpy arrays as tensors on ``device`` (f32 values, int32
    keys and faces), the row count last."""
    *arrays, rows = arrays_and_rows
    return tuple(torch.from_numpy(a if a.dtype == np.float32
                                  else a.astype(np.int32)).to(device)
                 for a in arrays) + (rows,)


def flagship_cases(device, seed=0) -> dict:
    """{name: case} at the flagship step's two shapes, made from ``seed``:
    the material sum's (values [1,048,576, 6], idx, 5 rows; its first
    three columns zero, as the Ka quirk leaves them; materials by 8x4
    pixel patches) and the corner sum's (values [1,048,576, 9], fid,
    faces [73,824, 3] of random vertices, 39,030 rows; faces by 8x4
    pixel patches); a tenth of the pixels miss, with zero cotangents on
    row 0 or face 0.  ``sums`` runs either kind."""
    rng = np.random.default_rng(seed)
    miss = rng.random(PIXELS) < 0.1
    mat = np.where(miss, 0, _pixel_patches(rng, MATERIALS))
    vm = _values(rng, PIXELS, 6)
    vm[:, :3] = 0
    vm[miss] = 0
    faces = rng.integers(0, VERTICES, size=(FACES, 3))
    fid = np.where(miss, 0, _pixel_patches(rng, FACES))
    vc = _values(rng, PIXELS, 9)
    vc[miss] = 0
    return {"material": _torch_case(device, vm, mat, MATERIALS),
            "corner": _torch_case(device, vc, fid, faces, VERTICES)}


def skewed_cases(device, seed=0, n=200_000, cutoff=None) -> dict:
    """{name: (values, idx, rows)} of ``n`` elements each (but "empty"),
    made from ``seed``, for ``segment_sum``: every contribution on one
    row, in a table that fits shared memory and in one that does not;
    runs of equal rows of 31, 33, 255 and 257 elements (across warp and
    block edges); tables of rows * 3 entries just below and just above
    ``cutoff`` (default the kernel's SHARED_ENTRIES); cotangents across
    40 binades with one huge value; a non-finite total (inf, NaN); N =
    0; 1, 6 and 9 columns; and n / 20 elements of 96 columns, rows too
    wide for the kernel's shared hash table (its global table)."""
    from ugrt_torch.kernels.segment_sum import SHARED_ENTRIES

    cutoff = SHARED_ENTRIES if cutoff is None else cutoff
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
    return {name: _torch_case(device, *case) for name, case in cases.items()}


def face_cases(device, seed=0, n=200_000) -> dict:
    """{name: (values [n, 9], fid, faces, rows)} made from ``seed``, for
    ``face_corner_sum``: every pixel on one face; faces that share their
    vertices (200 faces on 50 vertices, runs of 1-300 pixels); degenerate
    faces that repeat a vertex (two or three times); misses clamped to
    face 0 with zero cotangents among 8x4 patches; runs of 31, 33, 255 and
    257 pixels, which change face inside a warp's step and inside its
    span; a random face each pixel of 73,824 (more faces in a block than
    its hash table holds: the misses go to the global accumulator); 40
    binades with one huge value; a non-finite total (inf, NaN); N = 0.
    Tables of up to 227 faces take the kernel's direct table, larger
    ones its hash table."""
    rng = np.random.default_rng(seed)

    def faces_of(count, verts):
        return np.stack([rng.choice(verts, 3, replace=False)
                         for _ in range(count)])

    big = faces_of(FACES, VERTICES)
    shared = faces_of(200, 50)
    degenerate = np.concatenate([faces_of(40, 300), rng.integers(
        0, 300, (20, 1)).repeat(3, 1), np.stack([[v, v, w] for v, w in
                                                 rng.integers(0, 300,
                                                              (20, 2))])])
    miss = rng.random(n) < 0.1
    patched = np.where(miss, 0, _pixel_patches(rng, 200, pixels=n, width=64))
    v_miss = _values(rng, n, 9)
    v_miss[miss] = 0
    cases = {
        "one face": (_values(rng, n, 9), np.full(n, 7), big, VERTICES),
        "shared vertices": (_values(rng, n, 9),
                            _runs(rng, 200, n, np.arange(1, 301)), shared, 50),
        "degenerate faces": (_values(rng, n, 9),
                             _runs(rng, 80, n, [1, 7, 40, 300]), degenerate,
                             300),
        "misses to face 0": (v_miss, patched, faces_of(200, 3000), 3000),
        "runs 31-257": (_values(rng, n, 9),
                        _runs(rng, FACES, n, [31, 33, 255, 257]), big,
                        VERTICES),
        "random faces": (_values(rng, n, 9), rng.integers(0, FACES, n), big,
                         VERTICES),
        "40 binades": (_values(rng, n, 9, binades=40),
                       _runs(rng, 150, n, [5, 60]), big[:150], VERTICES),
        "inf": (_values(rng, n, 9), _runs(rng, 150, n, [5, 60]), big[:150],
                VERTICES),
        "nan": (_values(rng, n, 9), _runs(rng, 150, n, [5, 60]), big[:150],
                VERTICES),
        "empty": (np.zeros((0, 9), np.float32), np.zeros(0, np.int64),
                  big[:10], VERTICES),
    }
    cases["40 binades"][0][n // 2, 4] = 1e3
    cases["inf"][0][n // 3, 1] = np.inf
    cases["nan"][0][n // 5, 8] = np.nan
    return {name: _torch_case(device, *case) for name, case in cases.items()}


def sums(case):
    """(the wrapper, its plain version) of a case: ``segment_sum`` for
    (values, idx, rows), ``face_corner_sum`` for (values, fid, faces,
    rows)."""
    from ugrt_torch.kernels import segment_sum as g1

    if len(case) == 4:
        return g1.face_corner_sum, g1.face_corner_sum_plain
    return g1.segment_sum, g1.segment_sum_plain


def record_inputs(args: dict | None = None, kw: dict | None = None) -> dict:
    """{site: case} of the sums of one eager step ``render_and_grad.fn(
    **args, **kw)``, as the backward hands them over: "material" (values,
    idx, rows) and "corner" (values, fid, faces, rows; in a tree before
    the face-keyed sum, values, idx, rows).  By default the windowed
    flagship step of ``ugrt_torch.bench``'s workload."""
    from ugrt_torch import bench
    from ugrt_torch.core import gather
    from ugrt_torch.diff.render_grad import render_and_grad

    if args is None:
        w = bench.workload("cuda")
        args = bench.step_inputs(w, torch.device("cuda"))
        kw = dict(cfg=w.cfg, capacity=w.capacity, num_lights=1,
                  use_spot=True)
    sites = {}
    names = [n for n in ("segment_sum", "face_corner_sum")
             if hasattr(gather, n)]
    originals = {n: getattr(gather, n) for n in names}

    def recorder(name):
        def record(values, *keys_and_rows):
            rows = keys_and_rows[-1]
            site = ("material" if rows == args["materials"].shape[0]
                    else "corner")
            sites[site] = (values.detach().clone(),
                           *(k.clone() for k in keys_and_rows[:-1]), rows)
            return originals[name](values, *keys_and_rows)
        return record

    for n in names:
        setattr(gather, n, recorder(n))
    try:
        render_and_grad.fn(**args, **kw)
    finally:
        for n, f in originals.items():
            setattr(gather, n, f)
    torch.cuda.synchronize()
    return sites


def warp_layout(n: int, sms: int = 132) -> tuple[int, int]:
    """(warps, span): the accumulate pass's warps and the elements each
    walks (kernels/segment_sum.py: min(ceil(n / THREADS), BLOCKS_PER_SM *
    sms) blocks of THREADS / 32 warps)."""
    from ugrt_torch.kernels import segment_sum as g1

    blocks = max(1, min(-(-n // g1.THREADS), g1.BLOCKS_PER_SM * sms))
    warps = blocks * (g1.THREADS // WARP)
    return warps, -(-n // (warps * WARP)) * WARP


def profile(case, sms: int = 132) -> dict:
    """What a case asks of the kernel (module docstring): the per-step
    view of its keys (rows, or faces for the corner sum) as the
    accumulate pass's warps meet them on a card of ``sms`` SMs."""
    from ugrt_torch.kernels.segment_sum import THREADS, fixed_point

    values, keys, *faces, rows = case
    count = faces[0].shape[0] if faces else rows     # the keys
    n = keys.numel()
    c = values.numel() // max(n, 1)
    fixed, _, total = fixed_point(values.reshape(n, c))
    zero = fixed == 0
    dev = keys.device
    k = keys.long()
    warps, span = warp_layout(max(n, 1), sms)
    steps = (n + WARP - 1) // WARP
    pad = steps * WARP - n
    lanes = torch.cat([k, k.new_full((pad,), -1)]).reshape(steps, WARP)
    srt = lanes.sort(dim=1).values
    starts = torch.ones_like(srt, dtype=torch.bool)
    starts[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = starts.sum(1) - (srt[:, 0] < 0).long()
    one = distinct == 1
    mixed = distinct > 1
    # The carry after a step is its last lane's key; before it, the key
    # the warp's last step with keys left (csrc/segment_sum.cu).
    valid = lanes >= 0
    last_lane = WARP - 1 - valid.flip(1).long().argmax(1)
    last = lanes.gather(1, last_lane[:, None]).squeeze(1)
    warp = torch.arange(steps, device=dev) * WARP // span
    live = (distinct > 0).nonzero().squeeze(1)
    lk, lw = last[live], warp[live]
    first = torch.ones_like(lk, dtype=torch.bool)
    first[1:] = lw[1:] != lw[:-1]
    before = torch.where(first, -1, torch.roll(lk, 1))
    change = lk != before
    run_after = torch.cumsum(change.long(), 0) - 1
    run_before = torch.where(first, -1, torch.roll(run_after, 1))
    carry_before = torch.full((steps,), -1, dtype=torch.int64, device=dev)
    carry_before[live] = before
    rb = torch.full((steps,), -1, dtype=torch.int64, device=dev)
    rb[live] = run_before
    ra = torch.full((steps,), -1, dtype=torch.int64, device=dev)
    ra[live] = run_after
    # Each element's flush: the carried run it joins, or its step's group
    # of a third key; the non-zero column sums of the flushes are the
    # table additions, and each block's non-zero (key, column) entries at
    # its end the global additions.
    elem = torch.arange(n, device=dev)
    st = elem // WARP
    runs = int(change.sum())
    flush_key = torch.where(
        k == carry_before[st], rb[st],
        torch.where(k == last[st], ra[st], runs + st * count + k))
    uniq, inv = torch.unique(flush_key, return_inverse=True)
    flush_sums = torch.zeros((uniq.numel(), c), dtype=torch.int64,
                             device=dev).index_add_(0, inv, fixed)
    block = elem // span // (THREADS // WARP)
    bkey, binv = torch.unique(block * count + k, return_inverse=True)
    block_sums = torch.zeros((bkey.numel(), c), dtype=torch.int64,
                             device=dev).index_add_(0, binv, fixed)
    rec = dict(
        n=n, columns=c, keys=count, rows=rows, total=float(total),
        contributions=n * c, zero_contributions=int(zero.sum()),
        all_zero_elements=int(zero.all(1).sum()) if n else 0,
        warps=warps, span=span, steps=steps,
        distinct_keys_per_step=float(distinct.double().mean()) if n else 0.0,
        distinct_keys_per_step_max=int(distinct.max()) if n else 0,
        one_key_steps=int(one.sum()), mixed_steps=int(mixed.sum()),
        carried_runs=runs,
        steps_per_run=float(live.numel()) / max(runs, 1),
        group_flushes=int((uniq >= runs).sum()),
        flushes=int(uniq.numel()),
        table_additions=int((flush_sums != 0).sum()),
        global_additions=int((block_sums != 0).sum()),
        keys_touched=int(torch.unique(k).numel()))
    if faces:
        rec["rows_touched"] = int(torch.unique(
            faces[0][torch.unique(k)].long()).numel())
    else:
        rec["rows_touched"] = rec["keys_touched"]
    return rec


def graph_ms(fn, iters: int) -> float:
    """Mean CUDA-event ms of fn() captured as one CUDA graph and replayed
    ``iters`` times back to back (its device work without host gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def _tree_sums(case):
    """(the sum the step calls, its plain version, fixed_point) for a
    case in this process's tree: ``sums`` where the tree has the
    face-keyed sum, else its row sum."""
    from ugrt_torch.kernels import segment_sum as tree_g1

    if hasattr(tree_g1, "face_corner_sum"):
        return (*sums(case), tree_g1.fixed_point)
    return tree_g1.segment_sum, tree_g1.segment_sum_plain, tree_g1.fixed_point


def index_add_call(case, fixed_point):
    """index_add_ of the fixed-point values alone, with its zero fill
    (the library yardstick; a face case's corner index, faces[fid], made
    beforehand)."""
    values, keys, *faces, rows = case
    if faces:
        values = values.reshape(-1, 3)
        keys = faces[0][keys].reshape(-1)
    idx, fixed = keys.long(), fixed_point(values)[0]
    shape = (rows,) + tuple(values.shape[1:])
    return lambda: torch.zeros(shape, dtype=torch.int64,
                               device=idx.device).index_add_(0, idx, fixed)


def time_inputs(iters: int) -> dict:
    """This process's tree on its own step's sums (``record_inputs``),
    then its windowed frame (module docstring)."""
    from ugrt_torch import bench
    from ugrt_torch.micro import bench_reflective
    from ugrt_torch.micro._common import card_line, cuda_ms

    rec = dict(tree=os.getcwd(), card=card_line(), sites={})
    for site, case in sorted(record_inputs().items()):
        fn, plain, fixed_point = _tree_sums(case)
        want = plain(*case)
        got = fn(*case)
        index_add = index_add_call(case, fixed_point)
        rec["sites"][site] = dict(
            shape=list(case[0].shape), mismatches=int(
                (got.view(torch.int32) != want.view(torch.int32)).sum()),
            ms=cuda_ms(lambda: fn(*case), iters),
            graph_ms=graph_ms(lambda: fn(*case), iters),
            plain_ms=cuda_ms(lambda: plain(*case), iters),
            index_add_ms=cuda_ms(index_add, iters),
            kernels=device_kernels(lambda: fn(*case)),
            plain_kernels=device_kernels(lambda: plain(*case)),
            index_add_kernels=device_kernels(index_add))
    w = bench.workload("cuda")
    with tempfile.TemporaryDirectory() as d:
        res = bench_reflective.run(w.cfg, w.scene, torch.device("cuda"),
                                   out_path=os.path.join(d, "f.png"),
                                   reflective=False)
    rec.update(windowed_frame_ms=res["base_ms"],
               windowed_frame_ms_events=res["base_ms_events"])
    return rec


def in_turns(trees, here, iters: int) -> list:
    """Each tree's ``time_inputs`` and ``python -m ugrt_torch.bench
    --skip-parity`` in fresh processes, in the order of ``trees``."""
    records = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree))
        rec = {}
        for argv in ([str(Path(__file__).resolve()), "--time-only",
                      "--iters", str(iters)],
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
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--time-only", action="store_true",
                    help="time this tree's sums in this process and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_bwd needs an NVIDIA GPU")
    if args.time_only:
        print(json.dumps(time_inputs(args.iters)), flush=True)
        return 0

    from ugrt_torch.micro._common import card_line

    here = Path(__file__).resolve().parents[2]
    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = []
    for site, case in sorted(record_inputs().items()):
        rec = dict(site=site, card=card_line(), **profile(case, sms))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print(f"recorded and profiled in {time.perf_counter() - t0:.1f} s",
          flush=True)
    trees = [here] if args.parent is None else [
        Path(args.parent).resolve(), here, here, Path(args.parent).resolve()]
    records += in_turns(trees, here, args.iters)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    bad = [r for r in records for s in r.get("sites", {}).values()
           if s["mismatches"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
