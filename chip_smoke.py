#!/usr/bin/env python3
"""Smoke test of ugrt_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases (each prints a line; any failure raises and exits non-zero):
 1. CUDA must be available; prints the card's name and power limit.
 2. Builds the two CUDA libraries from ugrt_torch/csrc with nvcc, both
    at once (the sweeps K1-K3, and the probes S1-S3); prints each
    library's nvcc seconds and each kernel's registers and spills
    (-Xptxas -v).
 3. Renders one flagship frame per light-grid mode (1024^2, 128x128
    grid, the 75k-triangle procedural cathedral, spot; windowed, then
    reference), records the inputs each sweep kernel gets on that path,
    and holds every kernel against its plain PyTorch version on them:
    K1/K2 bitwise, K3 exact; K1 also on its synthetic skewed case (one
    ray block spanning 119 windows beside empty ranges and two-cell
    blocks) at every chunk size, K3 on its skewed case (hundreds of
    windows) and on its all-occluded twin, in both of its walks, and on
    its reference-like case (a few cells of long ranges, most rays
    occluded at random rows, some never) in the serial walk at chunks 1,
    2, 4 and 8.  Prints mismatches, CUDA-event ms of kernel vs plain (the
    plain versions on the frames' sites; by torch.profiler, of the CUDA
    kernel alone beside the host time of a call), the (ray, row) tests
    the inputs need (K3: every admitted test of a ray no row occludes,
    one of each shadowed ray) against the lane slots of the warp steps
    the kernel ran (counted by each kernel's counting build, with K1's
    work items, chunk and longest range, the tests K2's warps skip at
    the footprint, the t-free and the could-win votes and the divisions
    they take, and K3's counts: items, steps skipped and executed, live
    tests, t-free skips, divisions, hints tried and hit, rays its second
    pass walked), and the bound: the larger of the needed flops at the
    card's published f32 peak and the bytes at its memory rate.
3b. B1 (kernels/shadow_bin), the shadow rays' binning, sort, rows and
    unpermute, against its plain version on the flagship frame's
    1,048,576 rays (bench's camera, eager primary): every key, the
    permutation, the rows and the block bounds bitwise in reference,
    extent and windowed mode (with and without the window launch's
    angles), the window's bounds and angles, the unpermute of random
    flags; the same on a ragged 1000 x 999 slice with NaN and inf t.
    Prints each launch's ms as a replayed graph beside the plain
    chain's and the bound (the rays' t and dir read once, the rows,
    keys and ids written once, at the card's memory rate).  B2
    (kernels/shadow_tris), the triangle side, on each mode's light grid
    and B1's blocks of the flagship frame: the key and heavy rows and
    every range bitwise its plain version, its ms as a replayed graph
    beside the plain chain's and the bound (each pair slot's face and
    key read, its 64-byte row written).
 4. Renders the Cornell box at 128^2 on the card and on the CPU (where
    the sweeps run their plain versions); at most 0.1% of pixels of the
    u8 image and of the shadow mask may differ.  The CPU frame is held
    to the numpy oracle by the tests (tests/test_torch_render.py).
 5. Flagship frames through Renderer.render on the card, windowed then
    reference light grid, 4 frames each; every kernel must have launched
    (B1's and B2's wrappers once a frame, the window's in windowed mode
    only)
    and no grid capacity may overflow.  Prints per-frame ms, then the
    device-busy share and top kernels of one more frame per mode under
    torch.profiler.  Renderer.render, render_and_grad and train()'s step
    replay captured CUDA graphs (core.program) from here on: a replay
    credits each kernel wrapper with the launches its capture recorded.
 6. The differentiable step render_and_grad on bench.py's flagship
    workload (bench.py:142-211: 1024^2, windowed, spot, one light, zero
    target): one warm-up step, then 4 steps with CUDA-event and host ms,
    loss, |grad|_1 and overflow; K1-K3 and G1's two sums (the corner sum
    keyed by face and the material sum, one each a step) must have
    launched; whether two identical steps give bitwise equal gradients;
    one profiled step, which must list both of G1's accumulate kernels
    and no index_add_ kernel.  Then the rotated Cornell box at 64^2
    (tests/test_grad.py:154-182) on the card and on the CPU: loss within
    rtol 1e-5, atol 1e-7, gradients within 1e-5 * max|g| (sums in
    another order).  (g) G1 alone: its inputs at both flagship sites
    (the corner sum, [1,048,576, 9] cotangents keyed by face into the
    vertices, and the material sum, [1,048,576, 6] into the materials)
    recorded from one eager step, then each sum bitwise its plain
    version on them and on micro.gather_bwd's skewed cases (one row,
    runs across warp and block edges, tables just below and above the
    shared-memory cutoff, 40 binades, inf and NaN, N = 0, 1, 6, 9 and 96
    columns) and face cases (one face, shared vertices, degenerate
    faces, misses to face 0, runs that change face mid-step and
    mid-span, a random face a pixel, 40 binades, inf and NaN, N = 0),
    twice each; its CUDA-event ms, the ms of its kernels replayed as one
    CUDA graph (device time without the host's gaps), the plain
    version's ms, index_add_ of the fixed-point values alone (the
    library yardstick) and the bound (bytes at 3.35 TB/s); what the
    inputs ask (micro.gather_bwd.profile: distinct keys a step, steps
    of one key, carried runs, flushes, table and global additions, keys
    and rows touched).
 7. The probes S1-S3 (ugrt_torch.micro) at their scripts' sizes: every
    variant held against its plain version (S1 fma, S2, S3 bitwise; S1
    mma within its bound), then timed with their bounds, S2's and S3's
    half-rate floors (the f32 work at the rate -fmad=false leaves) and
    S2's per-item copy bytes and copy floor, S3's and K2's warp counts;
    S1's three products also as one torch.bmm (the library yardstick,
    "highest" and TF32) and S1's whole function in PyTorch (that bmm,
    then u and v); every probe kernel must have launched.
 8. The reflective frame (render_frame_reflective, one captured program
    per static key, its DDA the kernel D1): the Cornell box at 128^2
    (uniform grid 8^3) on the card and on the CPU, where the reflection's
    face and t and the u8 image may differ on at most 0.1% of pixels.
    Then at the flagship with ugrt's reflection defaults (32^3 uniform
    grid, batches of 32 up to 8, skip 6): (b) the eager body in
    "reference" and "windowed" mode, Lambert and spot, under
    torch.cuda.set_sync_debug_mode("error"): no host sync.  (a) D1
    against its plain version, bitwise (t, face_id, overflow), on the
    1,048,576 reflection rays of the reference-mode frame (recorded from
    the eager body), on the same rays in a seeded random order, on the
    DDA's edge case (ugrt_torch/micro/dda_edge.py, which must overflow)
    and on that case over a 2^3 grid in batches of 48: CUDA-event ms, the
    CUDA kernel alone (torch.profiler), host ms per call, plain ms, the
    (ray, face) tests the rays need against the lane slots D1's warps
    spend on staged faces (and those a per-ray kernel whose lanes test in
    lockstep would spend), the distinct cells its warps serve a round
    (its counting launch), the DDA steps (D1's, the CPU's count, beside
    the plain version's on the card), the bound max(flops / 67 TFLOP/s,
    bytes / 3.35 TB/s) and the half-rate floor (flops / 33.5 TFLOP/s:
    -fmad=false issues each product and sum alone).  The main path: the
    programs dropped, 4 frames in the CLI's default "reference" mode
    (frame 1 records Lambert's key, frame 2 the spotlight's): CUDA-event
    and host ms, overflow (fails), the share of primary hits whose
    reflection hits a face, the uniform grid's pairs and largest cell,
    the DDA steps, K1-K3's and D1's launches.  (c) Warm-up + capture
    seconds per key.  (d) Replays bitwise
    equal to the eager body (image, color, shadowed, reflection t and
    face_id, overflow) in both modes, Lambert and spot, on CAMERA and
    CAMERA_2 in turn, and after Renderer.update_vertices of the last
    eighth.  (e) Eager, graphed, graphed, eager: ms of frames 2-4.  (f)
    One profiled replay: busy share, kernel count; K1-K3 and D1 by name.
    (g) Peak and held device memory of the eager body and of each key
    from nothing recorded, as phase 11h.
 9. The training loop train() on bench.py's flagship workload (both
    parameter groups; K1-K3 and G1 counted): 6 steps with a checkpoint
    every 3, then a resume
    to 8 steps, with CUDA-event and host ms per step and the losses
    (non-finite fails; the resume must start at step 6 and leave its
    latest checkpoint at step 7); then tests/test_api.py:87-130 on the
    card: the single triangle at 64^2 recovers halved materials, its
    loss below 0.2x the first in 30 steps.
10. Sharding and host IO.  (a) An NCCL process group of one rank on the
    card (FileStore), dist.mesh's frame and step as captured programs
    (their collectives inside the graph).  The main path: sharded_render
    at the flagship in windowed and reference mode on CAMERA, then
    CAMERA_2 (the first call records the key, the second replays it),
    and sharded_train_step on phase 6's workload on a zero, then a
    seeded target; K1-K3's and G1's launches on it.  Each replay bitwise
    its eager body (.fn): image and overflow; loss, both gradients and
    overflow.  Each image bitwise render_color's; each step against
    render_and_grad (loss rtol 1e-5, gradients within 1e-6 * max|g|, or
    bitwise); overflow False.  Eager body, replay, bare replay
    (render_and_grad, render_frame_device), in turns: CUDA-event and
    host ms, K1-K3's launches credited to the replays; the NCCL kernels
    and the busy share of one profiled replayed step.  (b) The
    strips of worlds 2 and 4 on the one card (render_color's bx0 / n_bx
    with no group, reference mode): face_id, t and the image side by side
    bitwise equal to the single-device frame; K1-K3 launches per strip.
    (c) The native host library built with g++ (seconds printed): the
    flagship cathedral written with write_obj and loaded by the native
    and the Python parser (arrays equal), one 1024^2 frame written by
    both PPM writers (bytes equal), ms of each.  (d) build_packets on the
    flagship windowed frame's light cells on the card, equal to the CPU
    and meeting tests/test_packets.py's packet invariants.
11. One dispatch per frame and per step (core.program), at the
    flagship.  (a) One eager frame per mode (windowed, reference,
    extent; Lambert and spot) and one eager step under
    torch.cuda.set_sync_debug_mode("error"): no host sync.  (b) The
    programs dropped, then each key's warm-up + capture seconds (frame
    Lambert, frame spot, step; then the other modes' frames).  (c)
    Replayed frames bitwise equal to eager render_frame (image, color,
    shadowed, primary t and face_id, overflow) in the three modes, Lambert
    and spot, two cameras in turn.  (d) rotate_subrange of the last eighth
    of the vertices through Renderer.update_vertices: the next replay
    bitwise the eager frame of the new vertices.  (e) The step's replay
    bitwise the eager step (loss, color, both gradients, overflow), two
    targets in turn.  (f) Eager, graphed, graphed, eager: ms (CUDA
    events, host) of frames 2-4 in windowed and reference mode, of
    steps 1-4, and of train() per step (steps 1-4); K1-K3's launches
    credited to the graphed runs.  (g) One replayed frame and one step
    under torch.profiler: busy share, kernel count, top kernels; K1-K3
    must appear by name, and in the step G1 and no index_add_.  (h) Peak
    device memory of eager and graphed frames and steps, and what a
    capture holds.  (i) A Program whose
    body calls .item() must raise at capture, and a replay after it
    still equal eager; the programs recorded before it stay (later
    phases replay them, phase 13 under torch.profiler).
12. The bench entries, as a user runs them, each in a subprocess from
    the checkout's root: ``python -m ugrt_torch.bench --breakdown``
    (parity gate, chained and fenced step, the five stages) and
    ``--pi-extent --skip-parity``; each must exit 0 with bench.py's JSON
    line last, value > 0, parity_shadow_px <= 16 (the gate must have run
    in the first); the chained step is printed beside phase 6's.  Then
    ``python -m ugrt_torch.micro.bench_reflective`` (windowed reflective
    frame against the base frame), which fails on overflow.  The bench's
    launches: ``bench.main(["--iters", "5", "--skip-parity",
    "--breakdown"])`` and ``bench_reflective.run`` at the flagship in
    this process, the counts of K1-K3, D1 and G1 set to 0 just before
    and read just after (every kernel must have launched).
13. The profiling modules of ugrt_torch.micro, as a user runs them, each
    in a subprocess with its output in a temporary directory:
    ``profile_chain`` (every line item in order with positive host and
    CUDA-event ms, and every statistic); ``capture_trace``, windowed
    and ``--pi-extent``, each followed by ``parse_trace`` on its trace
    (total device time positive; K1's, K2's, K3's and G1's kernels in
    the table, their kernel events counted); ``render_samples`` (both
    PNGs must decode at 1024^2 and 512^2).  Prints each module's
    headline lines and parse_trace's top 25 groups.  The device time and busy share of
    every profile in this script come from micro.parse_trace.
Then one JSON line with the kernels (D1 at the flagship reflective
frame's rays, its launches those of phase 8's 4 frames; G1's two sums
(face_corner_sum, segment_sum) each at its site of phase 6g, its
launches those of phase 6's 5 steps; each
kernel's "bench_launches" those of phase 12's in-process runs,
"profile_launches" K1-K3's and G1's kernel events in phase 13's
windowed and pi-extent traces), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With --dist, under ``python -m torch.distributed.run --standalone
--nproc_per_node=N chip_smoke.py --dist`` on a host with N cards, it
runs instead the sharded path with one rank per card, the NCCL group
started without device_id (dist.mesh.make_mesh must bind each rank to
cuda:LOCAL_RANK), through dist.mesh's captured programs: the flagship
sharded images in windowed, reference and extent mode, two cameras in
turn, bitwise equal to each card's render_color, to the eager body and
to rank 0's; the sharded step on two targets against render_and_grad
(loss rtol 1e-5, gradients within 1e-6 * max|g|, every rank's equal to
rank 0's) and bitwise its eager body (the words that differ and the
largest relative difference are printed); eager body, replay and
bare replay ms in turns for the windowed frame and the step; the NCCL
kernels and busy share of one profiled replayed step;
train(use_mesh=True) 3 steps and a resume to 5 against the same runs on
one card (losses rtol 1e-5, parameters equal on every rank, rank 0
alone checkpointing); host ms per step of train(use_mesh=True) against
train() on one card, in turns; then ``ugrt_torch.bench.main(["--mesh",
N])`` in this process on every rank (the parity gate on each card, the
sharded step timed; rank 0's JSON line must hold value > 0, mesh=N and
parity_shadow_px <= 16), and ``micro.trace_psum_overlap.run`` on every
rank (one profiled replay of the sharded step; at worlds above one every
rank must find an all-reduce kernel).  Rank 0 prints, last the "ok" line.

Imports no JAX and nothing of ugrt.  The scenes are procedural and made
from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Flagship camera and light: bench.py:170-179 (the reference's sibenik
# presets, ugrt/api/cli.py:28-30).
CAMERA = dict(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
              up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = dict(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
             up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
# A second flagship camera, turned a little (phase 11's replays
# alternate the two).
CAMERA_2 = dict(CAMERA, look_at=(13.0, 14.0, 3.2))
CPU_PIXEL_BOUND = 1e-3         # README.md:108-113: knife-edge rays
FRAMES = 4                     # per light mode; frame 1 is the warmup
STEPS = 4                      # timed fwd+bwd steps after one warm-up
GRAD_REL = 1e-5                # card vs CPU gradients, times max|g|
# The rotated Cornell box of tests/test_grad.py:154-182.
CORNELL_ANGLES = (0.11, 0.07)
CORNELL_CAMERA = dict(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                      up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
CORNELL_LIGHT = dict(eye=(0.1, 0.85, 0.4), look_at=(0.0, -1.0, 0.3),
                     up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
# render_color's tensor arguments, in order (dist.mesh's programs).
FRAME_KEYS = ("vertices", "materials", "faces", "mat_index", "camcoords",
              "light_camcoords", "light_position")
# The 128^2 Cornell frame of phase 4 (tests/conftest.py's cameras).
GENERIC_CAMERA = dict(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                      up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
GENERIC_LIGHT = dict(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                     up=(0.0, 0.0, 1.0), near=0.1, far=100.0)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): f32 and f64 outside the tensor cores, TF32 dense, HBM3.
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_TF32 = 495e12
HBM_BYTES_S = 3.35e12
# f32 operations per (ray, row) test, counted in each kernel body
# (csrc/): sweeps count + - * / sqrt, compares not; S2 its 9-step chain.
FLOPS_K1 = 43       # pvec 9, det 5, 1/det, u 6, qvec 9, v 6, t 6, u+v
FLOPS_K2 = 21       # det, up, vp 5 each, det2, ud, vd, 1/det, t, ud+vd
FLOPS_K3 = 30       # det 5, 1/det, u 6, v 6, t, u+v, t*d 3, |t*d| 6, +eps
FLOPS_S2 = 41       # 1 product, then 8 x (mul, add, mul, sub, abs)
FLOPS_D1 = 46       # tvec 3, pvec 9, det 5, 1/det, u 6, qvec 9, v 6, t 6,
                    # u+v (the DDA's own steps not counted)
FLOPS_G1 = 3        # f64 per value: |v| and its sum, the scaling product
NO_LIBRARY = {
    "primary_sweep": "no single PyTorch call computes a per-ray lex-min "
                     "(t, face) over cell-keyed triangle windows",
    "heavy_primary_sweep": "no single PyTorch call computes a per-ray "
                           "lex-min (t, face) over footprint-gated faces",
    "shadow_sweep": "no single PyTorch call computes a per-ray OR of "
                    "cell- or box-gated occlusion tests",
    "tile_sweep": "no single PyTorch call computes the 9-step chain's "
                  "min and first argmin over gathered tiles",
    "heavy_sweep": "no single PyTorch call computes a per-ray lex-min "
                   "(t, face) over footprint-gated faces",
    "uniform_dda": "no single PyTorch call walks rays through a uniform "
                   "grid and takes each ray's first hit in its cells",
}
# G1's kernels by name (its face-keyed corner sum and its row sum), and
# index_add_'s, which the step must not launch.
G1_KERNELS = {"face_corner_sum": r"face_accumulate_kernel",
              "segment_sum": r"row_accumulate_kernel"}
INDEX_ADD_KERNEL = r"indexFunc"


def say(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters):
    """Mean CUDA-event ms of fn() over ``iters`` calls after one warmup."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Mean host ms that fn() takes to return (it enqueues work on the
    card and does not wait for it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return elapsed


def graph_ms(fn, iters):
    """Mean CUDA-event ms of fn() captured as one CUDA graph and replayed
    ``iters`` times back to back: its device work without the host's
    launch gaps (torch.profiler is not needed for it)."""
    import torch

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


def bound(flops, nbytes, peak=PEAK_F32):
    """(ms, "operations" or "bytes"): the least time of the work at the
    card's published rates."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def keyed_tests(tri, key_col, rays, ray_key_col, only=None):
    """Sum over rays (those where the [NB, 128] mask ``only`` holds, if
    given) of the real rows (not all-zero coefficients) whose cell key
    equals the ray's."""
    import torch

    rows = tri.reshape(-1, tri.shape[-1])
    real = rows[:, :key_col].abs().amax(dim=1) > 0
    keys = rows[:, key_col].long()
    rk = rays.reshape(-1, rays.shape[-1])[:, ray_key_col].long()
    size = int(max(int(keys.max()), int(rk.max()), 0)) + 1
    counts = torch.bincount(keys[real & (keys >= 0)], minlength=size)
    keep = rk >= 0
    if only is not None:
        keep &= only.reshape(-1)
    return int(counts[rk[keep]].sum())


def box_tests(boxes, rays, gx_col, grid, only=None):
    """Sum over rays (those where the [NB, 128] mask ``only`` holds, if
    given) of the rows whose footprint box (x0, x1, y0, y1) holds the
    ray's cell (gx, gy), by a summed-area table of the rays' cells; empty
    boxes (x0 > x1) count nothing."""
    import torch

    r = rays.reshape(-1, rays.shape[-1])
    gx, gy = r[:, gx_col].long(), r[:, gx_col + 1].long()
    ok = (gx >= 0) & (gx < grid) & (gy >= 0) & (gy < grid)
    if only is not None:
        ok &= only.reshape(-1)
    hist = torch.bincount(gx[ok] * grid + gy[ok], minlength=grid * grid)
    sat = torch.zeros((grid + 1, grid + 1), dtype=torch.int64,
                      device=rays.device)
    sat[1:, 1:] = hist.reshape(grid, grid).cumsum(0).cumsum(1)
    b = boxes.reshape(-1, 4).long()
    x0, x1 = b[:, 0].clamp(0, grid - 1), b[:, 1].clamp(-1, grid - 1)
    y0, y1 = b[:, 2].clamp(0, grid - 1), b[:, 3].clamp(-1, grid - 1)
    live = (x0 <= x1) & (y0 <= y1)
    x0, x1, y0, y1 = (v[live] for v in (x0, x1, y0, y1))
    return int((sat[x1 + 1, y1 + 1] - sat[x0, y1 + 1] - sat[x1 + 1, y0]
                + sat[x0, y0]).sum())


def window_walk(w_lo, w_hi, nw):
    """Windows the ranges walk, clamped as the kernels clamp them."""
    import torch

    n = torch.clamp(w_hi.long(), max=nw - 1) - torch.clamp(w_lo.long(),
                                                           min=0) + 1
    return n.clamp(min=0)


def sweep_work(site, args, kw, grid, out):
    """(needed tests, walked tests, flops, bytes, what the work is) of one
    captured sweep call, whose plain version returned ``out``.  K1 and K2
    need every admitted test (a lex-min); K3, an OR, needs every admitted
    test of the rays no row occludes and one test of each shadowed ray.
    Walked tests are the lane slots of the warp steps that each kernel's
    counting build reports it ran."""
    if site.startswith("primary_sweep"):
        from ugrt_torch.kernels import _plain
        from ugrt_torch.kernels import primary_sweep as k1

        tri, rays, w_lo, w_hi = args
        walk = window_walk(w_lo, w_hi, tri.shape[0])
        need = keyed_tests(tri, 9, rays, 3)
        chunk = kw.get("chunk", 1)
        stats = k1.primary_sweep_stats(*args, **kw)
        items = int(_plain.chunk_item_end(w_lo, w_hi, tri.shape[0],
                                          chunk)[-1])
        out = rays.shape[0] * 128 * 8
        return (need, stats["tested"], need * FLOPS_K1,
                nbytes(*args) + out,
                f"{int(walk.sum())} block x window pairs, longest range "
                f"{int(walk.max())} windows; chunk {chunk}: {items} work "
                f"items; warps skip {stats['skipped']} tests at the key "
                f"vote")
    if site.startswith("heavy_primary_sweep"):
        from ugrt_torch.kernels import heavy_primary_sweep as k2

        count, table, rays = args
        need = box_tests(table[10:14].T, rays, 4, grid)
        live = min(-(-int(count) // 128), table.shape[1] // 128)
        stats = k2.heavy_primary_sweep_stats(*args, **kw)
        walked = live * 128 * rays.shape[0] * 128 - stats["skipped_footprint"]
        out = rays.shape[0] * 128 * 8
        return (need, walked, need * FLOPS_K2, nbytes(*args) + out,
                f"every block x {live} live windows; warps skip "
                f"{stats['skipped_footprint']} tests at the footprint, "
                f"{stats['skipped_before_division']} at the t-free vote and "
                f"{stats['skipped_could_not_win']} at the could-win vote; "
                f"{stats['divided']} tests take the division")
    from ugrt_torch.kernels import shadow_sweep as k3

    tri, rays, w_lo, w_hi = args
    walk = window_walk(w_lo, w_hi, tri.shape[0])
    shadowed = out[0] != 0
    if kw.get("box"):
        need = box_tests(tri[..., 11:15], rays, 5, grid, only=~shadowed)
    else:
        need = keyed_tests(tri, 10, rays, 4, only=~shadowed)
    need += int(shadowed.sum())
    stats = k3.shadow_sweep_stats(*args, **kw)
    walked = 32 * stats["executed_steps"]
    return (need, walked, need * FLOPS_K3,
            nbytes(*args) + rays.shape[0] * 128 * 4,
            f"{int(walk.sum())} block x window pairs, max "
            f"{int(walk.max())} per block; counts {stats}")


def kernel_name(mangled):
    """``name<args>`` of a mangled kernel name with int and bool template
    arguments, or the name as given where it does not parse (e.g.
    ``_ZN41_GLOBAL__N__..._cu_aececa1420primary_sweep_kernelILb0EEEv...``
    -> ``primary_sweep_kernel<false>``, ``...heavy_v3_kernelILi8ELi4ELb1E
    EEv...`` -> ``heavy_v3_kernel<8, 4, true>``)."""
    m = re.match(r"_ZN?", mangled)
    pos, name = (m.end() if m else 0), None
    while m and (n := re.match(r"\d+", mangled[pos:])):
        start = pos + n.end()
        part = mangled[start:start + int(n.group())]
        pos = start + len(part)
        if not part.startswith("_GLOBAL__N"):
            name = part
    if not name:
        return mangled
    targs = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if not targs:
        return name
    args = re.findall(r"L([ib])(\d+)E", targs.group(1))
    return name + "<" + ", ".join(
        v if t == "i" else ("true" if v == "1" else "false")
        for t, v in args) + ">"


def ptxas_kernels(text):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    nvcc's -Xptxas -v output."""
    out, fn, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append((fn, int(m.group(1)), *spill))
            fn = None
    return out


def capture_sweep_inputs(render, prefix=""):
    """Run render() once with each sweep wrapper wrapped by a recorder;
    return {site: (wrapper, plain, args, kwargs)} with cloned inputs."""
    import torch

    from ugrt_torch.kernels import heavy_primary_sweep as k2
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.trace import primary as tprimary
    from ugrt_torch.trace import shadow as tshadow

    sites = {}
    patches = [(tprimary, "primary_sweep", k1.primary_sweep_plain),
               (tprimary, "heavy_primary_sweep",
                k2.heavy_primary_sweep_plain),
               (tshadow, "shadow_sweep", k3.shadow_sweep_plain)]

    def recorder(name, fn, plain):
        def record(*args, **kwargs):
            site = prefix + name + (" box=True" if kwargs.get("box") else "")
            if site not in sites:
                sites[site] = (fn, plain, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return record

    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for (mod, name, fn), (_, _, plain) in zip(originals, patches):
            setattr(mod, name, recorder(name, fn, plain))
        render()
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return sites


def kernel_phase(scene, flagship, camera, light):
    """Phase 3: every sweep kernel against its plain version on the
    inputs the flagship frames give it (and K3 on the synthetic cases).
    Returns {site: record}."""
    import torch

    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.micro.k3_chunks import (device_ms, reference_case,
                                            skewed_case, skewed_primary_case)

    sites = {}
    for mode, prefix in (("windowed", ""), ("reference", "reference: ")):
        r = Renderer(scene, dataclasses.replace(flagship,
                                                light_grid_mode=mode),
                     device="cuda")
        sites.update(capture_sweep_inputs(
            lambda: r.render(camera, [light], light.eye, use_spot=True),
            prefix))
        del r
    expect = {"primary_sweep", "heavy_primary_sweep", "shadow_sweep",
              "shadow_sweep box=True"}
    if not expect <= set(sites):
        fail(f"phase 3: sweep sites seen {sorted(sites)}, expected "
             f"{sorted(expect)}")
    for chunk in (1, 2, 4, 8):
        sites[f"primary_sweep skewed chunk={chunk}"] = (
            k1.primary_sweep, k1.primary_sweep_plain,
            skewed_primary_case("cuda", 0), dict(cfg=flagship, chunk=chunk))
    # K3's synthetic cases in both walks; the reference-like case at
    # every chunk size in the walk the reference grid's key site takes.
    for name, occ in (("skewed", False), ("skewed all-occluded", True)):
        for serial in (False, True):
            sites[f"shadow_sweep {name}{' serial' if serial else ''}"] = (
                k3.shadow_sweep, k3.shadow_sweep_plain,
                skewed_case("cuda", 0, occ), dict(cfg=flagship,
                                                  serial=serial))
    for chunk in (1, 2, 4, 8):
        sites[f"shadow_sweep reference-like chunk={chunk}"] = (
            k3.shadow_sweep, k3.shadow_sweep_plain,
            reference_case("cuda", 0),
            dict(cfg=flagship, chunk=chunk, serial=True))

    results = {}
    for site, (fn, plain, a, kw) in sites.items():
        out_k = fn(*a, **kw)
        out_p = plain(*a, **kw)
        torch.cuda.synchronize()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        mism = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   if x.dtype == torch.float32 else int((x != y).sum())
                   for x, y in zip(out_k, out_p))
        err = max(float((x.double() - y.double()).abs().max())
                  for x, y in zip(out_k, out_p))
        ms = cuda_ms(lambda: fn(*a, **kw), 20)
        kernel_ms = sum(v for k, v in device_ms(lambda: fn(*a, **kw)).items()
                        if "sweep" in k)
        host = host_ms(lambda: fn(*a, **kw), 20)
        # The plain versions are timed on the frames' sites only (they
        # walk every item): the windowed frame's, which the kernels line
        # sums, and K3's at the reference grid's key site.
        plain_ms = (cuda_ms(lambda: plain(*a, **kw), 2)
                    if site in expect or site == "reference: shadow_sweep"
                    else float("nan"))
        need, walked, flops, nbyte, items = sweep_work(site.split(": ")[-1],
                                                       a, kw,
                                                       flagship.grid_x, out_p)
        b_ms, b_by = bound(flops, nbyte)
        shapes = ", ".join("x".join(str(d) for d in x.shape) or "scalar"
                           for x in a if isinstance(x, torch.Tensor))
        say(f"phase 3: {site} ({shapes}; {items}): {mism} mismatches, max "
            f"|diff| {err}, kernel {ms:.4f} ms (its CUDA kernel alone "
            f"{kernel_ms:.4f} ms, host {host:.4f} ms per call), plain "
            f"{plain_ms:.3f} ms; "
            f"needed tests {need}, walked {walked} "
            f"({walked / max(need, 1):.2f}x); {flops} flops, {nbyte} bytes: "
            f"bound {b_ms:.5f} ms by {b_by} ({100 * b_ms / ms:.1f}% of the "
            f"kernel's time)")
        if mism:
            fail(f"phase 3: {site} disagrees with its plain version")
        results[site] = dict(ms=ms, kernel_ms=kernel_ms, host_ms=host,
                             plain_ms=plain_ms, max_abs_err=err,
                             bound_ms=b_ms, bound_by=b_by, needed_tests=need,
                             walked_tests=walked)
    return results


def same_bits(a, b):
    """Equal shape and dtype, and equal values, NaN where the other is."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def bin_phase(scene, flagship, camera, light):
    """Phase 3b: B1 against its plain version on the flagship frame's
    rays, and its ms beside the plain chain's.  Returns {site: record}."""
    import torch

    from ugrt_torch import bridge
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.kernels import shadow_bin as b1
    from ugrt_torch.kernels import shadow_tris as b2
    from ugrt_torch.trace import primary as tprimary
    from ugrt_torch.trace import shadow as tshadow

    dev = torch.device("cuda")
    x = bridge.scene_to_torch(scene, dev)
    v, f = x["vertices"], x["faces"]
    cfg = flagship
    cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, 1.0, dev)
    lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, 1.0, dev)
    eye = cc[0:3]
    grid = gbuild.build_perspective_grid(
        v, f, cc, cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces))
    full = tprimary.trace_primary(v, f, cc, grid, cfg)
    full = {k: full[k] for k in ("t", "ray_dir")}
    odd = {k: full[k][:1000, :999].contiguous() for k in full}
    odd["t"].view(-1)[::97] = float("nan")
    odd["t"].view(-1)[5::211] = float("inf")
    results = {}
    for label, prim in (("flagship", full), ("ragged 1000x999", odd)):
        n = prim["t"].numel()
        (bk, ak), (bp, ap) = (fn(prim, eye, lcc) for fn in (
            b1.window_angles, b1.window_angles_plain))
        bad = [name for name, g, w in (
            ("bounds", torch.stack(bk), torch.stack(bp)), ("sx", ak[0], ap[0]),
            ("sy", ak[1], ap[1])) if not same_bits(g, w)]
        window = tshadow.apply_window_margin(*bk)
        ext = tshadow.light_extents(prim, eye, lcc, cfg)
        cases = {"reference": {}, "extent": dict(x_max=ext[0], y_max=ext[1]),
                 "windowed": dict(window=window),
                 "windowed, angles": dict(window=window, angles=ak)}
        for mode, kw in cases.items():
            got = b1.shadow_rays(prim, eye, lcc, cfg, **kw)
            want = b1.shadow_rays_plain(prim, eye, lcc, cfg, **kw)
            bad += [f"{mode} {name}" for name, g, w in zip(
                got._fields, got, want) if not same_bits(g, w)]
            flags = torch.randint(
                0, 2, got.first_cell.shape + (128,), dtype=torch.int32,
                generator=torch.Generator().manual_seed(5)).to(dev)
            if not same_bits(b1.unpermute(flags, got.perm),
                             b1.unpermute_plain(flags, want.perm)):
                bad.append(f"{mode} unpermute")
            cells = int((got.scells[:n] < cfg.cell_sentinel).sum())
            distinct = int(torch.unique(got.scells[:n]).numel())
            record = dict(rays=n, in_grid=cells, distinct_cells=distinct)
            if label == "flagship":
                nb = got.first_cell.numel()
                rays_ms = graph_ms(lambda: b1.shadow_rays(
                    prim, eye, lcc, cfg, **kw), 20)
                plain_ms = graph_ms(lambda: b1.shadow_rays_plain(
                    prim, eye, lcc, cfg, **kw), 20)
                # t and dir (or the angles) in, rows, keys and ids out.
                nbyte = (nbytes(prim["t"], prim["ray_dir"])
                         + nb * 128 * (32 + 4) + 4 * n
                         + (8 * n if "angles" in kw else 0))
                b_ms, b_by = bound(0, nbyte)
                up_ms = graph_ms(lambda: b1.unpermute(flags, got.perm), 20)
                up_plain = graph_ms(lambda: b1.unpermute_plain(
                    flags, want.perm), 20)
                record.update(ms=rays_ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, unpermute_ms=up_ms,
                              unpermute_plain_ms=up_plain)
                say(f"phase 3b: B1 {mode}: {n} rays, {cells} in the grid, "
                    f"{distinct} distinct cells: shadow_rays {rays_ms:.4f} ms "
                    f"(replayed graph), plain chain {plain_ms:.4f} ms; "
                    f"{nbyte} bytes: bound {b_ms:.5f} ms by {b_by} "
                    f"({100 * b_ms / rays_ms:.1f}%); unpermute {up_ms:.4f} "
                    f"ms, plain {up_plain:.4f} ms")
                # B2 on this mode's light grid and B1's blocks.
                lgrid = gbuild.build_spherical_grid(
                    v, f, lcc, cfg=cfg,
                    capacity=cfg.pair_capacity(scene.num_faces),
                    **{k: a for k, a in kw.items() if k != "angles"})
                targs = (v, f, lgrid, lcc, got.first_cell, got.last_real,
                         cfg)
                tg, tp = b2.shadow_tris(*targs), b2.shadow_tris_plain(*targs)
                bad += [f"{mode} B2 {name}" for name, g, w in zip(
                    tg._fields, tg, tp) if not same_bits(g, w)]
                tris_ms = graph_ms(lambda: b2.shadow_tris(*targs), 20)
                tris_plain = graph_ms(lambda: b2.shadow_tris_plain(*targs),
                                      20)
                # Each pair slot's face and key in, its row out; the heavy
                # slots' rows; two cells and the ranges of each block.
                tbyte = (nbytes(lgrid.sorted_faces, lgrid.sorted_keys,
                                tg.tri_w, tg.tri_hw, lgrid.heavy_ranges)
                         + nb * (4 * 4 + 4 * 4))
                tb_ms, tb_by = bound(0, tbyte)
                record.update(tris_ms=tris_ms, tris_plain_ms=tris_plain,
                              tris_bound_ms=tb_ms,
                              pairs=int(lgrid.total_pairs),
                              heavy=int(lgrid.heavy_count))
                say(f"phase 3b: B2 {mode}: {int(lgrid.total_pairs)} pairs "
                    f"of {lgrid.sorted_faces.numel()}, "
                    f"{int(lgrid.heavy_count)} heavy: shadow_tris "
                    f"{tris_ms:.4f} ms (replayed graph), plain chain "
                    f"{tris_plain:.4f} ms; {tbyte} bytes: bound "
                    f"{tb_ms:.5f} ms by {tb_by} "
                    f"({100 * tb_ms / tris_ms:.1f}%)")
            results[f"{label}: {mode}"] = record
        if label == "flagship":
            w_ms = graph_ms(lambda: b1.window_angles(prim, eye, lcc), 20)
            w_plain = graph_ms(lambda: b1.window_angles_plain(
                prim, eye, lcc), 20)
            b_ms, b_by = bound(0, nbytes(prim["t"], prim["ray_dir"])
                               + 8 * prim["t"].numel())
            say(f"phase 3b: B1 window_angles {w_ms:.4f} ms, plain "
                f"{w_plain:.4f} ms; bound {b_ms:.5f} ms by {b_by}")
            results[f"{label}: window_angles"] = dict(
                ms=w_ms, plain_ms=w_plain, bound_ms=b_ms, bound_by=b_by)
        say(f"phase 3b: {label} ({n} rays): {len(bad)} fields differ "
            f"from the plain version {bad}")
        if bad:
            fail(f"phase 3b: B1 or B2 disagrees with its plain version: "
                 f"{bad}")
    return results


def trace_events(prof):
    """The device events of a finished torch.profiler run, read back from
    its Chrome trace by micro.parse_trace (the one aggregation of device
    time; its "# path" line on stderr is dropped)."""
    import tempfile

    from ugrt_torch.micro import parse_trace

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "profile.pt.trace.json")
        prof.export_chrome_trace(path)
        with contextlib.redirect_stderr(io.StringIO()):
            return parse_trace.device_events(parse_trace.load(path))


def profile_once(label, fn, top_n=8):
    """torch.profiler over one call of fn(): prints its host ms, the
    device time (micro.parse_trace.aggregate) and its busy share of the
    device span (first device event to last) and of the host ms, the
    device events and the top groups by device time.  Returns the names
    of the device events (kernels, copies) that ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ugrt_torch.micro import parse_trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = trace_events(prof)
    s = parse_trace.aggregate(events)
    say(f"profile: {label}: {wall_ms:.3f} ms host (profiled), device busy "
        f"{s.total_ms:.3f} ms ({100 * s.busy:.1f}% of the device span "
        f"{s.span_ms:.3f} ms; {100 * s.total_ms / wall_ms:.1f}% of the host "
        f"ms), {len(events)} kernel launches; top: "
        + "; ".join(f"{k[:48]} {v:.3f} ms x{c}" for k, v, c in s.rows[:top_n]))
    return sorted({e["name"] for e in events})


def profile_frames(scene, flagship, camera, light, lp):
    """One steady spot frame per light mode under torch.profiler."""
    from ugrt_torch.api.renderer import Renderer

    for mode in ("windowed", "reference"):
        r = Renderer(scene, dataclasses.replace(flagship,
                                                light_grid_mode=mode),
                     device="cuda")
        for _ in range(2):
            r.render(camera, [light], lp)
        profile_once(f"{mode}: frame", lambda: r.render(camera, [light], lp))


def rotated_cornell():
    """procedural.cornell_box(subdiv=2) turned a few degrees about x and
    y, so that no wall is axis-aligned (tests/test_grad.py:154-170)."""
    import numpy as np

    from ugrt_torch.scene import procedural

    sc = procedural.cornell_box(subdiv=2)
    a, b = CORNELL_ANGLES
    rx = np.asarray([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], dtype=np.float32)
    ry = np.asarray([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                     [-np.sin(b), 0, np.cos(b)]], dtype=np.float32)
    return dataclasses.replace(sc, vertices=np.ascontiguousarray(
        sc.vertices @ (rx @ ry).T))


def step_inputs(scene, cfg, camera, light, device):
    """render_and_grad's arguments for one light, zero target."""
    import numpy as np
    import torch

    from ugrt_torch import bridge

    t = bridge.scene_to_torch(scene, device)
    aspect = cfg.screen_width / cfg.screen_height
    cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, aspect, device)
    lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, aspect, device)
    return dict(vertices=t["vertices"], materials=t["materials"],
                faces=t["faces"], mat_index=t["mat_index"], camcoords=cc,
                light_camcoords=lcc[None],
                light_position=bridge.from_numpy(light.eye, device,
                                                 np.float32),
                target=torch.zeros((cfg.screen_height, cfg.screen_width, 3),
                                   dtype=torch.float32, device=device))


def step_phase(scene, flagship, camera, light, kernels):
    """Phase 6: the fwd+bwd step on the card.  Returns the launches of
    each K kernel over the warm-up and timed steps, and the steady ms."""
    import torch

    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.diff.render_grad import render_and_grad

    cfg = dataclasses.replace(flagship, light_grid_mode="windowed")
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    args = step_inputs(scene, cfg, camera, light, "cuda")

    def step():
        return render_and_grad(**args, **kw)

    for k in kernels.values():
        k.launches = 0
    times, outs = [], []
    for i in range(STEPS + 1):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = step()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - h0) * 1e3
        ev = start.elapsed_time(end)
        gv, gm = out["grad_vertices"], out["grad_materials"]
        loss, ovf = float(out["loss"]), bool(out["overflow"])
        say(f"phase 6: step {i}{' (warm-up)' if i == 0 else ''}: {ev:.3f} "
            f"ms (CUDA events), {wall:.3f} ms host; loss {loss!r}; "
            f"|grad_v|_1 {float(gv.abs().sum())!r}; |grad_m|_1 "
            f"{float(gm.abs().sum())!r}; overflow {ovf}")
        if ovf or not all(bool(torch.isfinite(x).all())
                          for x in (out["loss"], out["color"], gv, gm)):
            fail("phase 6: overflow or a non-finite value in the step")
        if not (gv.abs().sum() > 0 and gm.abs().sum() > 0):
            fail("phase 6: a gradient is all zero")
        if i:
            times.append(ev)
        if i <= 2:
            outs.append(out)
    launches = {name: k.launches for name, k in kernels.items()}
    same = all(torch.equal(outs[1][k], outs[2][k])
               for k in ("loss", "color", "grad_vertices", "grad_materials"))
    say(f"phase 6: launches over {STEPS + 1} steps {launches}; steady "
        f"{sum(times) / len(times):.3f} ms per step "
        f"({1024 * 1024 / (sum(times) / len(times)) / 1e3:.3f} M primary "
        f"rays/s fwd+bwd); two identical steps bitwise equal: {same}")
    if min(launches.values()) <= 0:
        fail("phase 6: a kernel of the step was never launched")
    if not same:
        fail("phase 6: two identical steps differ")
    del outs

    names = profile_once("step", step, top_n=10)
    g1_seen = {k: [n for n in names if re.search(pat, n)]
               for k, pat in G1_KERNELS.items()}
    index_add = [n for n in names if re.search(INDEX_ADD_KERNEL, n)]
    say(f"phase 6: G1 kernels in the profiled step {g1_seen}, index_add_ "
        f"kernels {len(index_add)}")
    if not all(g1_seen.values()) or index_add:
        fail("phase 6: the step's gather backward did not run both of G1's "
             "sums, or ran index_add_")

    # The rotated Cornell box at 64^2, card against CPU.
    small = dataclasses.replace(flagship, screen_width=64, screen_height=64,
                                grid_x=8, grid_y=8)
    box = rotated_cornell()
    kw = dict(cfg=small, capacity=small.pair_capacity(box.num_faces),
              num_lights=1, use_spot=True)
    c_cam = CameraSpec(**CORNELL_CAMERA)
    c_light = CameraSpec(**CORNELL_LIGHT)
    got, want = (render_and_grad(**step_inputs(box, small, c_cam, c_light, d),
                                 **kw) for d in ("cuda", "cpu"))
    loss_g, loss_w = float(got["loss"]), float(want["loss"])
    errs = {}
    for k in ("grad_vertices", "grad_materials"):
        g, w = got[k].cpu().double(), want[k].double()
        errs[k] = float((g - w).abs().max() / w.abs().max())
    color_px = int((got["color"].cpu() != want["color"]).any(-1).sum())
    say(f"phase 6: cornell 64^2 card vs CPU: loss {loss_g!r} vs {loss_w!r}; "
        f"max |diff| / max|g|: {errs}; color px differ {color_px}")
    if (abs(loss_g - loss_w) > 1e-7 + 1e-5 * abs(loss_w)
            or max(errs.values()) > GRAD_REL):
        fail("phase 6: the step on the card disagrees with the CPU")
    return launches, sum(times) / len(times)


def read_once(case):
    """The tensors that a G1 sum over ``case`` must read: all of a
    material sum's inputs; of a face-keyed sum's faces table, only the
    rows of the faces that occur (their vertex ids are read at a flush,
    the rest never)."""
    import torch

    if len(case) != 4:
        return case[:-1]
    values, fid, faces, _ = case
    used = torch.unique(fid)
    used = used[(used >= 0) & (used < faces.shape[0])]
    return values, fid, faces[used]


def gather_phase(scene, flagship, camera, light, seed):
    """Phase 6g: G1, the step's two fixed-point sums: the corner sum
    keyed by face (face_corner_sum, the backward of gather_face_data)
    and the material sum (segment_sum, gather_rows's).  Their inputs
    from one eager windowed step; each kernel bitwise its plain version
    on them and on micro.gather_bwd's skewed and face cases, twice each;
    CUDA-event ms of the kernel's wrapper, of the plain version and of
    index_add_ of the fixed-point values alone (the library yardstick),
    of the wrapper's kernels replayed as one CUDA graph, and the bound.
    Returns {site: result}."""
    import torch

    from ugrt_torch.kernels import segment_sum as g1
    from ugrt_torch.micro import gather_bwd

    cfg = dataclasses.replace(flagship, light_grid_mode="windowed")
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    args = step_inputs(scene, cfg, camera, light, "cuda")
    sites = gather_bwd.record_inputs(args, kw)
    if sorted(sites) != ["corner", "material"] or len(sites["corner"]) != 4:
        fail(f"phase 6g: the step's sums were {sorted(sites)}, the corner "
             "sum not keyed by face")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def mismatches(got, want):
        return int((got.view(torch.int32) != want.view(torch.int32)).sum())

    results, bad = {}, []
    for name, case in sorted(sites.items()):
        fn, plain = gather_bwd.sums(case)
        want = plain(*case)
        got = fn(*case)
        again = fn(*case)
        mism = mismatches(got, want) + mismatches(again, want)
        ms = cuda_ms(lambda: fn(*case), 20)
        kernel_ms = graph_ms(lambda: fn(*case), 20)
        plain_ms = cuda_ms(lambda: plain(*case), 5)
        library_ms = cuda_ms(gather_bwd.index_add_call(case, g1.fixed_point),
                             10)
        b_ms, b_by = bound(FLOPS_G1 * case[0].numel(),
                           nbytes(*read_once(case), want), peak=PEAK_F64)
        prof = gather_bwd.profile(case, sms)
        table = g1.table(prof["keys"], prof["columns"])
        results[name] = dict(
            shape=[list(case[0].shape), case[-1]], table=table,
            mismatches=mism,
            max_abs_err=float((got.double() - want.double()).abs().max()),
            ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            profile=prof)
        say(f"phase 6g: G1 {name} ({tuple(case[0].shape)}, {prof['keys']} "
            f"keys into {case[-1]} rows, {table} table): {mism} bits differ "
            f"over two launches; {ms:.4f} ms (CUDA events; {kernel_ms:.4f} "
            f"replayed as a CUDA graph: its kernels alone), plain "
            f"{plain_ms:.4f}, index_add_ alone {library_ms:.4f}; bound "
            f"{b_ms:.4f} ms ({b_by}); {prof['distinct_keys_per_step']:.3f} "
            f"distinct keys a 32-element step (at most "
            f"{prof['distinct_keys_per_step_max']}), {prof['one_key_steps']} "
            f"steps of one key and {prof['mixed_steps']} of several of "
            f"{prof['steps']}, {prof['carried_runs']} carried runs, "
            f"{prof['flushes']} flushes, {prof['table_additions']} table "
            f"and {prof['global_additions']} global additions; "
            f"{prof['keys_touched']} keys and {prof['rows_touched']} rows "
            f"touched; {prof['zero_contributions']} of "
            f"{prof['contributions']} contributions zero")
        if mism:
            bad.append(name)
    cases = dict(gather_bwd.skewed_cases("cuda", seed))
    cases.update({f"face: {k}": c for k, c in
                  gather_bwd.face_cases("cuda", seed).items()})
    for name, case in cases.items():
        fn, plain = gather_bwd.sums(case)
        want = plain(*case)
        mism = sum(mismatches(fn(*case), want) for _ in range(2))
        say(f"phase 6g: G1 {name} ({tuple(case[0].shape)} into {case[-1]} "
            f"rows): {mism} bits differ over two launches")
        if mism:
            bad.append(name)
    if bad:
        fail(f"phase 6g: G1 disagrees with its plain version on {bad}")
    del sites, cases
    torch.cuda.empty_cache()
    return results


# Phase 7: each probe kernel, the TPU kernel it replaces, and the variant
# whose times the kernels line reports.
PROBES = [
    ("coeff_mt_mma", "micro_mxu", "ugrt_torch/csrc/coeff_mt.cu",
     "scripts/micro_mxu.py:26", "highest"),
    ("coeff_mt_fma", "micro_mxu", "ugrt_torch/csrc/coeff_mt.cu",
     "scripts/micro_mxu.py:46", "3-term f32"),
    ("tile_sweep", "pallas_micro", "ugrt_torch/csrc/tile_pipeline.cu",
     "scripts/pallas_micro.py:29", "full wchunk=8"),
    ("heavy_sweep_v1", "micro_heavy", "ugrt_torch/csrc/heavy_variants.cu",
     "scripts/micro_heavy.py:105", "mb=8"),
    ("heavy_sweep_v2", "micro_heavy", "ugrt_torch/csrc/heavy_variants.cu",
     "scripts/micro_heavy.py:136", "mb=8"),
    ("heavy_sweep_v3", "micro_heavy", "ugrt_torch/csrc/heavy_variants.cu",
     "scripts/micro_heavy.py:169", "mb=8"),
]


def probe_work(mod, workload):
    """{kernel: (flops, bytes, peak, library_ms, extra)} of a probe's
    workload at its script's size: the bound's inputs and, for S1, the
    torch.bmm yardstick of its three products."""
    import torch

    if mod == "micro_mxu":
        items, tri, rays = workload
        n, pairs = items.shape[0], items.shape[0] * 256 * 128
        out = 3 * pairs * 4
        read = nbytes(tri) + nbytes(rays)
        # [3n, 256, 8] . [3n, 8, 128]: the three products per item.
        a = tri[items.long()].reshape(n, 3, 8, 256).transpose(2, 3).reshape(
            3 * n, 256, 8).contiguous()
        b = rays[items.long() % rays.shape[0]][:, None].expand(
            n, 3, 8, 128).reshape(3 * n, 8, 128).contiguous()
        def whole():
            """S1's function in PyTorch: the products, then u and v."""
            p = torch.bmm(a, b).view(n, 3, 256, 128)
            inv = 1.0 / p[:, 0]
            return p[:, 0], p[:, 1] * inv, p[:, 2] * inv

        lib = {}
        for name, tf32 in (("highest", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            lib[name] = cuda_ms(lambda: torch.bmm(a, b), 5)
            lib[f"whole_{name}"] = cuda_ms(whole, 5)
        torch.backends.cuda.matmul.allow_tf32 = False
        del a, b
        torch.cuda.empty_cache()
        extra = {"library_tf32_ms": lib["tf32"],
                 "library_whole_ms": lib["whole_highest"],
                 "library_whole_tf32_ms": lib["whole_tf32"]}
        return {"coeff_mt_fma": (pairs * 18, read + out, PEAK_F32,
                                 lib["highest"], extra),
                "coeff_mt_mma": (pairs * 3 * 16, read + out, PEAK_TF32,
                                 lib["highest"], extra)}
    if mod == "pallas_micro":
        offs, tiles, tri, rays = workload
        rows = torch.zeros(tri.shape[0] + 128, dtype=torch.bool,
                           device=tri.device)
        rows[(offs.long()[:, None] + torch.arange(
            128, device=tri.device)).reshape(-1)] = True
        read = (int(rows.sum()) * tri.shape[1] * 4
                + int(torch.unique(tiles).numel()) * 8 * 128 * 4
                + nbytes(offs, tiles))
        n = offs.shape[0]
        flops = n * 128 * 128 * FLOPS_S2
        # Each item copies its whole tile and ray tile, as the script's
        # DMAs do: the copy floor counts those bytes, not the table's.
        item = (128 * tri.shape[1] + 8 * 128) * 4
        return {"tile_sweep": (flops, read + n * 128 * 8, PEAK_F32, None, {
            "half_rate_floor_ms": flops / (PEAK_F32 / 2) * 1e3,
            "copy_bytes_per_item": item,
            "copy_floor_ms": n * item / HBM_BYTES_S * 1e3})}
    count, table, rays = workload
    need = box_tests(table[10:14].T[:int(count)], rays, 4, 128)
    nbyte = nbytes(table, rays) + rays.shape[0] * 128 * 8
    return {f"heavy_sweep_v{i}": (need * FLOPS_K2, nbyte, PEAK_F32, None, {
        "needed_tests": need,
        "half_rate_floor_ms": need * FLOPS_K2 / (PEAK_F32 / 2) * 1e3})
        for i in (1, 2, 3)}


def probe_phase():
    """Phase 7: run the probes' entry points; returns their kernels-line
    entries."""
    import importlib

    import torch

    mods = {m: importlib.import_module(f"ugrt_torch.micro.{m}")
            for m in ("micro_mxu", "pallas_micro", "micro_heavy")}
    from ugrt_torch.kernels import coeff_mt, heavy_variants, tile_pipeline
    wrappers = {"coeff_mt_mma": coeff_mt.coeff_mt_mma,
                "coeff_mt_fma": coeff_mt.coeff_mt_fma,
                "tile_sweep": tile_pipeline.tile_sweep,
                "heavy_sweep_v1": heavy_variants.heavy_sweep_v1,
                "heavy_sweep_v2": heavy_variants.heavy_sweep_v2,
                "heavy_sweep_v3": heavy_variants.heavy_sweep_v3}
    for w in wrappers.values():
        w.launches = 0
    records, work = [], {}
    for name, mod in mods.items():
        t0 = time.perf_counter()
        workload = mod.make_workload(torch.device("cuda"))
        recs = mod.run(workload=workload)
        work.update(probe_work(name, workload))
        del workload
        torch.cuda.empty_cache()
        for r in recs:
            extra = "".join(f", {k} {v!r}" for k, v in r.items() if k not in (
                "kernel", "variant", "mismatches", "max_abs_err", "ms",
                "plain_ms"))
            say(f"phase 7: {name}: {r['kernel']} {r['variant']}: "
                f"{r['mismatches']} mismatches, max |diff| "
                f"{r['max_abs_err']!r}{extra}; {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms")
        say(f"phase 7: {name} took {time.perf_counter() - t0:.1f} s")
        records += recs
    launches = {n: w.launches for n, w in wrappers.items()}
    say(f"phase 7: launches {launches}")
    if any(r["mismatches"] for r in records):
        fail("phase 7: a probe kernel disagrees with its plain version")
    if min(launches.values()) <= 0:
        fail("phase 7: a probe kernel was never launched")
    entries = []
    for name, _, source, replaces, main_variant in PROBES:
        recs = [r for r in records if r["kernel"] == name]
        main = next(r for r in recs if r["variant"] == main_variant)
        flops, nbyte, peak, lib_ms, extra = work[name]
        b_ms, b_by = bound(flops, nbyte, peak)
        say(f"phase 7: {name}: {flops} flops, {nbyte} bytes: bound "
            f"{b_ms:.5f} ms by {b_by}; {main['ms']:.4f} ms"
            + (f"; torch.bmm {lib_ms:.4f} ms (highest), "
               f"{extra['library_tf32_ms']:.4f} ms (TF32); the whole "
               f"function (bmm, then u and v) "
               f"{extra['library_whole_ms']:.4f} ms (highest), "
               f"{extra['library_whole_tf32_ms']:.4f} ms (TF32)"
               if lib_ms else "")
            + "".join(f"; {k} {extra[k]!r}" for k in (
                "half_rate_floor_ms", "copy_bytes_per_item", "copy_floor_ms")
                      if k in extra))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            **({} if lib_ms else {"library_none": NO_LIBRARY[
                "heavy_sweep" if name.startswith("heavy") else name]}),
            **extra, "variant": main_variant,
            "variants": {r["variant"]: r["ms"] for r in recs},
            **({"warp_counts": main["stats"]} if "stats" in main else {})})
    return entries


def frame_inputs(scene, cfg, camera, light, device):
    """render_frame_reflective's positional arguments for one light, as
    ugrt's CLI builds them (aspect 1)."""
    import numpy as np

    from ugrt_torch import bridge

    t = bridge.scene_to_torch(scene, device)
    cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, 1.0, device)
    return (t["vertices"], t["faces"], t["mat_index"], t["materials"], cc,
            lcc[None], bridge.from_numpy(light.eye, device, np.float32))


def dda_check(label, args, kw, expect_overflow):
    """Phase 8a: D1 against its plain version on ``args`` (bitwise t,
    face_id, overflow), timed, with its needed tests, its lane slots on
    staged faces and its bound.  Returns the record."""
    import torch

    from ugrt_torch.kernels import uniform_dda as kdda
    from ugrt_torch.micro.k3_chunks import device_ms

    def run():
        return kdda.uniform_dda(*args, **kw)

    got = run()
    want = kdda.uniform_dda_plain(*args, **kw)
    torch.cuda.synchronize()
    mism = {"t": int((got["t"].view(torch.int32)
                      != want["t"].view(torch.int32)).sum()),
            "face_id": int((got["face_id"] != want["face_id"]).sum()),
            "overflow": int(bool(got["overflow"]) != bool(want["overflow"]))}
    err = float((got["t"].double() - want["t"].double()).abs().max())
    ms = cuda_ms(run, 20)
    # The kernel alone (torch.profiler); a profile that lists no D1
    # kernel is taken again, and after three the time is not measured.
    kernel_ms = None
    for _ in range(3):
        kernel_ms = sum(v for k, v in device_ms(run).items()
                        if "uniform_dda" in k) or None
        if kernel_ms:
            break
    host = host_ms(run, 20)
    plain_ms = cuda_ms(lambda: kdda.uniform_dda_plain(*args, **kw), 2)
    stats = kdda.uniform_dda_stats(*args, **kw)
    ftab, grid, origins, dirs, active, excl, lo, hi, _ = args
    n = origins.shape[0]
    # Inputs read once (the face table without its pad columns,
    # sorted_faces up to the grid's pairs), outputs written once;
    # operations of the needed tests alone.
    nbyte = (nbytes(grid.cell_count, grid.cell_offset, origins, dirs,
                    active, excl, lo, hi) + 36 * ftab.shape[0]
             + 4 * int(grid.total_pairs) + 8 * n + 8)
    flops = stats["needed"] * FLOPS_D1
    b_ms, b_by = bound(flops, nbyte)
    half_ms = flops / (PEAK_F32 / 2) * 1e3
    hits = int((want["face_id"] >= 0).sum())
    slots = stats["staged_lane_slots"]
    say(f"phase 8a: D1 {label} ({n} rays, {int(active.sum())} active, "
        f"{hits} hit; grid {tuple(args[-1])}, {int(grid.total_pairs)} "
        f"pairs; batches of {kw['batch']} up to {kw['max_batches']}): "
        f"mismatches {mism}, max |diff| {err}, overflow "
        f"{bool(got['overflow'])}; steps {int(got['steps'])} (D1, the CPU's "
        f"count) / {int(want['steps'])} (plain on the card, to its last "
        f"compaction); kernel {ms:.4f} ms (its CUDA kernel alone "
        f"{'not measured' if kernel_ms is None else f'{kernel_ms:.4f}'} ms,"
        f" host {host:.4f} ms per call), plain "
        f"{plain_ms:.3f} ms; needed tests {stats['needed']}, lane slots "
        f"on staged faces {slots} ({slots / max(stats['needed'], 1):.2f}x; "
        f"a per-ray kernel in lockstep would spend "
        f"{stats['lockstep_lane_slots']}); "
        f"{stats['cells']} cells served in {stats['rounds']} warp rounds "
        f"({stats['cells'] / max(stats['rounds'], 1):.3f} distinct cells a "
        f"round); {flops} flops, {nbyte} bytes: bound {b_ms:.5f} ms by "
        f"{b_by} ({100 * b_ms / ms:.1f}% of the kernel's time), half-rate "
        f"floor {half_ms:.5f} ms")
    if any(mism.values()) or bool(got["overflow"]) != expect_overflow:
        fail(f"phase 8a: D1 disagrees with its plain version on {label}, "
             f"or its overflow is not {expect_overflow}")
    return dict(ms=ms, kernel_ms=kernel_ms, host_ms=host, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                half_rate_floor_ms=half_ms, needed_tests=stats["needed"],
                staged_lane_slots=slots,
                lockstep_lane_slots=stats["lockstep_lane_slots"],
                cells_per_round=stats["cells"] / max(stats["rounds"], 1),
                steps=int(got["steps"]))


def reflect_phase(scene, flagship, camera, light, kernels):
    """Phase 8: the reflective frame, one captured program per key.
    ``kernels`` are K1-K3's and D1's wrappers by name.  Returns (their
    launches over the flagship frames, D1's records by input)."""
    import numpy as np
    import torch

    from ugrt_torch.api.renderer import Renderer, render_frame_reflective
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.micro import dda_edge
    from ugrt_torch.scene import model, procedural
    from ugrt_torch.trace import reflect as treflect

    small = dataclasses.replace(flagship, screen_width=128,
                                screen_height=128, grid_x=16, grid_y=16)
    box = procedural.cornell_box(subdiv=2)
    g_cam, g_light = CameraSpec(**GENERIC_CAMERA), CameraSpec(**GENERIC_LIGHT)
    got, want = (render_frame_reflective(
        *frame_inputs(box, small, g_cam, g_light, d), cfg=small,
        capacity=small.pair_capacity(box.num_faces), num_lights=1,
        use_spot=True, uniform_dims=(8, 8, 8)) for d in ("cuda", "cpu"))
    n_px = 128 * 128
    diff = {k: int((got["reflection"][k].cpu() != want["reflection"][k])
                   .sum()) for k in ("face_id", "t")}
    diff["image"] = int((got["image"].cpu() != want["image"]).any(-1).sum())
    hits = int((want["reflection"]["face_id"] >= 0).sum())
    say(f"phase 8: cornell 128^2 reflective, card vs the port on the CPU: "
        f"px differ {diff} of {n_px} (bound {int(CPU_PIXEL_BOUND * n_px)});"
        f" reflection hits {hits}; overflow {bool(got['overflow'])}")
    if (max(diff.values()) > CPU_PIXEL_BOUND * n_px or hits < n_px // 4
            or bool(got["overflow"])):
        fail("phase 8: the card's reflective frame disagrees with the CPU's")

    modes = ("reference", "windowed")
    cfgs = {m: dataclasses.replace(flagship, light_grid_mode=m)
            for m in modes}
    cams = (camera, CameraSpec(**CAMERA_2))
    frames = [frame_inputs(scene, flagship, c, light, "cuda") for c in cams]
    args = frames[0]

    def frame_kw(mode, use_spot):
        return dict(cfg=cfgs[mode], capacity=flagship.pair_capacity(
            scene.num_faces), num_lights=1, use_spot=use_spot)

    # (b) The eager body, with any host sync an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in modes:
            for use_spot in (False, True):
                render_frame_reflective.fn(*args, **frame_kw(mode, use_spot))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say("phase 8b: eager reflective frames (reference, windowed x Lambert, "
        "spot) ran under torch.cuda.set_sync_debug_mode('error'): no host "
        "sync")

    # (a) D1 against its plain version: the flagship reference frame's
    # reflection rays (recorded from the eager body), and the edge case.
    seen = []

    def record(*a, **k):
        seen.append((a, dict(k)))
        return kernels["uniform_dda"](*a, **k)

    treflect.uniform_dda = record
    try:
        render_frame_reflective.fn(*args, **frame_kw("reference", True))
    finally:
        treflect.uniform_dda = kernels["uniform_dda"]
    dda = {"flagship reference": dda_check("flagship reference", *seen[0],
                                           expect_overflow=False)}
    # The same rays in a seeded random order: a warp's lanes stand in
    # distinct cells, and its loop over cells runs at its worst.
    a, k = seen[0]
    pick = torch.from_numpy(np.random.default_rng(0).permutation(
        a[2].shape[0])).cuda()
    dda["flagship shuffled"] = dda_check(
        "flagship shuffled", (*a[:2], *(x[pick].contiguous() for x in a[2:6]),
                              *a[6:]), k, expect_overflow=False)
    dda["edge case"] = dda_check(
        "edge case", dda_edge.dda_edge_inputs("cuda"),
        dict(cfg=flagship, max_batches=dda_edge.MAX_BATCHES, eps=1e-4,
             batch=dda_edge.BATCH, skip_k=6), expect_overflow=True)
    # Batches of 48 (staged as 32 + 16) over cells of up to 73 faces.
    dda["edge case, batch 48"] = dda_check(
        "edge case, batch 48", dda_edge.dda_edge_inputs("cuda",
                                                       dims=(2, 2, 2)),
        dict(cfg=flagship, max_batches=2, eps=1e-4, batch=48, skip_k=6),
        expect_overflow=False)
    del seen, a, k, pick

    # The main path: 4 flagship frames, reference mode, through the
    # program (frames 1 and 2 record the Lambert and spot keys).
    render_frame_reflective.clear()
    for k in kernels.values():
        k.launches = 0
    times = []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        out = render_frame_reflective(*args, **frame_kw("reference", i >= 1))
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - h0) * 1e3
        ev = start.elapsed_time(end)
        times.append(ev)
        refl, ug = out["reflection"], out["uniform_grid"]
        prim_hit = out["primary"]["face_id"] >= 0
        share = float((refl["face_id"][prim_hit] >= 0).float().mean())
        overflow = bool(out["overflow"])
        say(f"phase 8: reflective frame {i + 1} "
            f"({'spot' if i else 'lambert'}"
            f"{', capture' if i < 2 else ', replay'}): "
            f"{ev:.3f} ms (CUDA events), {wall:.3f} ms host; overflow "
            f"{overflow}; primary hits {int(prim_hit.sum())}, of them "
            f"{share:.4f} reflect onto a face; uniform grid "
            f"{int(ug.total_pairs)} pairs, largest cell "
            f"{int(ug.cell_count.max())} faces, "
            f"{int((ug.cell_count > 0).sum())} cells non-empty; DDA steps "
            f"{int(refl['steps'])}")
        if overflow:
            fail("phase 8: the flagship reflective frame overflowed")
        if (tuple(out["image"].shape)
                != (flagship.screen_height, flagship.screen_width, 3)
                or not torch.isfinite(out["color"]).all() or share < 0.1):
            fail("phase 8: malformed reflective frame")
    launches = {name: k.launches for name, k in kernels.items()}
    say(f"phase 8: launches {launches}; steady "
        f"{sum(times[2:]) / len(times[2:]):.3f} ms per reflective frame "
        f"(frames 3-4, replays)")
    if min(launches.values()) <= 0:
        fail("phase 8: a kernel of the reflective frame was never launched")
    # (c) Warm-up + capture seconds of the keys recorded so far.
    say(f"phase 8c: reference lambert, spot: warm-up + capture "
        f"{render_frame_reflective.capture_seconds()} s")

    # (d) Replays against the eager body: both modes, Lambert and spot,
    # two cameras in turn; then new vertices.
    for mode in modes:
        for use_spot in (False, True):
            kw = frame_kw(mode, use_spot)
            new = render_frame_reflective.cache_size()
            images = []
            for ci, fargs in enumerate(frames):
                got = render_frame_reflective(*fargs, **kw)
                want = render_frame_reflective.fn(*fargs, **kw)
                diff = bitwise_diffs(reflective_leaves(got),
                                     reflective_leaves(want))
                say(f"phase 8d: {mode} {'spot' if use_spot else 'lambert'} "
                    f"camera {ci + 1}: replay vs eager, elements differing "
                    f"{diff}; reflection hits "
                    f"{int((want['reflection']['face_id'] >= 0).sum())}")
                if any(diff.values()) or bool(want["overflow"]):
                    fail(f"phase 8d: {mode}: the replayed reflective frame "
                         "differs from eager, or it overflowed")
                images.append(want["image"])
            if torch.equal(images[0], images[1]):
                fail("phase 8d: the two cameras gave the same image")
            if render_frame_reflective.cache_size() > new:
                say(f"phase 8c: {mode} {'spot' if use_spot else 'lambert'}: "
                    f"warm-up + capture "
                    f"{render_frame_reflective.capture_seconds()[-1]:.3f} s")
    r = Renderer(scene, cfgs["reference"], device="cuda")
    kw = frame_kw("reference", True)
    before = render_frame_reflective(r.vertices, *args[1:], **kw)["image"]
    verts = np.asarray(scene.vertices, np.float32)
    n = verts.shape[0] // 8           # the last eighth: in view
    r.update_vertices(model.rotate_subrange(verts, verts[-n:],
                                            verts.shape[0] - n, 0.5))
    got = render_frame_reflective(r.vertices, *args[1:], **kw)
    want = render_frame_reflective.fn(r.vertices, *args[1:], **kw)
    diff = bitwise_diffs(reflective_leaves(got), reflective_leaves(want))
    changed = int((got["image"] != before).any(-1).sum())
    say(f"phase 8d: update_vertices (rotate_subrange of {n} vertices): "
        f"replay vs eager on the new vertices, elements differing {diff}; "
        f"{changed} px changed from the frame before")
    if any(diff.values()) or not changed:
        fail("phase 8d: the replay after update_vertices is not the eager "
             "reflective frame of the new vertices")
    del r, before, got, want

    # (e) Frames 2-4, eager against graphed in turns.
    kw = frame_kw("reference", True)
    ev, host, credited = in_turns(
        lambda: render_frame_reflective.fn(*args, **kw),
        lambda: render_frame_reflective(*args, **kw), kernels)
    say(f"phase 8e: reference spot frames 2-4: ms (CUDA events / host) "
        f"eager {ev['eager']} / {host['eager']}; graphed {ev['graphed']} / "
        f"{host['graphed']}; means eager {float(np.mean(ev['eager']))}, "
        f"graphed {float(np.mean(ev['graphed']))}; launches credited to the "
        f"graphed runs {credited}")

    # (f) One profiled replay.
    names = profile_once("phase 8f: replayed reflective frame",
                         lambda: render_frame_reflective(*args, **kw),
                         top_n=10)
    missing = [k for k, pat in {**SWEEP_KERNELS, **DDA_KERNEL}.items()
               if not any(re.search(pat, nm) for nm in names)]
    say(f"phase 8f: {len(names)} distinct kernels; K1-K3 and D1 by name: "
        f"{'all present' if not missing else f'missing {missing}'}")
    if missing:
        fail(f"phase 8f: {missing} not among the replay's kernels")

    # (g) Memory of the eager body and of each key from nothing recorded.
    render_frame_reflective.clear()
    mem = {}
    _, _, mem["eager frame"], _ = memory_of(
        lambda: render_frame_reflective.fn(*args, **kw))
    for label, use_spot in (("lambert", False), ("spot", True)):
        call_kw = frame_kw("reference", use_spot)
        _, first_s, mem[f"{label} capture"], mem[f"{label} held"] = \
            memory_of(lambda: render_frame_reflective(*args, **call_kw))
        _, _, mem[f"{label} replay"], _ = memory_of(
            lambda: render_frame_reflective(*args, **call_kw))
        say(f"phase 8c: reference {label} from nothing recorded: warm-up + "
            f"capture {render_frame_reflective.capture_seconds()[-1]:.3f} s,"
            f" first call {first_s:.3f} s in all")
    say("phase 8g: reflective frame device memory MB (peak "
        "max_memory_allocated above the start of the call; 'held' = "
        "memory_reserved kept after the capture): "
        + ", ".join(f"{k} {v:.1f}" for k, v in mem.items()))
    render_frame_reflective.clear()
    return launches, dda


def reflective_leaves(out):
    """The reflective frame's results that phase 8 holds bitwise."""
    refl = out["reflection"]
    return dict(image=out["image"], color=out["color"],
                shadowed=out["shadowed"], t=refl["t"],
                face_id=refl["face_id"], overflow=out["overflow"])


def timed_train(step_fn, *args, **kwargs):
    """train(*args, **kwargs) on the card with ``step_fn`` as its step
    (in place of render_and_grad): (losses, CUDA-event ms per step, host
    ms per step), each step timed from its start to the next one's."""
    import torch

    from ugrt_torch.api import train as tmod

    marks = []                     # (CUDA event, host s) at each step start

    def timed(*a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))
        return step_fn(*a, **k)

    saved = tmod.render_and_grad
    tmod.render_and_grad = timed
    try:
        _, _, log = tmod.train(*args, verbose=False, device="cuda", **kwargs)
    finally:
        tmod.render_and_grad = saved
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    stops = marks[1:] + [(end, time.perf_counter())]
    ev = [a.elapsed_time(b) for (a, _), (b, _) in zip(marks, stops)]
    host = [(hb - ha) * 1e3 for (_, ha), (_, hb) in zip(marks, stops)]
    return log, ev, host


def train_phase(scene, flagship, camera, light, kernels):
    """Phase 9: the training loop.  Returns K1-K3's launches over the
    flagship run and its resume."""
    import tempfile

    import numpy as np
    import torch

    from ugrt_torch.api import checkpoint
    from ugrt_torch.api import train as tmod
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.diff.render_grad import render_color
    from ugrt_torch.scene import procedural

    cfg = dataclasses.replace(flagship, light_grid_mode="windowed")
    target = np.zeros((cfg.screen_height, cfg.screen_width, 3), np.float32)

    def run(tcfg):
        return timed_train(tmod.render_and_grad, scene, [camera], light,
                           light.eye, [target], cfg, tcfg)

    for k in kernels.values():
        k.launches = 0
    with tempfile.TemporaryDirectory() as d:
        first = run(tmod.TrainConfig(steps=6, checkpoint_dir=d,
                                     checkpoint_every=3))
        # The resume checkpoints every 2 steps, so its last step (7)
        # leaves one: latest_step then shows where it ended.
        second = run(tmod.TrainConfig(steps=8, checkpoint_dir=d,
                                      checkpoint_every=2))
        latest = checkpoint.latest_step(d)
    launches = {name: k.launches for name, k in kernels.items()}
    for name, (log, ev, host) in (("steps 0-5", first),
                                  ("resumed", second)):
        say(f"phase 9: train {name}: losses {log}; ms per step (CUDA "
            f"events) {[round(x, 3) for x in ev]}, host "
            f"{[round(x, 3) for x in host]}")
    steady = first[1][1:] + second[1]
    say(f"phase 9: launches {launches}; steady {np.mean(steady):.3f} ms per "
        f"training step (CUDA events; steps 1-7), host "
        f"{np.mean(first[2][1:] + second[2]):.3f} ms; resumed run took "
        f"{len(second[0])} steps; latest checkpoint step {latest}")
    if not all(np.isfinite(first[0] + second[0])):
        fail("phase 9: a non-finite loss")
    if len(first[0]) != 6 or len(second[0]) != 2 or latest != 7:
        fail("phase 9: the resumed run did not start at step 6 or its "
             "checkpoints are not where expected")
    if min(launches.values()) <= 0:
        fail("phase 9: a kernel of the training loop was never launched")

    # tests/test_api.py:87-130 on the card.
    small = dataclasses.replace(flagship, screen_width=64, screen_height=64,
                                grid_x=8, grid_y=8)
    tri = dataclasses.replace(procedural.single_triangle(), vertices=np.asarray(
        [[-1.0, -1.1, -3.1], [1.1, -0.9, -2.7], [0.05, 1.2, -3.4]],
        dtype=np.float32))
    spec = CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0, 0, -1),
                      up=(0, 1, 0), near=0.1, far=100.0)
    t_light = CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0, 0, -3),
                         up=(0, 1, 0), near=0.1, far=100.0)
    v, f, mi, m, cc, lcc, lp = frame_inputs(tri, small, spec, t_light, "cuda")
    half = m * torch.tensor(0.5, device="cuda")
    goal, _ = render_color(v, half, f, mi, cc, lcc, lp, cfg=small,
                           capacity=small.pair_capacity(tri.num_faces),
                           num_lights=1, use_spot=True)
    _, mats, log = tmod.train(
        tri, [spec], t_light, t_light.eye, [goal], small,
        tmod.TrainConfig(learning_rate=5e-2, steps=30,
                         optimize_vertices=False), verbose=False,
        device="cuda")
    say(f"phase 9: recovery (single triangle 64^2, materials halved, 30 "
        f"steps): loss {log[0]!r} -> {log[-1]!r} "
        f"({log[-1] / log[0]:.4f}x); materials {mats.cpu().tolist()} "
        f"(goal {half.cpu().tolist()})")
    if not log[-1] < 0.2 * log[0]:
        fail("phase 9: the recovery check's loss did not fall below 0.2x")
    return launches


def mesh_phase(scene, flagship, camera, light, kernels):
    """Phase 10a: the sharded path on an NCCL group of one rank, its
    frame and step captured programs (dist.mesh).  Returns K1-K3's
    launches on that path."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from ugrt_torch.api.renderer import render_frame_device
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.diff.render_grad import render_and_grad, render_color
    from ugrt_torch.dist import mesh as dmesh

    cap = flagship.pair_capacity(scene.num_faces)
    modes = ("windowed", "reference")
    kws = {m: dict(cfg=dataclasses.replace(flagship, light_grid_mode=m),
                   capacity=cap, num_lights=1, use_spot=True) for m in modes}
    cams = (camera, CameraSpec(**CAMERA_2))
    frames = {m: [[step_inputs(scene, kws[m]["cfg"], c, light, "cuda")[k]
                   for k in FRAME_KEYS] for c in cams] for m in modes}
    rng = np.random.default_rng(0)
    zero = torch.zeros((flagship.screen_height, flagship.screen_width, 3),
                       dtype=torch.float32, device="cuda")
    targets = (zero, torch.from_numpy(rng.uniform(0.0, 0.3, tuple(
        zero.shape)).astype(np.float32)).cuda())
    sf, skw = frames["windowed"][0], kws["windowed"]
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = dmesh.make_mesh()
            say(f"phase 10a: NCCL group: rank {mesh.rank} of "
                f"{mesh.world_size} on {mesh.device}, backend "
                f"{dist.get_backend(mesh.group)}")
            renders = {m: dmesh.sharded_render(mesh, **kws[m])
                       for m in modes}
            step = dmesh.sharded_train_step(mesh, **skw)

            # The main path: each program's key recorded on the first
            # input, then replayed on the second.
            for k in kernels.values():
                k.launches = 0
            images = {m: [renders[m](*f) for f in frames[m]] for m in modes}
            steps = [step(*sf, t) for t in targets]
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
            say(f"phase 10a: K1-K3 launches on the sharded path (2 modes x 2 "
                f"cameras of frames, 2 targets of steps; each key's warm-up "
                f"and capture, then replays) {launches}; capture s "
                + ", ".join(f"{m} frame {renders[m].capture_seconds()}"
                            for m in modes)
                + f", step {step.capture_seconds()}")
            if min(launches.values()) <= 0:
                fail("phase 10a: a kernel of the sharded path was never "
                     "launched")

            for m in modes:
                for ci, (f, got) in enumerate(zip(frames[m], images[m])):
                    eager = renders[m].fn(*f)
                    single = render_color(*f, **kws[m])
                    names = ("image", "overflow")
                    diff = bitwise_diffs(dict(zip(names, got)),
                                         dict(zip(names, eager)))
                    d_single = bitwise_diffs(dict(zip(names, got)),
                                             dict(zip(names, single)))
                    say(f"phase 10a: {m} camera {ci + 1}: replayed sharded "
                        f"image {tuple(got[0].shape)} vs its eager body, "
                        f"elements differing {diff}; vs render_color "
                        f"{d_single}; overflow {bool(got[1])}")
                    if (any(diff.values()) or any(d_single.values())
                            or bool(got[1])):
                        fail(f"phase 10a: {m}: the replayed sharded image "
                             "differs from eager or render_color, or "
                             "overflowed")
                if torch.equal(images[m][0][0], images[m][1][0]):
                    fail("phase 10a: the two cameras gave the same image")

            names = ("loss", "grad_vertices", "grad_materials", "overflow")
            for ti, (t, got) in enumerate(zip(targets, steps)):
                got = dict(zip(names, got))
                diff = bitwise_diffs(got, dict(zip(names, step.fn(*sf, t))))
                ref = render_and_grad(*sf, t, **skw)
                loss_s, loss_b = float(got["loss"]), float(ref["loss"])
                errs, same = {}, True
                for name in ("grad_vertices", "grad_materials"):
                    g, w = got[name], ref[name]
                    errs[name] = float((g.double() - w.double()).abs().max()
                                       / w.abs().max())
                    same = same and torch.equal(g, w)
                say(f"phase 10a: target {ti + 1}: replayed sharded step vs "
                    f"its eager body, elements differing {diff}; loss "
                    f"{loss_s!r} vs render_and_grad {loss_b!r}; max |diff| "
                    f"/ max|g| {errs}; gradients "
                    f"{'bitwise equal' if same else 'not bitwise'}; overflow "
                    f"{bool(got['overflow'])}")
                if (any(diff.values())
                        or abs(loss_s - loss_b) > 1e-5 * abs(loss_b)
                        or max(errs.values()) > 1e-6
                        or bool(got["overflow"])):
                    fail("phase 10a: the replayed sharded step differs from "
                         "its eager body or from the bare step")
            if torch.equal(steps[0][0], steps[1][0]):
                fail("phase 10a: the two targets gave the same loss")

            # Eager body, replay, the bare replay, in turns.
            cred_all = dict.fromkeys(kernels, 0)
            fi = frame_inputs(scene, skw["cfg"], camera, light, "cuda")
            for label, eager, graphed, bare, timed in (
                    ("sharded step (bare: render_and_grad)",
                     lambda: step.fn(*sf, targets[0]),
                     lambda: step(*sf, targets[0]),
                     lambda: render_and_grad(*sf, targets[0], **skw), 4),
                    ("sharded windowed frame (bare: render_frame_device)",
                     lambda: renders["windowed"].fn(*sf),
                     lambda: renders["windowed"](*sf),
                     lambda: render_frame_device(*fi, **skw), 3)):
                ev, host, cred = in_turns(eager, graphed, kernels, warm=1,
                                          timed=timed, bare=bare)
                for name, n in cred.items():
                    cred_all[name] += n
                say(f"phase 10a: {label}: ms (CUDA events / host) eager "
                    f"{ev['eager']} / {host['eager']}; graphed "
                    f"{ev['graphed']} / {host['graphed']}; bare "
                    f"{ev['bare']} / {host['bare']}; means eager "
                    f"{np.mean(ev['eager']):.3f}, graphed "
                    f"{np.mean(ev['graphed']):.3f}, bare "
                    f"{np.mean(ev['bare']):.3f}")
            say(f"phase 10a: K1-K3 launches credited to the sharded replays "
                f"timed {cred_all}")
            if min(cred_all.values()) <= 0:
                fail("phase 10a: a sharded replay credited no launch")
            nccl_profile(lambda: step(*sf, targets[0]),
                         label="phase 10a (replay)")
        finally:
            dmesh.clear()
            dist.destroy_process_group()
    return launches


def nccl_profile(fn, label="phase 10a", show=True):
    """One call of fn() under torch.profiler, after one unrecorded call
    (the profiler starts at another moment on each rank, and a
    collective of the first call would wait for the last rank): the NCCL
    collectives (host ops and the device time under them) and the NCCL
    kernels, with their launches, and the device-busy share (device time
    over the device span and over the host ms, micro.parse_trace;
    printed where ``show``; every rank of a group profiles).  A replay
    runs no host op: its collectives show as kernels only."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from ugrt_torch.micro import parse_trace

    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: recorded.append(
                     (p.key_averages(), trace_events(p)))) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    averages, events = recorded[0]
    ops = [e for e in averages if e.device_type.name != "CUDA"
           and "nccl" in e.key.lower()]
    s = parse_trace.aggregate(events)
    kernels = [r for r in s.rows if "nccl" in r[0].lower()]
    if not show:
        return
    say(f"{label}: one profiled sharded step: {wall_ms:.3f} ms host "
        f"(profiled), device busy {s.total_ms:.3f} ms "
        f"({100 * s.busy:.1f}% of the device span {s.span_ms:.3f} ms; "
        f"{100 * s.total_ms / wall_ms:.1f}% of the host ms); NCCL ops "
        + ("; ".join(f"{e.key} x{e.count} host {e.cpu_time_total / 1e3:.3f}"
                     f" ms, device {e.device_time_total / 1e3:.4f} ms"
                     for e in ops) or "none")
        + "; NCCL kernels "
        + ("; ".join(f"{k[:60]} x{c} {v:.4f} ms" for k, v, c in kernels)
           or "none launched")
        + f" (of {s.total_ms:.3f} ms device time, {len(events)} launches)")


def strip_phase(scene, flagship, camera, light, kernels):
    """Phase 10b: the strips of worlds 2 and 4 on the one card."""
    import torch

    from ugrt_torch.diff.render_grad import render_color
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.trace import primary as tprimary

    cfg = dataclasses.replace(flagship, light_grid_mode="reference")
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    args = step_inputs(scene, cfg, camera, light, "cuda")
    frame = [args[k] for k in ("vertices", "materials", "faces",
                               "mat_index", "camcoords", "light_camcoords",
                               "light_position")]
    v, f, cc = args["vertices"], args["faces"], args["camcoords"]
    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg,
                                         capacity=kw["capacity"])
    full = tprimary.trace_primary(v, f, cc, grid, cfg)
    want, _ = render_color(*frame, **kw)
    for world in (2, 4):
        n_bx = cfg.grid_x // world
        colors, traces, per_strip = [], [], []
        for d in range(world):
            for k in kernels.values():
                k.launches = 0
            colors.append(render_color(*frame, **kw, bx0=d * n_bx,
                                       n_bx=n_bx)[0])
            per_strip.append({n: k.launches for n, k in kernels.items()})
            traces.append(tprimary.trace_primary(v, f, cc, grid, cfg,
                                                 bx0=d * n_bx, n_bx=n_bx))
        mism = {k: int((torch.cat([t[k] for t in traces], 1).view(
            torch.int32) != full[k].view(torch.int32)).sum())
            for k in ("face_id", "t")}
        mism["image"] = int((torch.cat(colors, 1).view(torch.int32)
                             != want.view(torch.int32)).sum())
        say(f"phase 10b: world {world} ({n_bx} tile columns per strip): "
            f"words differing from the single-device frame {mism}; K1-K3 "
            f"launches per strip {per_strip}")
        if max(mism.values()) or min(min(p.values()) for p in per_strip) <= 0:
            fail(f"phase 10b: world {world}: the strips differ from the "
                 "frame or a kernel was not launched")


def native_phase(scene, flagship, camera, light):
    """Phase 10c: the native host library against the Python paths."""
    import tempfile
    import unittest.mock as mock

    import numpy as np

    from ugrt_torch.api import io
    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.scene import model, native

    t0 = time.perf_counter()
    path, gxx_s = native.build()
    say(f"phase 10c: built {path.name} with g++ in {gxx_s:.2f} s")
    out = Renderer(scene, dataclasses.replace(
        flagship, light_grid_mode="windowed"), device="cuda").render(
        camera, [light], light.eye)
    img = out["image"].cpu().numpy()
    with tempfile.TemporaryDirectory() as d:
        obj, mat = os.path.join(d, "cathedral.obj"), os.path.join(d, "m.txt")
        t0 = time.perf_counter()
        model.write_obj(obj, scene)
        model.write_material_file(mat, scene.materials)
        write_s = time.perf_counter() - t0
        ms, loaded = {}, {}
        for name, prefer in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            loaded[name] = model.load_scene(obj, mat, prefer_native=prefer)
            ms[f"load {name}"] = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(getattr(loaded["native"], k),
                                  getattr(loaded["python"], k))
                   and np.array_equal(getattr(loaded["native"], k),
                                      getattr(scene, k))
                   for k in ("vertices", "faces", "mat_index", "materials"))
        files = {}
        for name in ("native", "python"):
            files[name] = os.path.join(d, f"{name}.ppm")
            with mock.patch.object(native, "available",
                                   return_value=name == "native"):
                t0 = time.perf_counter()
                io.write_ppm(files[name], img, flip=True)
                ms[f"ppm {name}"] = (time.perf_counter() - t0) * 1e3
        with open(files["native"], "rb") as a, open(files["python"],
                                                    "rb") as b:
            same_ppm = a.read() == b.read()
        size = os.path.getsize(files["native"])
    say(f"phase 10c: cathedral {scene.num_faces} faces written in "
        f"{write_s:.2f} s; load ms native {ms['load native']:.1f}, python "
        f"{ms['load python']:.1f} ({ms['load python'] / ms['load native']:.1f}"
        f"x); arrays equal (and equal to the scene) {same}; PPM of the "
        f"{img.shape[1]}x{img.shape[0]} frame ({size} bytes) ms native {ms['ppm native']:.1f}, python "
        f"{ms['ppm python']:.1f} ({ms['ppm python'] / ms['ppm native']:.1f}x)"
        f"; bytes equal {same_ppm}")
    if not (same and same_ppm):
        fail("phase 10c: the native and Python paths disagree")


def packet_phase(scene, flagship, camera, light):
    """Phase 10d: build_packets on the flagship windowed frame's light
    cells, on the card against the CPU, and the packet invariants."""
    import torch

    from ugrt_torch import bridge
    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.grid import binning
    from ugrt_torch.trace import shadow as tshadow

    cfg = dataclasses.replace(flagship, light_grid_mode="windowed")
    primary = Renderer(scene, cfg, device="cuda").render(
        camera, [light], light.eye)["primary"]
    eye = bridge.camcoords_to_torch(camera, cfg.fovy_deg, 1.0, "cuda")[0:3]
    lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, 1.0, "cuda")
    window = tshadow.light_window(primary, eye, lcc, cfg)
    # Each pixel's hit point, as trace_shadow bins it.
    pts = eye + primary["t"].reshape(-1, 1) * primary["ray_dir"].reshape(
        -1, 3)
    cells = binning.ray_light_cells_windowed(
        pts, lcc, cfg.grid_x, cfg.grid_y, window).reshape(-1).to(torch.int32)
    ms = {}
    outs = {}
    for dev in ("cuda", "cpu"):
        c = cells.to(dev)
        outs[dev] = tshadow.build_packets(c, cfg)
        t0 = time.perf_counter()
        tshadow.build_packets(c, cfg)
        torch.cuda.synchronize()
        ms[dev] = (time.perf_counter() - t0) * 1e3
    (ray, work), (ray_c, work_c) = outs["cuda"], outs["cpu"]
    equal = torch.equal(ray.cpu(), ray_c) and all(
        torch.equal(a.cpu(), b) for a, b in zip(work, work_c))
    sent, mrp = cfg.cell_sentinel, cfg.max_rays_per_packet
    live = work.packet_cell < sent
    pos, cnt, cell = (x[live].long() for x in (
        work.packet_pos, work.packet_count, work.packet_cell))
    ingrid = cells < sent
    n_in = int(ingrid.sum())
    counts = torch.bincount(cells[ingrid].long(), minlength=sent)
    sorted_cells = cells[ray.long()]
    ok = {
        "count": int(live.sum()) == int((-(-counts // mrp)).sum()),
        "sizes": bool(((cnt >= 1) & (cnt <= mrp)).all()),
        "tile the in-grid prefix": bool(
            (pos == torch.cumsum(cnt, 0) - cnt).all()) and int(cnt.sum())
        == n_in,
        "cell-pure": bool((torch.repeat_interleave(cell, cnt)
                           == sorted_cells[:n_in]).all()),
        "no overflow": not bool(work.overflow),
    }
    say(f"phase 10d: build_packets on {cells.numel()} rays ({n_in} in the "
        f"grid, {int((counts > 0).sum())} cells): {int(live.sum())} packets "
        f"of {work.packet_pos.numel()} slots; card equals CPU {equal}; "
        f"invariants {ok}; ms card {ms['cuda']:.3f}, CPU {ms['cpu']:.3f}")
    if not (equal and all(ok.values())):
        fail("phase 10d: build_packets disagrees or breaks an invariant")


def run_module(*argv, phase="phase 12", timeout=600):
    """``python -m <argv>`` from the checkout's root, as a user runs it:
    (its stdout, seconds).  Fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        say(proc.stdout[-4000:])
        say(proc.stderr[-4000:])
        fail(f"{phase}: python -m {' '.join(argv)} exited "
             f"{proc.returncode}")
    return proc.stdout, time.perf_counter() - t0


def run_entry(*argv, phase="phase 12", timeout=600):
    """``run_module``, then its last stdout line as JSON: (that object,
    seconds).  Fails on a last line that is not a JSON object."""
    stdout, secs = run_module(*argv, phase=phase, timeout=timeout)
    lines = stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    if not isinstance(line, dict):
        say(stdout[-4000:])
        fail(f"{phase}: python -m {' '.join(argv)}: last line "
             f"{lines[-1:] or None} is not a JSON object")
    return line, secs


def bench_phase(kernels, step_ms):
    """Phase 12: the bench entries (ugrt_torch.bench and
    micro.bench_reflective) in subprocesses, then in this process with
    their kernels' launches counted.  Returns those launches."""
    import tempfile

    import torch

    from ugrt_torch import bench
    from ugrt_torch.micro import bench_reflective

    torch.cuda.empty_cache()
    for argv in (("--breakdown",), ("--pi-extent", "--skip-parity")):
        line, secs = run_entry("ugrt_torch.bench", *argv)
        d = line["detail"]
        stages = {k: d[k] for k in ("grid_ms", "light_grid_ms", "primary_ms",
                                    "shadow_ms", "forward_ms") if k in d}
        say(f"phase 12: bench {' '.join(argv)} ({secs:.1f} s): "
            f"{line['metric']} {line['value']!r} {line['unit']}; chained "
            f"{d['step_ms_chained']!r} ms (CUDA events "
            f"{d['step_ms_chained_events']!r}), fenced "
            f"{d['step_ms_fenced']!r} ({d['step_ms_fenced_events']!r}); "
            f"phase 6's steady step {step_ms:.3f} ms (CUDA events); "
            f"compile_s {d['compile_s']!r}; {d['light_grid_mode']}; parity "
            f"shadow px {d.get('parity_shadow_px')}; stages {stages}")
        if (line["metric"] != "primary_rays_per_s_fwd_bwd"
                or not line["value"] > 0
                or d.get("parity_shadow_px", 0) > bench.PARITY_SHADOW_PX
                or (argv[0] == "--breakdown" and (
                    "parity_shadow_px" not in d or len(stages) != 5))):
            fail(f"phase 12: bench {' '.join(argv)}: bad result line")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "reflective_1024.png")
        line, secs = run_entry("ugrt_torch.micro.bench_reflective", "--out",
                               png)
        say(f"phase 12: bench_reflective ({secs:.1f} s): base frame "
            f"{line['base_ms']!r} ms (CUDA events {line['base_ms_events']!r}"
            f"), reflective {line['reflective_ms']!r} "
            f"({line['reflective_ms_events']!r}), bounce "
            f"{line['bounce_ms']!r}; overflow {line['overflow']}; "
            f"reflection hit fraction {line['reflection_hit_fraction']!r}; "
            f"PNG {os.path.getsize(png) if os.path.exists(png) else None} "
            f"bytes")
        if line["overflow"] or not os.path.exists(png):
            fail("phase 12: bench_reflective overflowed or wrote no PNG")

        # The same paths in this process, launches counted.
        for k in kernels.values():
            k.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main(["--iters", "5", "--skip-parity", "--breakdown"])
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        with contextlib.redirect_stdout(io.StringIO()):
            w = bench.workload("cuda")        # windowed, as the script
            refl = bench_reflective.run(w.cfg, w.scene, torch.device("cuda"),
                                        out_path=png, iters=3)
    launches = {name: k.launches for name, k in kernels.items()}
    say(f"phase 12: in this process: bench {line['value']!r} rays/s "
        f"(chained {line['detail']['step_ms_chained']!r} ms), "
        f"bench_reflective {refl['reflective_ms']!r} ms, overflow "
        f"{refl['overflow']}; launches {launches}")
    if min(launches.values()) <= 0 or refl["overflow"]:
        fail("phase 12: a kernel of the bench paths was never launched")
    return launches


# parse_trace's printout (micro.parse_trace.print_summary).
TABLE_ROW = re.compile(r"^\s*([0-9.]+) ms  x(\d+)\s* (.*)$")
TABLE_TOTAL = re.compile(r"^total device op time: ([0-9.]+) ms")
TABLE_BUSY = re.compile(r"^device span: ([0-9.]+) ms; busy ([0-9.]+)%")


def parse_table(text):
    """(total ms, [(ms, count, group)], span ms, busy %) of parse_trace's
    printout."""
    total = span = busy = None
    rows = []
    for line in text.splitlines():
        if m := TABLE_TOTAL.match(line):
            total = float(m.group(1))
        elif m := TABLE_BUSY.match(line):
            span, busy = float(m.group(1)), float(m.group(2))
        elif m := TABLE_ROW.match(line):
            rows.append((float(m.group(1)), int(m.group(2)), m.group(3)))
    return total, rows, span, busy


def profiling_phase():
    """Phase 13: the profiling modules of ugrt_torch.micro, each in a
    subprocess from the checkout's root with its output in a temporary
    directory, as a user runs them.  Returns K1-K3's kernel events in
    capture_trace's traces {kernel: [windowed, pi extent]}."""
    import tempfile

    import torch

    from ugrt_torch.micro import profile_chain, render_samples

    torch.cuda.empty_cache()
    line, secs = run_entry("ugrt_torch.micro.profile_chain",
                           phase="phase 13")
    rows, stats = line["rows"], line["stats"]
    say(f"phase 13: profile_chain ({secs:.1f} s; host ms, CUDA-event ms): "
        + "; ".join(f"{n.strip()} {h:.4f} ({e:.4f})" for n, h, e in rows))
    say(f"phase 13: profile_chain statistics {stats}")
    names = [r[0] for r in rows]
    if (names != list(profile_chain.LINE_ITEMS)
            or not all(h > 0 and e is not None and e > 0
                       for _, h, e in rows)
            or sorted(stats) != sorted(profile_chain.STATS)
            or any(v is None for v in stats.values())):
        fail("phase 13: profile_chain missed a line item or a statistic, "
             "or an item's ms is not positive")

    pats = dict(SWEEP_KERNELS, **G1_KERNELS)
    launches = {k: [] for k in pats}
    with tempfile.TemporaryDirectory() as tmp:
        for argv in ((), ("--pi-extent",)):
            d = os.path.join(tmp, "pi_extent" if argv else "windowed")
            out, secs = run_module("ugrt_torch.micro.capture_trace", "--out",
                                   d, *argv, phase="phase 13")
            losses = [ln for ln in out.splitlines() if "loss" in ln]
            text, _ = run_module("ugrt_torch.micro.parse_trace", d, "100000",
                                 phase="phase 13")
            total, table, span, busy = parse_table(text)
            say(f"phase 13: capture_trace {' '.join(argv) or '(windowed)'} "
                f"({secs:.1f} s): {'; '.join(losses)}; parse_trace: total "
                f"device op time {total} ms over a span of {span} ms (busy "
                f"{busy}%), {len(table)} groups; top 25 (ms, launches, "
                f"group):")
            for ms, n, group in table[:25]:
                say(f"  {ms:9.2f} ms x{n:<5d} {group}")
            found = {k: sum(n for _, n, g in table if re.search(pat, g))
                     for k, pat in pats.items()}
            say(f"phase 13: K1-K3's and G1's kernel events in the trace "
                f"{found}")
            for k, n in found.items():
                launches[k].append(n)
            if not (total and total > 0) or min(found.values()) <= 0:
                fail(f"phase 13: capture_trace {' '.join(argv)}: no device "
                     "time, or K1, K2, K3 or G1 missing from parse_trace's "
                     "table")

        # No profile of the step in this process (the profiler crash,
        # PERF.md §7): capture_trace's subprocess above profiles it.
        out, secs = run_module("ugrt_torch.micro.render_samples", "--out",
                               tmp, phase="phase 13")
        shapes = {}
        for name in ("cathedral.png", "cornell_reflective.png"):
            path = os.path.join(tmp, name)
            shapes[name] = (render_samples.read_png(path).shape
                            if os.path.exists(path) else None)
        say(f"phase 13: render_samples ({secs:.1f} s): "
            + "; ".join(ln for ln in out.splitlines()
                        if ln.startswith(("cathedral", "cornell")))
            + f"; decoded {shapes}")
        if shapes != {"cathedral.png": (1024, 1024, 3),
                      "cornell_reflective.png": (512, 512, 3)}:
            fail("phase 13: render_samples' PNGs do not decode at their "
                 "sizes")
    return launches


def bitwise_diffs(got, want):
    """{key: elements whose bits differ} of two dicts of tensors."""
    import torch

    out = {}
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            out[key] = -1
            continue
        if w.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        out[key] = int((g != w).sum())
    return out


def frame_leaves(out):
    """The frame's results that phase 11 holds bitwise."""
    return dict(image=out["image"], color=out["color"],
                shadowed=out["shadowed"], t=out["primary"]["t"],
                face_id=out["primary"]["face_id"], overflow=out["overflow"])


def in_turns(fn_eager, fn_graphed, counted, warm=1, timed=3, bare=None):
    """Eager, graphed, graphed, eager (with ``bare``, a yardstick:
    eager, graphed, bare, bare, graphed, eager): per block ``warm``
    untimed calls, then ``timed`` calls, each timed alone (CUDA events
    and host clock, synchronised).  Returns ({name: [CUDA-event ms]},
    {name: [host ms]}, K1-K3's launches over the graphed blocks, each
    block's read from counts set to 0 just before it)."""
    import torch

    order = [("eager", fn_eager), ("graphed", fn_graphed)]
    if bare is not None:
        order.append(("bare", bare))
    order += order[::-1]
    ev = {name: [] for name, _ in order}
    host = {name: [] for name, _ in order}
    credited = {name: 0 for name in counted}
    for name, fn in order:
        for k in counted.values():
            k.launches = 0
        for _ in range(warm):
            fn()
        for _ in range(timed):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - h0) * 1e3)
            ev[name].append(start.elapsed_time(end))
        if name == "graphed":
            for n, k in counted.items():
                credited[n] += k.launches
    return ev, host, credited


def memory_of(fn):
    """(result, seconds, peak MB, held MB) of one call of fn() on the
    card: the peak of max_memory_allocated above what was allocated
    before, and the growth of memory_reserved (what the caching
    allocator and a captured graph's pool keep afterwards)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, seconds, (torch.cuda.max_memory_allocated() - base) / 2**20,
            (torch.cuda.memory_reserved() - reserved) / 2**20)


# K1-K3's and D1's CUDA kernels by name, as torch.profiler lists them.
SWEEP_KERNELS = {"primary_sweep": r"(?<!heavy_)primary_sweep_kernel",
                 "heavy_primary_sweep": r"heavy_primary_sweep_kernel",
                 "shadow_sweep": r"shadow_sweep(_serial)?_kernel"}
DDA_KERNEL = {"uniform_dda": r"uniform_dda_kernel"}


def program_phase(scene, flagship, camera, light, kernels):
    """Phase 11: one dispatch per frame and per step (core.program).
    Returns K1-K3's launches credited to the graphed runs of (f)."""
    import numpy as np
    import torch

    from ugrt_torch.api.renderer import (Renderer, render_frame,
                                         render_frame_device)
    from ugrt_torch.api.train import TrainConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.core.program import Program
    from ugrt_torch.diff.render_grad import render_and_grad
    from ugrt_torch.scene import model

    modes = ("windowed", "reference", "extent")
    cfgs = {m: dataclasses.replace(flagship, light_grid_mode=m)
            for m in modes}
    cap = flagship.pair_capacity(scene.num_faces)

    def frame_kw(mode, use_spot):
        return dict(cfg=cfgs[mode], capacity=cap, num_lights=1,
                    use_spot=use_spot)

    cams = (camera, CameraSpec(**CAMERA_2))
    frames = [frame_inputs(scene, flagship, c, light, "cuda") for c in cams]
    step_kw = dict(frame_kw("windowed", True))
    step_args = step_inputs(scene, cfgs["windowed"], camera, light, "cuda")
    step_keys = ("loss", "color", "grad_vertices", "grad_materials",
                 "overflow")

    # (a) The bodies, eagerly, with any host sync an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in modes:
            for use_spot in (False, True):
                render_frame(*frames[0], **frame_kw(mode, use_spot))
        render_and_grad.fn(**step_args, **step_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say("phase 11a: eager frames (3 modes x Lambert, spot) and the eager "
        "step ran under torch.cuda.set_sync_debug_mode('error'): no host "
        "sync")

    # (b) Capture cost and (h) memory, from nothing recorded.
    render_frame_device.clear()
    render_and_grad.clear()
    mem = {}
    _, _, mem["eager frame"], _ = memory_of(
        lambda: render_frame(*frames[0], **frame_kw("windowed", True)))
    _, _, mem["eager step"], _ = memory_of(
        lambda: render_and_grad.fn(**step_args, **step_kw))
    for label, prog, call in (
            ("frame lambert", render_frame_device,
             lambda: render_frame_device(*frames[0],
                                         **frame_kw("windowed", False))),
            ("frame spot", render_frame_device,
             lambda: render_frame_device(*frames[0],
                                         **frame_kw("windowed", True))),
            ("step", render_and_grad,
             lambda: render_and_grad(**step_args, **step_kw))):
        _, first_s, peak, held = memory_of(call)
        mem[f"{label} capture"] = peak
        mem[f"{label} held"] = held
        _, _, mem[f"{label} replay"], _ = memory_of(call)
        say(f"phase 11b: {label} (windowed): warm-up + capture "
            f"{prog.capture_seconds()[-1]:.3f} s, first call "
            f"{first_s:.3f} s in all")
    say("phase 11h: device memory MB (peak max_memory_allocated above the "
        "start of the call; 'held' = memory_reserved kept after the "
        "capture): " + ", ".join(f"{k} {v:.1f}" for k, v in mem.items()))

    # (c) Replayed frames against eager, two cameras in turn per key.
    for mode in modes:
        for use_spot in (False, True):
            kw = frame_kw(mode, use_spot)
            new = render_frame_device.cache_size()
            images = []
            for ci, args in enumerate(frames):
                got = render_frame_device(*args, **kw)
                want = render_frame(*args, **kw)
                diff = bitwise_diffs(frame_leaves(got), frame_leaves(want))
                hit = float((want["primary"]["face_id"] >= 0).float().mean())
                say(f"phase 11c: {mode} {'spot' if use_spot else 'lambert'}"
                    f" camera {ci + 1}: replay vs eager, elements differing "
                    f"{diff}; hit fraction {hit:.4f}; shadowed px "
                    f"{int(want['shadowed'].sum())}")
                if any(diff.values()) or hit < 0.5 or bool(want["overflow"]):
                    fail(f"phase 11c: {mode}: the replayed frame differs "
                         "from eager, or the frame is malformed")
                images.append(want["image"])
            if torch.equal(images[0], images[1]):
                fail("phase 11c: the two cameras gave the same image")
            if render_frame_device.cache_size() > new:
                say(f"phase 11b: frame {mode} "
                    f"{'spot' if use_spot else 'lambert'}: warm-up + "
                    f"capture {render_frame_device.capture_seconds()[-1]:.3f}"
                    f" s")

    # (d) New vertices reach the replay.
    r = Renderer(scene, cfgs["windowed"], device="cuda")
    before = r.render(camera, [light], light.eye, use_spot=True)["image"]
    verts = np.asarray(scene.vertices, np.float32)
    n = verts.shape[0] // 8           # the last eighth: in view
    moved = model.rotate_subrange(verts, verts[-n:], verts.shape[0] - n,
                                  0.5)
    r.update_vertices(moved)
    got = r.render(camera, [light], light.eye, use_spot=True)
    want = render_frame(r.vertices, *frames[0][1:],
                        **frame_kw("windowed", True))
    diff = bitwise_diffs(frame_leaves(got), frame_leaves(want))
    changed = int((got["image"] != before).any(-1).sum())
    say(f"phase 11d: update_vertices (rotate_subrange of {n} vertices): "
        f"replay vs eager on the new vertices, elements differing {diff}; "
        f"{changed} px changed from the frame before")
    if any(diff.values()) or not changed:
        fail("phase 11d: the replay after update_vertices is not the eager "
             "frame of the new vertices")
    del r, before, got, want

    # (e) The step's replay against the eager step, two targets in turn.
    rng = np.random.default_rng(0)
    for target in (step_args["target"], torch.from_numpy(rng.uniform(
            0.0, 0.3, tuple(step_args["target"].shape)).astype(
                np.float32)).cuda()):
        args = dict(step_args, target=target)
        got = render_and_grad(**args, **step_kw)
        want = render_and_grad.fn(**args, **step_kw)
        diff = bitwise_diffs({k: got[k] for k in step_keys},
                             {k: want[k] for k in step_keys})
        say(f"phase 11e: step replay vs eager: elements differing {diff}; "
            f"loss {float(want['loss'])!r}")
        if any(diff.values()) or bool(want["overflow"]):
            fail("phase 11e: the replayed step differs from the eager step")

    # (f) Steady times, eager against graphed in turns.
    credited = {name: 0 for name in kernels}
    times = {}

    def turns(label, eager, graphed, warm=1, timed=3):
        ev, host, cred = in_turns(eager, graphed, kernels, warm, timed)
        for name, n in cred.items():
            credited[name] += n
        times[label] = {k: (float(np.mean(ev[k])), float(np.mean(host[k])))
                        for k in ev}
        say(f"phase 11f: {label}: ms (CUDA events / host) eager "
            f"{ev['eager']} / {host['eager']}; graphed {ev['graphed']} / "
            f"{host['graphed']}; means eager {times[label]['eager']}, "
            f"graphed {times[label]['graphed']}")

    for mode in ("windowed", "reference"):
        kw = frame_kw(mode, True)
        turns(f"{mode} frames 2-4",
              lambda: render_frame(*frames[0], **kw),
              lambda: render_frame_device(*frames[0], **kw))
    turns("steps 1-4", lambda: render_and_grad.fn(**step_args, **step_kw),
          lambda: render_and_grad(**step_args, **step_kw), warm=1, timed=4)
    target = np.zeros((flagship.screen_height, flagship.screen_width, 3),
                      np.float32)
    train_ms = {"eager": [], "graphed": []}
    for name, fn in (("eager", render_and_grad.fn),
                     ("graphed", render_and_grad),
                     ("graphed", render_and_grad), ("eager",
                                                    render_and_grad.fn)):
        for k in kernels.values():
            k.launches = 0
        _, ev, host = timed_train(fn, scene, [camera], light, light.eye,
                                  [target], cfgs["windowed"],
                                  TrainConfig(steps=5))
        train_ms[name].append((float(np.mean(ev[1:])),
                               float(np.mean(host[1:]))))
        if name == "graphed":
            for n, k in kernels.items():
                credited[n] += k.launches
    say(f"phase 11f: train() ms per step (steps 1-4; CUDA events, host), "
        f"eager {train_ms['eager']}, graphed {train_ms['graphed']}")
    say(f"phase 11f: K1-K3 launches credited to the graphed runs "
        f"{credited}")
    if min(credited.values()) <= 0:
        fail("phase 11f: a kernel of the programs was never launched")

    # (g) One profiled replay of a frame and of a step.
    for label, fn in (
            ("phase 11g: replayed windowed frame",
             lambda: render_frame_device(*frames[0],
                                         **frame_kw("windowed", True))),
            ("phase 11g: replayed step",
             lambda: render_and_grad(**step_args, **step_kw))):
        names = profile_once(label, fn, top_n=10)
        pats = dict(SWEEP_KERNELS)
        if "step" in label:
            pats.update(G1_KERNELS)
        missing = [k for k, pat in pats.items()
                   if not any(re.search(pat, n) for n in names)]
        if "step" in label and any(re.search(INDEX_ADD_KERNEL, n)
                                   for n in names):
            missing.append("no index_add_")
        say(f"{label}: {len(names)} distinct kernels; K1-K3 by name: "
            f"{'all present' if not missing else f'missing {missing}'}")
        if missing:
            fail(f"{label}: {missing} not among the replay's kernels")

    # (i) No fallback: a body that reads on the host cannot be captured.
    def host_read(x):
        return x * x.sum().item()

    try:
        Program(host_read, static=())(torch.ones(4, device="cuda"))
    except RuntimeError as e:
        refused = str(e).strip().splitlines()[0]
    else:
        refused = None
    if refused is None:
        fail("phase 11i: a body with .item() was captured")
    torch.cuda.synchronize()
    got = render_frame_device(*frames[0], **frame_kw("windowed", True))
    want = render_frame(*frames[0], **frame_kw("windowed", True))
    diff = bitwise_diffs(frame_leaves(got), frame_leaves(want))
    say(f"phase 11i: a body with .item() raised at capture ({refused[:120]});"
        f" a replay after it still equals eager: {not any(diff.values())}")
    if any(diff.values()):
        fail("phase 11i: the card misbehaves after a refused capture")
    return credited


def dist_main(args):
    """--dist: the sharded path across the cards of one host, one rank per
    card, under ``python -m torch.distributed.run --standalone
    --nproc_per_node=N chip_smoke.py --dist``.  Rank 0 prints."""
    import datetime
    import tempfile
    import unittest.mock as mock

    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke --dist needs NVIDIA GPUs")
    if "LOCAL_RANK" not in os.environ:
        fail("chip_smoke --dist runs under torch.distributed.run (torchrun)")
    local = int(os.environ["LOCAL_RANK"])

    from ugrt_torch.api import checkpoint
    from ugrt_torch.api import train as tmod
    from ugrt_torch.api.renderer import render_frame_device
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.diff.render_grad import render_and_grad, render_color
    from ugrt_torch.dist import mesh as dmesh
    from ugrt_torch.kernels import _build
    from ugrt_torch.kernels import heavy_primary_sweep as k2
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.kernels.uniform_dda import uniform_dda
    from ugrt_torch.scene import procedural

    torch.backends.cuda.matmul.allow_tf32 = False
    # No device_id: make_mesh alone must make the rank's card current.
    dist.init_process_group("nccl",
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = dmesh.make_mesh()
        dev, n, rank0 = mesh.device, mesh.world_size, mesh.rank == 0
        MAX = dist.ReduceOp.MAX

        def say0(msg):
            if rank0:
                say(msg)

        def worst(*xs):
            """Each value's largest over the ranks (floats)."""
            t = torch.tensor([float(x) for x in xs], dtype=torch.float64,
                             device=dev)
            dist.all_reduce(t, op=MAX)
            return t.tolist()

        def differs_from_rank0(x):
            """Words in which this rank's ``x`` differs from rank 0's."""
            x = x.detach().reshape(-1)
            ref = x.clone()
            dist.broadcast(ref, 0)
            return int((ref.view(torch.int32) != x.view(torch.int32)).sum())

        bound = worst(dev != torch.device("cuda", local),
                      torch.cuda.current_device() != local)
        if rank0:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()
            say(f"dist: {n} ranks, backend {dist.get_backend()}, torch "
                f"{torch.__version__}, CUDA {torch.version.cuda}; cards:")
            for line in smi:
                say(line)
        say0(f"dist: each rank's mesh device is cuda:LOCAL_RANK and its "
             f"current device: {not any(bound)}")
        if any(bound):
            fail("dist: a rank is not bound to its card")
        if rank0:
            path, nvcc_s = _build.build("kernels")
            say(f"dist: built {path.name} in {nvcc_s:.1f} s (nvcc)")
        dist.barrier(device_ids=[local])
        _build.library("kernels")

        camera, light = CameraSpec(**CAMERA), CameraSpec(**LIGHT)
        flagship = RenderConfig()
        scene = procedural.cathedral(num_faces_target=75000, seed=args.seed)
        cap = flagship.pair_capacity(scene.num_faces)
        cams = (camera, CameraSpec(**CAMERA_2))
        kernels = {"primary_sweep": k1.primary_sweep,
                   "heavy_primary_sweep": k2.heavy_primary_sweep,
                   "shadow_sweep": k3.shadow_sweep}
        launches = dict.fromkeys(kernels, 0)
        credited = dict.fromkeys(kernels, 0)

        def on_sharded_path(fn):
            """fn(), with K1-K3's launches in it added to ``launches``."""
            for k in kernels.values():
                k.launches = 0
            out = fn()
            for name, k in kernels.items():
                launches[name] += k.launches
            return out

        def words(a, b):
            """Elements whose bits differ between a and b."""
            if a.dtype.is_floating_point:
                a, b = a.view(torch.int32), b.view(torch.int32)
            return int((a != b).sum())

        def turns(label, eager, graphed, bare, timed):
            """Eager body, replay, the bare replay, in turns; K1-K3's
            launches credited to the replays."""
            ev, host, cred = in_turns(eager, graphed, kernels, warm=1,
                                      timed=timed, bare=bare)
            for name, c in cred.items():
                credited[name] += c
            w = worst(*ev["graphed"])
            say0(f"dist: {label}: ms (CUDA events / host, rank 0) eager "
                 f"{ev['eager']} / {host['eager']}; graphed {ev['graphed']} "
                 f"/ {host['graphed']} (slowest rank {w}); bare {ev['bare']}"
                 f" / {host['bare']}; means eager {np.mean(ev['eager']):.3f},"
                 f" graphed {np.mean(ev['graphed']):.3f}, bare "
                 f"{np.mean(ev['bare']):.3f}")

        programs = []
        for mode in ("windowed", "reference", "extent"):
            cfg = dataclasses.replace(flagship, light_grid_mode=mode)
            kw = dict(cfg=cfg, capacity=cap, num_lights=1, use_spot=True)
            frames = [[step_inputs(scene, cfg, c, light, dev)[k]
                       for k in FRAME_KEYS] for c in cams]
            render = dmesh.sharded_render(mesh, **kw)
            programs.append(render)
            # The first camera records the key, the second replays it.
            outs = [on_sharded_path(lambda f=f: render(*f)) for f in frames]
            for ci, (f, (got, ovf_g)) in enumerate(zip(frames, outs)):
                img_e, ovf_e = render.fn(*f)
                want, ovf_w = render_color(*f, **kw)
                w_mism, w_eager, w_rank0, w_ovf = worst(
                    words(got, want), words(got, img_e) + words(ovf_g, ovf_e),
                    differs_from_rank0(got), bool(ovf_g) or bool(ovf_w))
                say0(f"dist: {mode} camera {ci + 1}: {n}-rank replayed "
                     f"sharded {tuple(got.shape)} image: at most "
                     f"{int(w_mism)} words differ from each card's "
                     f"render_color, {int(w_eager)} elements from its eager "
                     f"body, {int(w_rank0)} words from rank 0's; overflow "
                     f"{bool(w_ovf)}")
                if w_mism or w_eager or w_rank0 or w_ovf or tuple(
                        got.shape) != (cfg.screen_height, cfg.screen_width,
                                       3):
                    fail(f"dist: {mode}: the replayed sharded image differs")
            if torch.equal(outs[0][0], outs[1][0]):
                fail(f"dist: {mode}: the two cameras gave the same image")
            if mode == "windowed":
                fi = frame_inputs(scene, cfg, camera, light, dev)
                turns("sharded windowed frame (bare: render_frame_device)",
                      lambda: render.fn(*frames[0]),
                      lambda: render(*frames[0]),
                      lambda: render_frame_device(*fi, **kw), 3)

        cfg = dataclasses.replace(flagship, light_grid_mode="windowed")
        kw = dict(cfg=cfg, capacity=cap, num_lights=1, use_spot=True)
        inputs = step_inputs(scene, cfg, camera, light, dev)
        sf = [inputs[k] for k in FRAME_KEYS]
        targets = (inputs["target"], torch.from_numpy(
            np.random.default_rng(0).uniform(0.0, 0.3, tuple(
                inputs["target"].shape)).astype(np.float32)).to(dev))
        step = dmesh.sharded_train_step(mesh, **kw)
        programs.append(step)
        names = ("loss", "grad_vertices", "grad_materials", "overflow")
        outs = [on_sharded_path(lambda t=t: step(*sf, t)) for t in targets]
        for ti, (t, out) in enumerate(zip(targets, outs)):
            got = dict(zip(names, out))
            eager = dict(zip(names, step.fn(*sf, t)))
            ref = render_and_grad(*sf, t, **kw)

            def rel(a, b):
                """max |a - b| / max |b|."""
                return float((a.double() - b.double()).abs().max()
                             / b.double().abs().max())

            w = worst(rel(got["loss"], ref["loss"]),
                      rel(got["grad_vertices"], ref["grad_vertices"]),
                      rel(got["grad_materials"], ref["grad_materials"]),
                      bool(got["overflow"]),
                      differs_from_rank0(got["loss"]),
                      differs_from_rank0(got["grad_vertices"]),
                      differs_from_rank0(got["grad_materials"]),
                      words(got["overflow"], eager["overflow"]),
                      *(words(got[k], eager[k]) for k in names[:3]),
                      *(rel(got[k], eager[k]) for k in names[:3]))
            say0(f"dist: target {ti + 1}: replayed sharded step: loss "
                 f"{float(got['loss'])!r} vs render_and_grad "
                 f"{float(ref['loss'])!r}; worst rank: loss rel {w[0]:.3e}, "
                 f"grad max|diff|/max|g| vertices {w[1]:.3e}, materials "
                 f"{w[2]:.3e}; overflow {bool(w[3])}; words differing from "
                 f"rank 0's: loss {int(w[4])}, gradients {int(w[5])}, "
                 f"{int(w[6])}; against its eager body: overflow "
                 f"{int(w[7])}, words differing loss {int(w[8])}, gradients "
                 f"{int(w[9])}, {int(w[10])}, largest relative difference "
                 f"{w[11]:.3e}, {w[12]:.3e}, {w[13]:.3e}")
            if (w[0] > 1e-5 or max(w[1:3]) > 1e-6 or any(w[3:8])
                    or any(w[8:11])):
                fail("dist: the replayed sharded step disagrees with its "
                     "eager body, with the bare step, with rank 0 or in "
                     "its overflow")
        if torch.equal(outs[0][0], outs[1][0]):
            fail("dist: the two targets gave the same loss")
        turns("sharded step (bare: render_and_grad)",
              lambda: step.fn(*sf, targets[0]),
              lambda: step(*sf, targets[0]),
              lambda: render_and_grad(*sf, targets[0], **kw), 4)
        nccl_profile(lambda: step(*sf, targets[0]), label="dist (replay)",
                     show=rank0)
        w = worst(*(-v for v in launches.values()),
                  *(-v for v in credited.values()))
        say0(f"dist: K1-K3 launches on rank 0's sharded path (3 modes x 2 "
             f"cameras of frames, 2 targets of steps) {launches}; credited "
             f"to its timed replays {credited}")
        if max(w) >= 0:
            fail("dist: a kernel of the sharded path was never launched")
        for prog in programs:
            prog.clear()

        # train(use_mesh=True): 3 steps, then a resume to 5, a checkpoint
        # every 2 steps, against the same two runs on one card.
        target = np.zeros((cfg.screen_height, cfg.screen_width, 3),
                          np.float32)
        shared = [tempfile.mkdtemp(prefix="ugrt_ck_") if rank0 else None]
        dist.broadcast_object_list(shared, 0)
        saves = []
        save = checkpoint.save_checkpoint

        def counted(*a, **k):
            saves.append(a[2] if len(a) > 2 else k["step"])
            return save(*a, **k)

        runs = {}
        with tempfile.TemporaryDirectory() as own, mock.patch.object(
                checkpoint, "save_checkpoint", counted):
            for use_mesh, d in ((True, shared[0]), (False, own)):
                logs = []
                for steps in (3, 5):
                    verts, mats, log = tmod.train(
                        scene, [camera], light, light.eye, [target], cfg,
                        tmod.TrainConfig(steps=steps, checkpoint_dir=d,
                                         checkpoint_every=2,
                                         use_mesh=use_mesh),
                        verbose=False, device=dev)
                    logs.append(log)
                    if use_mesh:
                        dist.barrier(device_ids=[local])
                runs[use_mesh] = (logs, verts, mats, checkpoint.latest_step(d))
                if use_mesh:
                    mesh_saves = list(saves)
        (logs, verts, mats, latest), single = runs[True], runs[False]
        flat = np.asarray(logs[0] + logs[1])
        rel = float(np.abs(flat - np.asarray(single[0][0] + single[0][1])
                           ).max() / np.abs(flat).max())
        dv = float((verts - single[1]).abs().max())
        dm = float((mats - single[2]).abs().max())
        w = worst(rel, differs_from_rank0(verts), differs_from_rank0(mats),
                  len(mesh_saves) if not rank0 else 0,
                  mesh_saves != [1, 3] if rank0 else 0,
                  [len(x) for x in logs] != [3, 3], latest != 3)
        say0(f"dist: train(use_mesh=True) 3 steps, then a resume from the "
             f"step-1 checkpoint to 5: "
             f"losses {flat.tolist()}; against one card: worst rank loss rel "
             f"{w[0]:.3e}, rank 0 max |dvertices| {dv:.3e}, |dmaterials| "
             f"{dm:.3e}; parameter words differing from rank 0's "
             f"{int(w[1])}, {int(w[2])}; rank 0 saved steps {mesh_saves}, "
             f"other ranks saved {int(w[3])}; latest checkpoint {latest}")
        if w[0] > 1e-5 or any(w[1:]):
            fail("dist: train(use_mesh=True) disagrees with one card, with "
                 "rank 0, or in its checkpoints")

        def train_ms(use_mesh):
            """Host ms of train()'s steps 1-4 of 6 (step 0 records the
            step's key), each from its step's start to the next one's
            (a step ends in its host read; the last step, whose interval
            would take in the program's release, is not timed)."""
            marks = []

            def marked(fn):
                def call(*a, **k):
                    marks.append(time.perf_counter())
                    return fn(*a, **k)
                return call

            make = dmesh.sharded_train_step
            with mock.patch.object(tmod, "render_and_grad",
                                   marked(tmod.render_and_grad)), \
                    mock.patch.object(dmesh, "sharded_train_step",
                                      lambda *a, **k: marked(make(*a, **k))):
                tmod.train(scene, [camera], light, light.eye, [target], cfg,
                           tmod.TrainConfig(steps=6, use_mesh=use_mesh),
                           verbose=False, device=dev)
            return [(b - a) * 1e3 for a, b in zip(marks[1:-1], marks[2:])]

        step_ms = {True: [], False: []}
        for use_mesh in (True, False, False, True):
            step_ms[use_mesh] += train_ms(use_mesh)
        w = worst(np.mean(step_ms[True]))
        say0(f"dist: train() ms per step (steps 1-4, host; mesh / one card "
             f"/ one card / mesh, rank 0): use_mesh {step_ms[True]} (mean "
             f"{np.mean(step_ms[True]):.3f}, slowest rank {w[0]:.3f}); one "
             f"card {step_ms[False]} (mean {np.mean(step_ms[False]):.3f})")

        # Phase 12 at this world: the bench's sharded step on every rank,
        # in this process (its group helper takes this group).
        from ugrt_torch import bench

        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(["--mesh", str(n)])
        if rank0:
            line = json.loads(out.getvalue().strip().splitlines()[-1])
            d = line["detail"]
            say(f"dist: bench --mesh {n} ({time.perf_counter() - t0:.1f} s):"
                f" {line['value']!r} {line['unit']}; chained "
                f"{d['step_ms_chained']!r} ms (CUDA events "
                f"{d['step_ms_chained_events']!r}), fenced "
                f"{d['step_ms_fenced']!r} ({d['step_ms_fenced_events']!r}),"
                f" slowest rank; parity shadow px (rank 0) "
                f"{d.get('parity_shadow_px')}")
            if (not line["value"] > 0 or f"mesh={n}" not in line["unit"]
                    or d.get("parity_shadow_px", 99)
                    > bench.PARITY_SHADOW_PX):
                fail(f"dist: bench --mesh {n}: bad result line")

        # Phase 13 at this world: where the sharded step's all-reduces sit
        # (micro.trace_psum_overlap on every rank; rank 0 prints).
        from ugrt_torch.micro import trace_psum_overlap

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            rep = trace_psum_overlap.run(mesh, cfg, scene, d)
        w = worst(-rep["all_reduces"])
        say0(f"dist: trace_psum_overlap at world {n} "
             f"({time.perf_counter() - t0:.1f} s): {rep['all_reduces']} "
             f"all-reduce kernels on rank 0 (fewest on a rank {int(-w[0])})")
        # A group of one reduces in place: NCCL launches no kernel.
        if n > 1 and w[0] >= 0:
            fail(f"dist: trace_psum_overlap at world {n} found no all-reduce "
                 "kernel")
        if rank0:
            import shutil

            shutil.rmtree(shared[0], ignore_errors=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
    finally:
        # train(use_mesh=True) keeps its step's graph, whose NCCL work
        # must go before the group does (dist/mesh.py).
        dmesh.clear()
        dist.destroy_process_group()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the procedural cathedral")
    ap.add_argument("--dist", action="store_true",
                    help="the sharded path across N cards, one rank each, "
                         "under torch.distributed.run --nproc_per_node=N")
    args = ap.parse_args(argv)
    if args.dist:
        return dist_main(args)
    started = time.perf_counter()

    import torch

    # Phase 1: the card.
    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    say(smi)

    import numpy as np

    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.config import RenderConfig
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.kernels import _build
    from ugrt_torch.kernels import heavy_primary_sweep as k2
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_bin as b1
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.kernels.segment_sum import face_corner_sum, segment_sum
    from ugrt_torch.kernels.shadow_tris import shadow_tris
    from ugrt_torch.kernels.uniform_dda import uniform_dda
    from ugrt_torch.scene import procedural

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build both libraries at once (every source's nvcc starts
    # together).
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        futures = {lib: pool.submit(_build.build, lib)
                   for lib in _build.LIBRARIES}
        built = {lib: f.result() for lib, f in futures.items()}
    for lib, (path, nvcc_s) in built.items():
        _build.library(lib)
        say(f"phase 2: built {lib} ({path.name}) in {nvcc_s:.1f} s (nvcc, "
            f"beside the other library's build)")
        log = path.with_suffix(".log")
        for name, regs, stores, loads in ptxas_kernels(
                log.read_text() if log.exists() else ""):
            say(f"  ptxas: {name}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
    say(f"phase 2: both built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    camera = CameraSpec(**CAMERA)
    light = CameraSpec(**LIGHT)
    lp = LIGHT["eye"]
    flagship = RenderConfig()            # 1024^2, 128x128 grid, 1 slab
    t0 = time.perf_counter()
    scene = procedural.cathedral(num_faces_target=75000, seed=args.seed)
    say(f"  scene: procedural cathedral, {scene.num_faces} faces, seed "
        f"{args.seed} ({time.perf_counter() - t0:.1f} s)")

    # Phase 3: every kernel against its plain version.
    results = kernel_phase(scene, flagship, camera, light)
    bins = bin_phase(scene, flagship, camera, light)

    # Phase 4: the small frame on the card against the port on the CPU.
    small = dataclasses.replace(flagship, screen_width=128,
                                screen_height=128, grid_x=16, grid_y=16)
    box = procedural.cornell_box(subdiv=2)
    g_cam, g_light = CameraSpec(**GENERIC_CAMERA), CameraSpec(**GENERIC_LIGHT)
    out, out_cpu = (Renderer(box, small, device=d).render(
        g_cam, [g_light], g_light.eye, use_spot=True) for d in ("cuda", "cpu"))
    img = out["image"].cpu().numpy()
    sh = out["shadowed"].cpu().numpy()
    px_img = int((img != out_cpu["image"].numpy()).any(axis=-1).sum())
    px_sh = int((sh != out_cpu["shadowed"].numpy()).sum())
    n_px = img.shape[0] * img.shape[1]
    say(f"phase 4: cornell 128^2 spot, card vs the port on the CPU: "
        f"{px_img} image px, {px_sh} shadow px differ of {n_px} (bound "
        f"{int(CPU_PIXEL_BOUND * n_px)}); shadowed px {int(sh.sum())}")
    if img.shape != (128, 128, 3) or not torch.isfinite(out["color"]).all():
        fail("phase 4: malformed frame")
    if max(px_img, px_sh) > CPU_PIXEL_BOUND * n_px or sh.sum() < 100:
        fail("phase 4: the card's frame disagrees with the CPU's")

    # Phase 5: the main path, flagship frames.
    b1_wrappers = {"shadow_rays": b1.shadow_rays,
                   "shadow_tris": shadow_tris,
                   "unpermute": b1.unpermute,
                   "window_angles": b1.window_angles}
    for k in (k1.primary_sweep, k2.heavy_primary_sweep, k3.shadow_sweep):
        k.launches = 0
    frame_ms = {}
    b1_launches = {}
    for mode in ("windowed", "reference"):
        for w in b1_wrappers.values():
            w.launches = 0
        cfg = dataclasses.replace(flagship, light_grid_mode=mode)
        r = Renderer(scene, cfg, device="cuda")
        times = []
        for i in range(FRAMES):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            out = r.render(camera, [light], lp)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - h0) * 1e3
            ev = start.elapsed_time(end)
            times.append(ev)
            overflow = bool(out["overflow"])
            hit = float((out["primary"]["face_id"] >= 0).float().mean())
            say(f"phase 5: {mode} frame {i + 1} "
                f"({'spot' if i else 'lambert'}"
                f"{', warmup' if i == 0 else ''}): {ev:.3f} ms (CUDA "
                f"events), {wall:.3f} ms host; overflow {overflow}; hit "
                f"fraction {hit:.4f}; shadowed px "
                f"{int(out['shadowed'].sum())}")
            if overflow:
                fail(f"phase 5: {mode}: grid capacity overflow")
            if (tuple(out["image"].shape) != (1024, 1024, 3)
                    or not torch.isfinite(out["color"]).all() or hit < 0.5):
                fail(f"phase 5: {mode}: malformed frame")
        frame_ms[mode] = times
        b1_launches[mode] = {n: w.launches for n, w in b1_wrappers.items()}
        del r
    launches = {"primary_sweep": k1.primary_sweep.launches,
                "heavy_primary_sweep": k2.heavy_primary_sweep.launches,
                "shadow_sweep": k3.shadow_sweep.launches}
    say(f"phase 5: launches {launches}; steady-state ms "
        + ", ".join(f"{m} {np.mean(t[1:]):.3f}" for m, t in
                    frame_ms.items()))
    if min(launches.values()) <= 0:
        fail("phase 5: a kernel of the path was never launched")
    # One light: B1's and B2's wrappers as often as each other (the
    # window's in windowed mode only), credited per replay of the frame's
    # graph.
    say(f"phase 5: B1 and B2 launches {b1_launches}")
    for mode, got in b1_launches.items():
        n = got["shadow_rays"]
        if (n < FRAMES or got["unpermute"] != n or got["shadow_tris"] != n
                or got["window_angles"] != (n if mode == "windowed" else 0)):
            fail(f"phase 5: {mode}: B1's and B2's launches are not one a "
                 f"light and frame")
    profile_frames(scene, flagship, camera, light, lp)

    # Phase 6: the differentiable step (and G1 alone, 6g); phase 7: the
    # probes (the kernels' counts are reset before each path and read
    # after it).  The step's paths also launch G1.
    k_wrappers = {"primary_sweep": k1.primary_sweep,
                  "heavy_primary_sweep": k2.heavy_primary_sweep,
                  "shadow_sweep": k3.shadow_sweep,
                  "shadow_tris": shadow_tris}
    step_kernels = dict(k_wrappers, face_corner_sum=face_corner_sum,
                        segment_sum=segment_sum)
    step_launches, step_ms = step_phase(scene, flagship, camera, light,
                                        step_kernels)
    g1 = gather_phase(scene, flagship, camera, light, args.seed)
    probes = probe_phase()

    # Phase 8: the reflective frame (its program, and D1); phase 9: the
    # training loop.
    t0 = time.perf_counter()
    reflect_launches, dda = reflect_phase(
        scene, flagship, camera, light,
        dict(k_wrappers, uniform_dda=uniform_dda))
    say(f"phase 8 took {time.perf_counter() - t0:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - started:.1f} s")
    train_launches = train_phase(scene, flagship, camera, light,
                                 step_kernels)

    # Phase 10: sharding (an NCCL group of one, strips on one card), the
    # native host library, build_packets.
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(scene, flagship, camera, light, step_kernels)
    strip_phase(scene, flagship, camera, light, k_wrappers)
    native_phase(scene, flagship, camera, light)
    packet_phase(scene, flagship, camera, light)
    say(f"phase 10 took {time.perf_counter() - t0:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - started:.1f} s")

    # Phase 11: one dispatch per frame and per step.
    t0 = time.perf_counter()
    program_launches = program_phase(scene, flagship, camera, light,
                                     step_kernels)
    say(f"phase 11 took {time.perf_counter() - t0:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - started:.1f} s")

    # Phase 12: the bench entries.
    t0 = time.perf_counter()
    bench_launches = bench_phase(dict(step_kernels, uniform_dda=uniform_dda),
                                 step_ms)
    say(f"phase 12 took {time.perf_counter() - t0:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - started:.1f} s")

    # Phase 13: the profiling modules.
    t0 = time.perf_counter()
    profile_launches = profiling_phase()
    say(f"phase 13 took {time.perf_counter() - t0:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - started:.1f} s")

    def entry(name, sites_, source, replaces, more=()):
        # The numbers sum the windowed frame's sites (``sites_``); the
        # reference frame's (``more``) are reported beside them.
        rs = [results[s] for s in sites_]
        b_ms = sum(r["bound_ms"] for r in rs)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "step_launches": step_launches[name],
                "reflect_launches": reflect_launches[name],
                "train_launches": train_launches[name],
                "mesh_launches": mesh_launches[name],
                "program_launches": program_launches[name],
                "bench_launches": bench_launches[name],
                "profile_launches": profile_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs),
                "kernel_ms": sum(r["kernel_ms"] for r in rs),
                "host_ms": sum(r["host_ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": b_ms,
                "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
                "needed_tests": sum(r["needed_tests"] for r in rs),
                "library_ms": None, "library_none": NO_LIBRARY[name],
                "sites": {s: results[s] for s in (*sites_, *more)}}

    kernels = [
        entry("primary_sweep", ["primary_sweep"],
              "ugrt_torch/csrc/primary_sweep.cu",
              "ugrt/trace/pallas_tracer.py:304"),
        entry("heavy_primary_sweep", ["heavy_primary_sweep"],
              "ugrt_torch/csrc/heavy_primary_sweep.cu",
              "ugrt/trace/pallas_tracer.py:641"),
        entry("shadow_sweep", ["shadow_sweep", "shadow_sweep box=True"],
              "ugrt_torch/csrc/shadow_sweep.cu",
              "ugrt/trace/pallas_tracer.py:390",
              more=["reference: shadow_sweep",
                    "reference: shadow_sweep box=True"]),
    ]
    main_dda = dda["flagship reference"]
    kernels.append({
        "name": "uniform_dda", "route": "cuda",
        "source": "ugrt_torch/csrc/uniform_dda.cu",
        "replaces": "ugrt/trace/reflect.py:56 (trace_uniform_dda: XLA "
                    "control flow, not a Pallas kernel)",
        "launches": reflect_launches["uniform_dda"],
        "bench_launches": bench_launches["uniform_dda"],
        "max_abs_err": max(r["max_abs_err"] for r in dda.values()),
        **{k: main_dda[k] for k in ("ms", "kernel_ms", "host_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "half_rate_floor_ms",
                                     "needed_tests", "staged_lane_slots",
                                     "lockstep_lane_slots",
                                     "cells_per_round")},
        "library_ms": None, "library_none": NO_LIBRARY["uniform_dda"],
        "sites": dda})
    for name, site, replaces in (
            ("face_corner_sum", "corner",
             "ugrt/diff/fastgrad.py:129 (_face_corners_bwd, the transpose "
             "of gather_face_corners / gather_face_data)"),
            ("segment_sum", "material",
             "ugrt/diff/fastgrad.py:172 (_rows_bwd, the transpose of "
             "gather_rows)")):
        r = g1[site]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ugrt_torch/csrc/segment_sum.cu",
            "replaces": replaces + ": a custom VJP, not a Pallas kernel",
            "launches": step_launches[name],
            "step_launches": step_launches[name],
            "train_launches": train_launches[name],
            "mesh_launches": mesh_launches[name],
            "program_launches": program_launches[name],
            "bench_launches": bench_launches[name],
            "profile_launches": profile_launches[name],
            **{k: r[k] for k in ("max_abs_err", "ms", "kernel_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "library": "index_add_ of the int64 fixed-point values (and its "
                       "zero fill)",
            "site": r})
    kernels.append({
        "name": "shadow_rays", "route": "cuda",
        "source": "ugrt_torch/csrc/shadow_bin.cu",
        "replaces": "no Pallas kernel: the XLA ops around ugrt's shadow "
                    "sweep (ugrt/trace/shadow.py: light_window, the ray "
                    "binning, the payload sort, the rows, _unpermute)",
        "launches": sum(m["shadow_rays"] for m in b1_launches.values()),
        "library_ms": None,
        "library_none": "no single PyTorch call bins rays by light cell, "
                        "sorts them stably and lays out their rows",
        **{k: bins["flagship: reference"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "sites": bins})
    ref = bins["flagship: reference"]
    kernels.append({
        "name": "shadow_tris", "route": "cuda",
        "source": "ugrt_torch/csrc/shadow_tris.cu",
        "replaces": "no Pallas kernel: the XLA ops between ugrt's ray side "
                    "and its shadow sweep (pack_tri_windows_coeff, "
                    "window_span, heavy_coeffs, spatial_reorder_heavy, "
                    "pack_heavy_coeff_windows, heavy_window_rects, "
                    "heavy_block_window_range)",
        "launches": sum(m["shadow_tris"] for m in b1_launches.values()),
        "step_launches": step_launches["shadow_tris"],
        "reflect_launches": reflect_launches["shadow_tris"],
        "train_launches": train_launches["shadow_tris"],
        "mesh_launches": mesh_launches["shadow_tris"],
        "program_launches": program_launches["shadow_tris"],
        "bench_launches": bench_launches["shadow_tris"],
        "library_ms": None,
        "library_none": "no single PyTorch call packs a grid's pairs into "
                        "coefficient rows and ranks the heavy list",
        "ms": ref["tris_ms"], "plain_ms": ref["tris_plain_ms"],
        "bound_ms": ref["tris_bound_ms"], "bound_by": "bytes"})
    kernels += probes
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
