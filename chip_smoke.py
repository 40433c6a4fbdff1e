#!/usr/bin/env python3
"""Smoke test of ugrt_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases (each prints a line; any failure raises and exits non-zero):
 1. CUDA must be available; prints the card's name and power limit.
 2. Builds the CUDA kernels from ugrt_torch/csrc with nvcc; prints each
    kernel's registers and spills (-Xptxas -v).
 3. Renders one flagship frame per light-grid mode (1024^2, 128x128
    grid, the 75k-triangle procedural cathedral, spot; windowed, then
    reference), records the inputs each sweep kernel gets on that path,
    and holds every kernel against its plain PyTorch version on them:
    K1/K2 bitwise, K3 exact; K1 also on its synthetic skewed case (one
    ray block spanning 119 windows beside empty ranges and two-cell
    blocks) at every chunk size, K3 on its skewed case (hundreds of
    windows) and on its all-occluded twin.  Prints mismatches, CUDA-event
    ms of kernel vs plain (and, by torch.profiler, of the CUDA kernel
    alone beside the host time of a call), the (ray, row) tests the
    inputs need against those the kernel walks (K1 and K2: counted by
    the kernels' counting builds, with K1's work items, chunk and
    longest range, and the tests K2's warps skip at the footprint, the
    t-free and the could-win votes and the divisions they take), and the
    bound: the larger of the
    needed flops at the card's published f32 peak and the bytes at its
    memory rate.
 4. Renders the Cornell box at 128^2 on the card and on the CPU (where
    the sweeps run their plain versions); at most 0.1% of pixels of the
    u8 image and of the shadow mask may differ.  The CPU frame is held
    to the numpy oracle by the tests (tests/test_torch_render.py).
 5. Flagship frames through Renderer.render on the card, windowed then
    reference light grid, 4 frames each; every kernel must have launched
    and no grid capacity may overflow.  Prints per-frame ms, then the
    device-busy share and top kernels of one more frame per mode under
    torch.profiler.
 6. The differentiable step render_and_grad on bench.py's flagship
    workload (bench.py:142-211: 1024^2, windowed, spot, one light, zero
    target): one warm-up step, then 4 steps with CUDA-event and host ms,
    loss, |grad|_1 and overflow; K1-K3 must have launched; whether two
    identical steps give bitwise equal gradients; one profiled step.
    Then the rotated Cornell box at 64^2 (tests/test_grad.py:154-182) on
    the card and on the CPU: loss within rtol 1e-5, atol 1e-7, gradients
    within 1e-5 * max|g| (sums in another order).
 7. The probes S1-S3 (ugrt_torch.micro) at their scripts' sizes: every
    variant held against its plain version (S1 fma, S2, S3 bitwise; S1
    mma within its bound), then timed with their bounds, S2's and S3's
    half-rate floors (the f32 work at the rate -fmad=false leaves) and
    S2's per-item copy bytes and copy floor, S3's and K2's warp counts;
    S1's three products also as one torch.bmm (the library yardstick,
    "highest" and TF32); every probe kernel must have launched.
Then one JSON line with the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports no JAX and nothing of ugrt.  The scenes are procedural and made
from --seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

# Flagship camera and light: bench.py:170-179 (the reference's sibenik
# presets, ugrt/api/cli.py:28-30).
CAMERA = dict(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
              up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = dict(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
             up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
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
# The 128^2 Cornell frame of phase 4 (tests/conftest.py's cameras).
GENERIC_CAMERA = dict(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                      up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
GENERIC_LIGHT = dict(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                     up=(0.0, 0.0, 1.0), near=0.1, far=100.0)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): f32 outside the tensor cores, TF32 dense, HBM3.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
HBM_BYTES_S = 3.35e12
# f32 operations per (ray, row) test, counted in each kernel body
# (csrc/): sweeps count + - * / sqrt, compares not; S2 its 9-step chain.
FLOPS_K1 = 43       # pvec 9, det 5, 1/det, u 6, qvec 9, v 6, t 6, u+v
FLOPS_K2 = 21       # det, up, vp 5 each, det2, ud, vd, 1/det, t, ud+vd
FLOPS_K3 = 30       # det 5, 1/det, u 6, v 6, t, u+v, t*d 3, |t*d| 6, +eps
FLOPS_S2 = 41       # 1 product, then 8 x (mul, add, mul, sub, abs)
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
}


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


def bound(flops, nbytes, peak=PEAK_F32):
    """(ms, "operations" or "bytes"): the least time of the work at the
    card's published rates."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def keyed_tests(tri, key_col, rays, ray_key_col):
    """Sum over rays of the real rows (not all-zero coefficients) whose
    cell key equals the ray's."""
    import torch

    rows = tri.reshape(-1, tri.shape[-1])
    real = rows[:, :key_col].abs().amax(dim=1) > 0
    keys = rows[:, key_col].long()
    rk = rays.reshape(-1, rays.shape[-1])[:, ray_key_col].long()
    size = int(max(int(keys.max()), int(rk.max()), 0)) + 1
    counts = torch.bincount(keys[real & (keys >= 0)], minlength=size)
    rk = rk[rk >= 0]
    return int(counts[rk].sum())


def box_tests(boxes, rays, gx_col, grid):
    """Sum over rays of the rows whose footprint box (x0, x1, y0, y1)
    holds the ray's cell (gx, gy), by a summed-area table of the rays'
    cells; empty boxes (x0 > x1) count nothing."""
    import torch

    r = rays.reshape(-1, rays.shape[-1])
    gx, gy = r[:, gx_col].long(), r[:, gx_col + 1].long()
    ok = (gx >= 0) & (gx < grid) & (gy >= 0) & (gy < grid)
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


def sweep_work(site, args, kw, grid):
    """(needed tests, walked tests, flops, bytes, what the work is) of one
    captured sweep call.  K1 and K2 walk what their counting builds
    report; K3 every row of every window of its ranges."""
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
    tri, rays, w_lo, w_hi = args
    walk = window_walk(w_lo, w_hi, tri.shape[0])
    if kw.get("box"):
        need = box_tests(tri[..., 11:15], rays, 5, grid)
    else:
        need = keyed_tests(tri, 10, rays, 4)
    walked = int(walk.sum()) * tri.shape[1] * 128
    return (need, walked, need * FLOPS_K3,
            nbytes(*args) + rays.shape[0] * 128 * 4,
            f"{int(walk.sum())} block x window items, max "
            f"{int(walk.max())} per block")


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
    from ugrt_torch.micro.k3_chunks import (device_ms, skewed_case,
                                            skewed_primary_case)

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
    for name, occ in (("skewed", False), ("skewed all-occluded", True)):
        sites[f"shadow_sweep {name}"] = (
            k3.shadow_sweep, k3.shadow_sweep_plain,
            skewed_case("cuda", 0, occ), dict(cfg=flagship))

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
        # The plain versions are timed on the sites the kernels line
        # reports (the windowed frame's) only: they walk every item.
        plain_ms = (cuda_ms(lambda: plain(*a, **kw), 2) if site in expect
                    else float("nan"))
        need, walked, flops, nbyte, items = sweep_work(site.split(": ")[-1],
                                                       a, kw,
                                                       flagship.grid_x)
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


def profile_frames(scene, flagship, camera, light, lp):
    """torch.profiler over one steady spot frame per light mode: prints
    the device-busy share and the top ops by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ugrt_torch.api.renderer import Renderer

    for mode in ("windowed", "reference"):
        r = Renderer(scene, dataclasses.replace(flagship,
                                                light_grid_mode=mode),
                     device="cuda")
        for _ in range(2):
            r.render(camera, [light], lp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r.render(camera, [light], lp)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        kernels = [e for e in avg if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        say(f"profile: {mode}: frame {wall_ms:.3f} ms host (profiled), "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%),"
            f" {sum(e.count for e in kernels)} kernel launches; top: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                        f" ms x{e.count}" for e in top))


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
    each K kernel over the warm-up and timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    say(f"profile: step: {wall_ms:.3f} ms host (profiled), device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(e.count for e in kern)} kernel launches; top: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
                    f" x{e.count}" for e in top))

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
    return launches


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
        lib = {}
        for name, tf32 in (("highest", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            lib[name] = cuda_ms(lambda: torch.bmm(a, b), 5)
        torch.backends.cuda.matmul.allow_tf32 = False
        del a, b
        torch.cuda.empty_cache()
        extra = {"library_tf32_ms": lib["tf32"]}
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
               f"{extra['library_tf32_ms']:.4f} ms (TF32)" if lib_ms else "")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the procedural cathedral")
    args = ap.parse_args(argv)

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
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.scene import procedural

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build.
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.library()
    log = path.with_suffix(".log")
    say(f"phase 2: built {path.name} in {nvcc_s:.1f} s (nvcc), "
        f"{time.perf_counter() - t0:.1f} s with load")
    for name, regs, stores, loads in ptxas_kernels(
            log.read_text() if log.exists() else ""):
        say(f"  ptxas: {name}: {regs} registers, {stores} bytes spill "
            f"stores, {loads} bytes spill loads")

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
    for k in (k1.primary_sweep, k2.heavy_primary_sweep, k3.shadow_sweep):
        k.launches = 0
    frame_ms = {}
    for mode in ("windowed", "reference"):
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
        del r
    launches = {"primary_sweep": k1.primary_sweep.launches,
                "heavy_primary_sweep": k2.heavy_primary_sweep.launches,
                "shadow_sweep": k3.shadow_sweep.launches}
    say(f"phase 5: launches {launches}; steady-state ms "
        + ", ".join(f"{m} {np.mean(t[1:]):.3f}" for m, t in
                    frame_ms.items()))
    if min(launches.values()) <= 0:
        fail("phase 5: a kernel of the path was never launched")
    profile_frames(scene, flagship, camera, light, lp)

    # Phase 6: the differentiable step; phase 7: the probes.
    k_wrappers = {"primary_sweep": k1.primary_sweep,
                  "heavy_primary_sweep": k2.heavy_primary_sweep,
                  "shadow_sweep": k3.shadow_sweep}
    step_launches = step_phase(scene, flagship, camera, light, k_wrappers)
    probes = probe_phase()

    def entry(name, sites_, source, replaces):
        rs = [results[s] for s in sites_]
        b_ms = sum(r["bound_ms"] for r in rs)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "step_launches": step_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs),
                "kernel_ms": sum(r["kernel_ms"] for r in rs),
                "host_ms": sum(r["host_ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": b_ms,
                "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
                "needed_tests": sum(r["needed_tests"] for r in rs),
                "library_ms": None, "library_none": NO_LIBRARY[name],
                "sites": {s: results[s] for s in sites_}}

    kernels = [
        entry("primary_sweep", ["primary_sweep"],
              "ugrt_torch/csrc/primary_sweep.cu",
              "ugrt/trace/pallas_tracer.py:304"),
        entry("heavy_primary_sweep", ["heavy_primary_sweep"],
              "ugrt_torch/csrc/heavy_primary_sweep.cu",
              "ugrt/trace/pallas_tracer.py:641"),
        entry("shadow_sweep", ["shadow_sweep", "shadow_sweep box=True"],
              "ugrt_torch/csrc/shadow_sweep.cu",
              "ugrt/trace/pallas_tracer.py:390"),
    ] + probes
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
