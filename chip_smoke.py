#!/usr/bin/env python3
"""Smoke test of ugrt_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases (each prints a line; any failure raises and exits non-zero):
 1. CUDA must be available; prints the card's name and power limit.
 2. Builds the CUDA kernels from ugrt_torch/csrc with nvcc.
 3. Renders one flagship frame (1024^2, 128x128 grid, the 75k-triangle
    procedural cathedral, windowed light grid), records the inputs each
    sweep kernel gets on that path, and holds every kernel against its
    plain PyTorch version on them: K1/K2 bitwise, K3 exact.  Prints
    mismatches and CUDA-event ms of kernel vs plain.
 4. Renders the Cornell box at 128^2 on the card and holds the u8 image
    and shadow mask against the numpy oracle (ugrt.ref.oracle): at most
    0.1% of pixels may differ.
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
    mma within its bound), then timed; every probe kernel must have
    launched.
Then one JSON line with the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports no JAX.  The scenes are procedural and made from --seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

# Flagship camera and light: bench.py:170-179 (the reference's sibenik
# presets, ugrt/api/cli.py:28-30).
CAMERA = dict(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
              up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = dict(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
             up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
ORACLE_PIXEL_BOUND = 1e-3      # README.md:108-113: knife-edge rays
FRAMES = 4                     # per light mode; frame 1 is the warmup
STEPS = 4                      # timed fwd+bwd steps after one warm-up
GRAD_REL = 1e-5                # card vs CPU gradients, times max|g|
# The rotated Cornell box of tests/test_grad.py:154-182.
CORNELL_ANGLES = (0.11, 0.07)
CORNELL_CAMERA = dict(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                      up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
CORNELL_LIGHT = dict(eye=(0.1, 0.85, 0.4), look_at=(0.0, -1.0, 0.3),
                     up=(0.0, 0.0, 1.0), near=0.1, far=100.0)


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


def capture_sweep_inputs(render):
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
            site = name + (" box=True" if kwargs.get("box") else "")
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

    from ugrt.scene import procedural

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

    from ugrt.core import camera as cam
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
    c_cam = cam.CameraSpec(**CORNELL_CAMERA)
    c_light = cam.CameraSpec(**CORNELL_LIGHT)
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
    records = []
    for name, mod in mods.items():
        t0 = time.perf_counter()
        recs = mod.run()
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
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "variant": main_variant,
            "variants": {r["variant"]: r["ms"] for r in recs}})
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

    from ugrt.config import RenderConfig
    from ugrt.core import camera as cam
    from ugrt.ref import oracle
    from ugrt.scene import procedural
    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.kernels import _build
    from ugrt_torch.kernels import heavy_primary_sweep as k2
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_sweep as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build.
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.library()
    log = path.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    say(f"phase 2: built {path.name} in {nvcc_s:.1f} s (nvcc), "
        f"{time.perf_counter() - t0:.1f} s with load")
    for ln in ptxas:
        say(f"  ptxas: {ln}")

    camera = cam.CameraSpec(**CAMERA)
    light = cam.CameraSpec(**LIGHT)
    lp = LIGHT["eye"]
    flagship = RenderConfig()            # 1024^2, 128x128 grid, 1 slab
    t0 = time.perf_counter()
    scene = procedural.cathedral(num_faces_target=75000, seed=args.seed)
    say(f"  scene: procedural cathedral, {scene.num_faces} faces, seed "
        f"{args.seed} ({time.perf_counter() - t0:.1f} s)")

    # Phase 3: every kernel against its plain version, on the inputs the
    # flagship windowed frame gives it.
    windowed = dataclasses.replace(flagship, light_grid_mode="windowed")
    r = Renderer(scene, windowed, device="cuda")
    sites = capture_sweep_inputs(
        lambda: r.render(camera, [light], lp, use_spot=True))
    expect = {"primary_sweep", "heavy_primary_sweep", "shadow_sweep",
              "shadow_sweep box=True"}
    if set(sites) != expect:
        fail(f"phase 3: sweep sites seen {sorted(sites)}, expected "
             f"{sorted(expect)}")
    results = {}
    for site, (fn, plain, a, kw) in sites.items():
        out_k = fn(*a, **kw)
        out_p = plain(*a, **kw)
        torch.cuda.synchronize()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        mism = sum(int((x != y).sum()) for x, y in zip(out_k, out_p))
        err = max(float((x.double() - y.double()).abs().max())
                  for x, y in zip(out_k, out_p))
        ms = cuda_ms(lambda: fn(*a, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*a, **kw), 2)
        shapes = ", ".join("x".join(str(d) for d in x.shape) or "scalar"
                           for x in a if isinstance(x, torch.Tensor))
        if len(a) == 4:
            per_block = torch.clamp(a[3] - a[2] + 1, min=0)
            items = (f"{int(per_block.sum())} block x window items, max "
                     f"{int(per_block.max())} per block")
        else:
            items = "every block x every live window"
        say(f"phase 3: {site} ({shapes}; {items}): "
            f"{mism} mismatches, max |diff| {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms")
        if mism:
            fail(f"phase 3: {site} disagrees with its plain version")
        results[site] = (ms, plain_ms, err)
    del r, sites

    # Phase 4: end to end against the numpy oracle, small frame.
    small = dataclasses.replace(flagship, screen_width=128,
                                screen_height=128, grid_x=16, grid_y=16)
    box = procedural.cornell_box(subdiv=2)
    g_cam = cam.CameraSpec(eye=(0.123, 0.071, 2.531),
                           look_at=(-0.037, 0.011, 0.0),
                           up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
    g_light = cam.CameraSpec(eye=(0.13, 0.87, 0.52),
                             look_at=(0.07, -1.0, 0.49), up=(0.0, 0.0, 1.0),
                             near=0.1, far=100.0)
    ores = oracle.render_frame(box, g_cam, [g_light], g_light.eye, small,
                               use_spot=True)
    out = Renderer(box, small, device="cuda").render(
        g_cam, [g_light], g_light.eye, use_spot=True)
    out_cpu = Renderer(box, small, device="cpu").render(
        g_cam, [g_light], g_light.eye, use_spot=True)
    img = out["image"].cpu().numpy()
    sh = out["shadowed"].cpu().numpy()
    px_img = int((img != ores["image"]).any(axis=-1).sum())
    px_sh = int((sh != ores["shadowed"]).sum())
    px_cpu = int((img != out_cpu["image"].numpy()).any(axis=-1).sum())
    n_px = img.shape[0] * img.shape[1]
    say(f"phase 4: cornell 128^2 spot vs numpy oracle: {px_img} image px, "
        f"{px_sh} shadow px differ of {n_px} (bound "
        f"{int(ORACLE_PIXEL_BOUND * n_px)}); vs the port on the CPU: "
        f"{px_cpu} px; shadowed px {int(sh.sum())}")
    if img.shape != (128, 128, 3) or not torch.isfinite(out["color"]).all():
        fail("phase 4: malformed frame")
    if max(px_img, px_sh) > ORACLE_PIXEL_BOUND * n_px or sh.sum() < 100:
        fail("phase 4: the port disagrees with the numpy oracle")

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
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "step_launches": step_launches[name],
                "max_abs_err": max(results[s][2] for s in sites_),
                "ms": sum(results[s][0] for s in sites_),
                "plain_ms": sum(results[s][1] for s in sites_)}

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
