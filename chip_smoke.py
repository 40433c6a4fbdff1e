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
Then one JSON line with the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports no JAX.  The scene is procedural and made from --seed.
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

    def entry(name, sites_, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
