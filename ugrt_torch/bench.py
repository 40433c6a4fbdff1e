"""Flagship benchmark of the port: primary rays per second, forward and
backward, on one card (the counterpart of bench.py).

    python -m ugrt_torch.bench [--scene foo.obj] [--breakdown]
        [--iters N] [--skip-parity] [--pi-extent] [--device cuda]
    python -m ugrt_torch.bench --mesh 1
    torchrun --nproc_per_node=N -m ugrt_torch.bench --mesh N

Workload: bench.py's, BASELINE config 3, nothing cut: 1024x1024 primary
rays over a 128x128 perspective grid, the procedural cathedral at a
75,000 target (73,824 faces) or an OBJ by ``--scene``, one light, spot
shading, the MSE to a zero target and its whole backward (gradients of
vertices and materials), 20 timed steps.  ``--device cpu`` shrinks it
as bench.py does off the TPU (:140-151): 256x256, a 32x32 grid, an
8,000 target, 2 steps.  The light grid is windowed unless
``--pi-extent`` (the reference's pi-extent mapping).  ``--device cuda``
(the default) without a card exits non-zero; nothing falls back to the
CPU.

Output: one JSON line, the last line of stdout, with bench.py's keys
(:265-284): metric ``primary_rays_per_s_fwd_bwd`` = image pixels / step
seconds, unit, vs_baseline and detail.  ``vs_baseline`` divides by
bench.py's nominal 1e8 rays/s: a target ugrt set itself, not a
measurement on any chip.  ``detail`` adds ``device`` (the card's name)
and, beside each host-clock ms, the CUDA-event ms over the same calls
(``*_events``; None on the CPU): a step loop that the host cannot keep
ahead of the card shows as host ms above event ms.

Timing (bench.py:233-258).  The step is ``diff.render_grad.
render_and_grad``, a captured program: each step is one CUDA graph
replay.  The first call is timed as ``compile_s``: on the card the
eager warm-up and the graph's capture, and the kernel library's nvcc
build when its cache (``ugrt_torch/_build``) is cold and the parity
gate, which runs first, has not built it (``--skip-parity``).  Its
overflow flag must be false.  Then ``min(iters, 5)`` steps fenced one
by one, then ``iters`` steps chained (``chain_ms``): step k's vertices
are step k-1's ``+ grad_vertices[k-1] * 0`` (one elementwise kernel, as
bench.py's jitted chain) and one synchronize ends the window.  The
chained host-clock ms is the headline, as in bench.py.

Parity gate (bench.py:53-99), on the card unless ``--skip-parity``:
``trace_primary`` and ``trace_shadow`` with ``backend="kernel"`` and
``backend="plain"`` on the same 256x256 frame (a 32x32 grid, an
8,000-face cathedral): face_id and t bitwise equal, at most 16 shadow
pixels apart.

``--mesh N``: the step is ``dist.mesh.sharded_train_step`` (a Program),
run by every rank in the same order: under ``torchrun`` N must be the
world size; ``--mesh 1`` without it makes a group of one on a FileStore
in a temporary directory (NCCL on the card, gloo on the CPU), which
measures the sharding's overhead against the unsharded step.  Each ms
is the slowest rank's (an all_reduce MAX), as a JAX timing spans the
whole mesh; rank 0 prints.  As in bench.py, mesh mode reports the
fenced step when the chained one is more than twice it.  Every rank
runs the parity gate on its own card before the group is used.

``--breakdown`` (bench.py:286-319): chained ms over max(3, min(iters,
10)) calls of each stage, each a Program over a closure of the vertices
alone: the perspective grid, the light grid, the primary trace, the
shadow trace and the forward frame (``render_color``).  As bench.py's,
the light-grid and shadow stages build the spherical grid and trace the
shadow rays in the pi-extent parameterization, without the light
window, even when the frame is windowed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ugrt_torch import bridge
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.core.program import Program
from ugrt_torch.diff.render_grad import render_and_grad, render_color
from ugrt_torch.dist import mesh as dmesh
from ugrt_torch.grid import build as gbuild
from ugrt_torch.micro._timing import chain_ms, fenced_ms
from ugrt_torch.scene import model as smodel
from ugrt_torch.scene import procedural
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import shadow as tshadow

NOMINAL_BASELINE = 1.0e8  # rays/s fwd+bwd: ugrt's self-set target
PARITY_SHADOW_PX = 16     # bench.py:95: boundary-pixel flips allowed
# bench.py:170-179 (the reference's sibenik presets).
CAMERA = CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                    up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                   up=(0.0, 1.0, 0.0), near=0.1, far=100.0)


class Workload(NamedTuple):
    """What the bench times: config, scene, timed steps, pair capacity."""

    cfg: RenderConfig
    scene: smodel.Scene
    scene_name: str
    iters: int
    capacity: int


def small_config() -> RenderConfig:
    """bench.py's 256x256 frame over a 32x32 grid (its off-TPU workload
    and its parity gate's)."""
    return dataclasses.replace(RenderConfig(), screen_width=256,
                               screen_height=256, grid_x=32, grid_y=32)


def workload(device="cuda", *, scene_path: str | None = None,
             iters: int = 0, pi_extent: bool = False) -> Workload:
    """bench.py's workload (:140-168): the flagship for a CUDA device,
    the shrunk one for the CPU; host data only (no tensor is made)."""
    if torch.device(device).type == "cuda":
        cfg, tri_target, n = RenderConfig(), 75000, 20
    else:
        cfg, tri_target, n = small_config(), 8000, 2
    if not pi_extent:
        cfg = dataclasses.replace(cfg, light_grid_mode="windowed")
    if scene_path:
        scene = smodel.load_scene(scene_path)
        name = os.path.basename(scene_path)
    else:
        scene = procedural.cathedral(num_faces_target=tri_target)
        name = "procedural-cathedral"
    return Workload(cfg, scene, name, iters or n,
                    cfg.pair_capacity(scene.num_faces))


def step_inputs(w: Workload, device) -> dict:
    """render_and_grad's tensor arguments (bench.py:170-190): the scene,
    the camera, one light, a zero target."""
    cfg = w.cfg
    aspect = cfg.screen_width / cfg.screen_height
    x = bridge.scene_to_torch(w.scene, device)
    x.update(
        camcoords=bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, aspect,
                                            device),
        light_camcoords=bridge.camcoords_to_torch(
            LIGHT, cfg.fovy_deg, aspect, device)[None],
        light_position=bridge.from_numpy(LIGHT.eye, device, np.float32),
        target=torch.zeros((cfg.screen_height, cfg.screen_width, 3),
                           dtype=torch.float32, device=device))
    return x


def make_step(w: Workload, x: dict, mesh=None):
    """(step(vertices, materials) -> (loss, grad_vertices,
    grad_materials, overflow), the sharded Program or None): the step of
    one card, or the sharded step over ``mesh`` (a ``dist.mesh.Mesh``)."""
    kw = dict(cfg=w.cfg, capacity=w.capacity, num_lights=1, use_spot=True)
    fixed = [x[k] for k in ("faces", "mat_index", "camcoords",
                            "light_camcoords", "light_position", "target")]
    if mesh is not None:
        program = dmesh.sharded_train_step(mesh, **kw)
        return (lambda v, m: program(v, m, *fixed)), program

    def step(v, m):
        out = render_and_grad(v, m, *fixed, **kw)
        return (out["loss"], out["grad_vertices"], out["grad_materials"],
                out["overflow"])
    return step, None


def chain(v, out):
    """Step k's vertices: a zero-valued data dependency on step k-1's
    vertex gradient (bench.py:213-217; ``chain_ms``'s ``dep``)."""
    return v + out[1] * 0.0


def parity_gate(device, *, cfg=None, scene=None) -> int:
    """bench.py's parity gate (:53-99): the primary and shadow traces
    with ``backend="kernel"`` against ``backend="plain"`` on the same
    inputs.  Raises unless face_id and t are bitwise equal and at most
    16 shadow pixels differ; returns the shadow pixels that differ.
    Default: bench.py's 256x256 frame of an 8,000-face cathedral;
    ``cfg`` and ``scene`` replace it."""
    cfg = small_config() if cfg is None else cfg
    if scene is None:
        scene = procedural.cathedral(num_faces_target=8000)
    x = bridge.scene_to_torch(scene, device)
    v, f = x["vertices"], x["faces"]
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)
    cap = cfg.pair_capacity(scene.num_faces)
    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    rx = tprimary.trace_primary(v, f, cc, grid, cfg, backend="plain")
    rp = tprimary.trace_primary(v, f, cc, grid, cfg, backend="kernel")
    lgrid = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap)
    sx, sp = (tshadow.trace_shadow(v, f, lcc, lgrid, rx, cc[0:3], cfg,
                                   backend=b) for b in ("plain", "kernel"))
    if not torch.equal(rx["face_id"], rp["face_id"]):
        n = int((rx["face_id"] != rp["face_id"]).sum())
        raise RuntimeError(f"parity gate: primary face ids diverge on chip "
                           f"({n} px)")
    if not torch.equal(rx["t"].view(torch.int32), rp["t"].view(torch.int32)):
        raise RuntimeError("parity gate: primary t diverges on chip")
    nsh = int((sx != sp).sum())
    if nsh > PARITY_SHADOW_PX:
        raise RuntimeError(
            f"parity gate: shadow masks diverge on chip ({nsh} px; "
            "coefficient-form rounding allows only boundary-pixel flips)")
    return nsh


def breakdown_ms(w: Workload, x: dict, n: int) -> dict:
    """bench.py's per-stage table (:286-319): chained ms of each stage,
    host clock and CUDA events (``*_events``)."""
    cfg, cap = w.cfg, w.capacity
    faces, cc, lcc = x["faces"], x["camcoords"], x["light_camcoords"][0]
    programs, ms = [], {}

    def timed(key, fn):
        program = Program(fn, static=())
        programs.append(program)
        timing, out = chain_ms(program, x["vertices"], n=n)
        ms.update({key: timing.host_ms, key + "_events": timing.event_ms})
        return out

    grid = timed("grid_ms", lambda v: gbuild.build_perspective_grid(
        v, faces, cc, cfg=cfg, capacity=cap))
    lgrid = timed("light_grid_ms", lambda v: gbuild.build_spherical_grid(
        v, faces, lcc, cfg=cfg, capacity=cap))
    prim = timed("primary_ms", lambda v: tprimary.trace_primary(
        v, faces, cc, grid, cfg))
    timed("shadow_ms", lambda v: tshadow.trace_shadow(
        v, faces, lcc, lgrid, prim, cc[0:3], cfg))
    timed("forward_ms", lambda v: render_color(
        v, x["materials"], faces, x["mat_index"], cc, x["light_camcoords"],
        x["light_position"], cfg=cfg, capacity=cap, num_lights=1,
        use_spot=True)[0])
    for program in programs:
        program.clear()
    return ms


def _slowest(mesh, values):
    """Each value's largest over the mesh's ranks (None stays None)."""
    if mesh is None:
        return values
    have = [v for v in values if v is not None]
    t = torch.tensor(have, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    it = iter(t.tolist())
    return [None if v is None else next(it) for v in values]


def run(w: Workload, device, *, mesh=None, breakdown: bool = False,
        parity_px: int | None = None) -> dict:
    """Time ``w``'s step on ``device`` (on ``mesh.device`` when ``mesh``,
    a ``dist.mesh.Mesh``, shards it) and return bench.py's result dict
    (module docstring)."""
    device = torch.device(device) if mesh is None else mesh.device
    cfg = w.cfg
    x = step_inputs(w, device)
    verts, mats = x["vertices"], x["materials"]
    step, program = make_step(w, x, mesh)
    try:
        t0 = time.perf_counter()
        out = step(verts, mats)
        float(out[0])
        compile_s = time.perf_counter() - t0
        if bool(out[3]):
            raise RuntimeError(
                "static capacity overflow on the bench scene — the result "
                "would benchmark clipped geometry; raise RenderConfig "
                "capacities")
        fenced, _ = fenced_ms(step, verts, mats, n=min(w.iters, 5))
        chain_t, _ = chain_ms(step, verts, mats, n=w.iters, dep=chain)
        f_host, f_ev, c_host, c_ev, compile_s = _slowest(
            mesh, [fenced.host_ms, fenced.event_ms, chain_t.host_ms,
                   chain_t.event_ms, compile_s])
        timing_method = "chained"
        if mesh is not None and c_host > 2 * f_host:
            c_host, c_ev, timing_method = f_host, f_ev, "fenced"
        ms = None
        if breakdown:
            ms = breakdown_ms(w, x, max(3, min(w.iters, 10)))
    finally:
        if program is not None:
            program.clear()
    if compile_s > 120:
        print(f"WARNING: compile_s={compile_s:.0f}s exceeds the 120 s "
              "regression bar", file=sys.stderr)

    cuda = device.type == "cuda"
    rays_s = cfg.image_size / (c_host / 1e3)
    result = {
        "metric": "primary_rays_per_s_fwd_bwd",
        "value": rays_s,
        "unit": f"rays/s/chip ({cfg.screen_width}x{cfg.screen_height}, "
                f"{w.scene.num_faces} tris, {'gpu' if cuda else 'cpu'}"
                + (f", mesh={mesh.world_size}" if mesh is not None else "")
                + f", {timing_method})",
        "vs_baseline": rays_s / NOMINAL_BASELINE,
        "detail": {
            "step_ms_chained": c_host,
            "step_ms_chained_events": c_ev,
            "step_ms_fenced": f_host,
            "step_ms_fenced_events": f_ev,
            "timing_method": timing_method,
            "light_grid_mode": cfg.light_grid_mode,
            "compile_s": compile_s,
            "scene": w.scene_name,
            "trace_backend": "cuda" if cuda else "plain",
            "device": (torch.cuda.get_device_name(device) if cuda
                       else "cpu"),
        },
    }
    if parity_px is not None:
        result["detail"]["parity_shadow_px"] = parity_px
    if ms is not None:
        result["detail"].update(
            zip(ms, _slowest(mesh, list(ms.values()))))
    return result


@contextlib.contextmanager
def process_group(n: int, device: torch.device):
    """A ``dist.mesh.Mesh`` over ``n`` ranks: the default process group
    where one exists, else torchrun's (its WORLD_SIZE must be ``n``),
    else a group of one on a FileStore in a temporary directory (NCCL on
    the card, gloo on the CPU).  A group made here is destroyed on
    exit."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise SystemExit(f"error: --mesh {n} in a process group of "
                             f"{dist.get_world_size()} ranks")
        yield dmesh.make_mesh(device=device)
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise SystemExit(f"error: --mesh {n} but WORLD_SIZE is {world} "
                         "(run --mesh N under torchrun --nproc_per_node=N)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    device_id = device if device.type == "cuda" else None
    with tempfile.TemporaryDirectory() as d:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, device_id=device_id)
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(d, "store"), 1),
                rank=0, world_size=1, device_id=device_id)
        try:
            yield dmesh.make_mesh(device=device)
        finally:
            dmesh.clear()
            dist.destroy_process_group()


def build_parser():
    ap = argparse.ArgumentParser(
        description="ugrt_torch flagship benchmark (bench.py's, on one "
                    "NVIDIA GPU)")
    ap.add_argument("--scene", default=None,
                    help="OBJ file to bench instead of the procedural "
                         "cathedral")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run sharded_train_step over N ranks (torchrun)")
    ap.add_argument("--breakdown", action="store_true",
                    help="include per-stage ms in the JSON output")
    ap.add_argument("--iters", type=int, default=0,
                    help="override timed iteration count")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the kernel-vs-plain parity preflight")
    ap.add_argument("--pi-extent", action="store_true",
                    help="use the reference's pi light-grid extent "
                         "(light_grid_mode='reference') instead of the "
                         "windowed parameterization")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the shrunk "
                         "workload on the plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("error: --device cuda but CUDA is not "
                             "available (--device cpu runs the shrunk "
                             "workload on the CPU)")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    w = workload(device, scene_path=args.scene, iters=args.iters,
                 pi_extent=args.pi_extent)
    parity = None
    if device.type == "cuda" and not args.skip_parity:
        parity = parity_gate(device)
    if args.mesh:
        with process_group(args.mesh, device) as mesh:
            result = run(w, device, mesh=mesh, breakdown=args.breakdown,
                         parity_px=parity)
            rank0 = mesh.rank == 0
    else:
        result = run(w, device, breakdown=args.breakdown, parity_px=parity)
        rank0 = True
    if rank0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
