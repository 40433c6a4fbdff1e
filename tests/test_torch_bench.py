"""ugrt_torch.bench (the port's bench.py) and micro.bench_reflective.

On the CPU: the bench's workload against bench.py's (ugrt's config,
procedural cathedral and camera vectors, computed directly: bench.py's
main is not run), the JSON line's keys against bench.py's source (read
with ast), a chained run against an unchained one, the parity gate (its
default 256x256 frame, and with one plain sweep patched), the overflow
guard, the exit without a card, the sharded step on a gloo group of one
rank, and bench_reflective at a small size.  Small frames are tiny_cfg's
64x64 over an 8x8 grid.  Tolerance: none (arrays and outputs bitwise,
keys equal).
"""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.scene import procedural as proc_j
from ugrt_torch import bench
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.kernels import _build
from ugrt_torch.micro import _timing
from ugrt_torch.micro import bench_reflective
from ugrt_torch.scene import procedural
from ugrt_torch.trace import primary as tprim_t
from ugrt_torch.trace import shadow as tshadow_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py:170-179.
SPEC = cam.CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                      up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = cam.CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0), near=0.1, far=100.0)


def _tiny(tiny_cfg, iters=2, mode="windowed"):
    """The bench workload at tiny_cfg's 64x64 over a small cathedral
    (7,076 faces)."""
    cfg = dataclasses.replace(bridge.render_config(tiny_cfg),
                              light_grid_mode=mode)
    scene = procedural.cathedral(num_faces_target=2000)
    return bench.Workload(cfg, scene, "procedural-cathedral", iters,
                          cfg.pair_capacity(scene.num_faces))


def _bench_py_keys():
    """(top-level keys, detail keys, breakdown keys, metric) of bench.py's
    result line, read from its source."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    top = detail = breakdown = metric = None
    extra = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result"
                        for t in node.targets)):
            top = [k.value for k in node.value.keys]
            values = dict(zip(top, node.value.values))
            detail = [k.value for k in values["detail"].keys]
            metric = values["metric"].value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update" and node.args
              and isinstance(node.args[0], ast.Dict)):
            breakdown = [k.value for k in node.args[0].keys]
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant)):
            extra.add(node.slice.value)
    return top, detail + sorted(extra), breakdown, metric


@pytest.mark.parametrize("pi_extent", [False, True])
@pytest.mark.parametrize("settings", ["card", "cpu"])
def test_workload_equals_bench_py(settings, pi_extent):
    """Config fields, scene arrays, camera and light vectors, capacity
    and iterations are bench.py's (:140-190), bitwise."""
    w = bench.workload("cuda" if settings == "card" else "cpu",
                       pi_extent=pi_extent)
    if settings == "card":
        cfg, target, iters = RenderConfig(), 75000, 20
    else:
        cfg = dataclasses.replace(RenderConfig(), screen_width=256,
                                  screen_height=256, grid_x=32, grid_y=32)
        target, iters = 8000, 2
    if not pi_extent:
        cfg = dataclasses.replace(cfg, light_grid_mode="windowed")
    assert dataclasses.asdict(w.cfg) == dataclasses.asdict(cfg)
    sc = proc_j.cathedral(num_faces_target=target)
    for k in ("vertices", "faces", "materials", "mat_index"):
        a, b = getattr(w.scene, k), getattr(sc, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert (w.scene_name, w.iters, w.capacity) == (
        "procedural-cathedral", iters, cfg.pair_capacity(sc.num_faces))
    assert bench.workload("cpu", iters=7).iters == 7

    x = bench.step_inputs(w, "cpu")
    aspect = cfg.screen_width / cfg.screen_height
    want = {"camcoords": cam.camcoords_from_spec(SPEC, cfg.fovy_deg, aspect),
            "light_camcoords": cam.camcoords_from_spec(
                LIGHT, cfg.fovy_deg, aspect)[None],
            "light_position": np.asarray(LIGHT.eye, dtype=np.float32),
            "target": np.zeros((cfg.screen_height, cfg.screen_width, 3),
                               np.float32)}
    for k, v in want.items():
        got = x[k].numpy()
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("breakdown", [False, True])
def test_json_keys_equal_bench_py(tiny_cfg, breakdown):
    """The line's keys are bench.py's; detail adds only ``device`` and an
    ``*_events`` twin of each ms; the metric's name is bench.py's."""
    top, detail, stages, metric = _bench_py_keys()
    assert "parity_shadow_px" in detail and "grid_ms" in stages
    r = bench.run(_tiny(tiny_cfg), "cpu", breakdown=breakdown, parity_px=0)
    line = json.loads(json.dumps(r))
    assert list(line) == top and line["metric"] == metric
    ms = [k for k in detail + stages if k.endswith("_ms")
          or k.startswith("step_ms")]
    want = set(detail) | (set(stages) if breakdown else set())
    added = {"device"} | {k + "_events" for k in ms if k in want}
    assert set(line["detail"]) == want | added
    assert line["detail"]["device"] == "cpu"
    assert line["detail"]["trace_backend"] == "plain"
    assert all(line["detail"][k] is None for k in added - {"device"})
    assert line["value"] > 0 and "cpu" in line["unit"]
    assert line["vs_baseline"] == line["value"] / 1e8


def test_chained_step_equals_unchained(tiny_cfg):
    """verts + grad_vertices * 0 changes no bit: the chained run's loss
    and gradients are an unchained step's."""
    w = _tiny(tiny_cfg)
    x = bench.step_inputs(w, "cpu")
    step, program = bench.make_step(w, x)
    assert program is None
    want = step(x["vertices"], x["materials"])
    timing, got = _timing.chain_ms(step, x["vertices"], x["materials"],
                                   n=3, dep=bench.chain)
    assert timing.event_ms is None and timing.host_ms > 0
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and torch.equal(g, v)
    assert float(want[0]) > 0 and bool(want[3]) is False


def test_timing_chain_and_fence():
    """chain_ms: a warm-up and n dependent calls whose inputs keep their
    values; fenced_ms: a warm-up and n calls; no events on the CPU."""
    seen = []

    def fn(v):
        seen.append(v.clone())
        return {"first": v * 2, "second": v}

    v = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    timing, out = _timing.chain_ms(fn, v, n=4)
    assert len(seen) == 5 and all(torch.equal(s, v) for s in seen)
    assert torch.equal(out["first"], v * 2) and timing.event_ms is None
    timing, _ = _timing.fenced_ms(fn, v, n=3)
    assert len(seen) == 9 and timing.host_ms > 0


def _hit_pixels(cfg, scene):
    """Pixels with a face in the gate's frame (plain trace)."""
    x = bridge.scene_to_torch(scene, "cpu")
    cc = bridge.camcoords_to_torch(bench.CAMERA, cfg.fovy_deg, 1.0, "cpu")
    grid = tbuild.build_perspective_grid(
        x["vertices"], x["faces"], cc, cfg=cfg,
        capacity=cfg.pair_capacity(scene.num_faces))
    r = tprim_t.trace_primary(x["vertices"], x["faces"], cc, grid, cfg)
    return int((r["face_id"] >= 0).sum())


def _cpu_kernel_backend(monkeypatch, plain=None):
    """Let backend="kernel" take CPU tensors: the traces then call the
    kernel wrappers, which run their own plain versions on the CPU.
    ``plain``: (wrapper, function) that backend "plain" takes in place
    of that wrapper's plain version."""
    def choose(k, b, d):
        if plain is not None and b == "plain" and k is plain[0]:
            return plain[1]
        return _build.choose_sweep(k, None if b == "kernel" else b, d)

    for mod in (tprim_t, tshadow_t):
        monkeypatch.setattr(mod, "choose_sweep", choose)


@pytest.mark.parametrize("patch", [None, "primary", "shadow"])
def test_parity_gate(monkeypatch, patch):
    """bench.py's gate on its own 256x256 frame of an 8,000-target
    cathedral, with backend="kernel" let onto the CPU (the wrappers'
    CPU path, so both sides are plain there).  Unpatched: backend
    "kernel" on CPU tensors raises, and with it let through the gate's
    plumbing returns 0.  A plain K1 that flips every hit's face id
    raises with the count of pixels whose face differs (all hit pixels:
    the heavy split is off, so K1 decides every face); a plain K3 that
    flips every flag raises past the 16-pixel bound."""
    if patch is None:
        with pytest.raises(ValueError, match="CUDA tensors"):
            bench.parity_gate("cpu")
        _cpu_kernel_backend(monkeypatch)
        assert bench.parity_gate("cpu") == 0
        return
    if patch == "primary":
        cfg = dataclasses.replace(bench.small_config(), heavy_threshold=0)
        scene = procedural.cathedral(num_faces_target=8000)
        plain = tprim_t.primary_sweep.plain

        def flipped(*args, **kwargs):
            t, f = plain(*args, **kwargs)
            return t, torch.where(f != 2**31 - 1, f ^ 1, f)

        _cpu_kernel_backend(monkeypatch, (tprim_t.primary_sweep, flipped))
        n = _hit_pixels(cfg, scene)
        assert n > 1000
        with pytest.raises(RuntimeError, match=re.escape(
                f"parity gate: primary face ids diverge on chip ({n} px)")):
            bench.parity_gate("cpu", cfg=cfg, scene=scene)
        return
    plain = tshadow_t.shadow_sweep.plain
    _cpu_kernel_backend(monkeypatch, (tshadow_t.shadow_sweep,
                                      lambda *a, **k: plain(*a, **k) ^ 1))
    with pytest.raises(RuntimeError,
                       match=r"shadow masks diverge on chip \((\d+) px"):
        bench.parity_gate("cpu")


def test_overflow_guard(tiny_cfg):
    """A pair capacity too small for the scene: the warm-up's overflow
    flag stops the bench with bench.py's message."""
    w = _tiny(tiny_cfg)._replace(capacity=256)
    with pytest.raises(RuntimeError, match="static capacity overflow"):
        bench.run(w, "cpu")


@pytest.mark.parametrize("module", ["ugrt_torch.bench",
                                    "ugrt_torch.micro.bench_reflective"])
def test_no_card_exits_nonzero(module, tmp_path):
    """No card (the bench's default --device cuda; bench_reflective runs
    on the card only): a non-zero exit and no result line; nothing runs
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--iters", "1"] if module.endswith(
            "bench") else [sys.executable, "-m", module, "--out",
                           str(tmp_path / "r.png")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "{" not in proc.stdout and not (tmp_path / "r.png").exists()


def test_mesh_one_gloo(tiny_cfg, tmp_path):
    """--mesh 1 on a gloo group of one rank (FileStore under tmp_path):
    the bench's group helper takes the existing group and leaves it, and
    the sharded step's line names mesh=1."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with bench.process_group(1, torch.device("cpu")) as mesh:
            assert (mesh.rank, mesh.world_size) == (0, 1)
            r = bench.run(_tiny(tiny_cfg, iters=1), "cpu", mesh=mesh)
        assert dist.is_initialized()
        with pytest.raises(SystemExit, match="--mesh 2"):
            with bench.process_group(2, torch.device("cpu")):
                pass
    finally:
        dist.destroy_process_group()
    assert "mesh=1" in r["unit"] and r["value"] > 0
    assert r["detail"]["timing_method"] in ("chained", "fenced")


def test_bench_reflective_small(tiny_cfg, tmp_path, capsys):
    """bench_reflective at 64x64 over the small cathedral (an 8^3 uniform
    grid): both frames timed, no overflow, the reflection hit fraction
    printed, the PNG written."""
    w = _tiny(tiny_cfg)
    out = tmp_path / "reflective.png"
    r = bench_reflective.run(w.cfg, w.scene, "cpu", out_path=str(out),
                             iters=1, uniform_dims=(8, 8, 8))
    printed = capsys.readouterr().out
    assert r["overflow"] is False
    assert f"refl hit frac: {r['reflection_hit_fraction']}" in printed
    assert 0 < r["reflection_hit_fraction"] <= 1
    assert r["base_ms"] > 0 and r["reflective_ms"] > 0
    assert r["bounce_ms"] == r["reflective_ms"] - r["base_ms"]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
