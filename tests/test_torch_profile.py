"""The profiling modules of ugrt_torch.micro (parse_trace, capture_trace,
profile_chain, render_samples) against scripts/parse_trace.py and ugrt's
functions, on the CPU at tiny_cfg's 64x64 over an 8x8 grid.

scripts/parse_trace.py is loaded without running it
(test_torch_micro._load_script) and its ``main`` reads a jax.profiler
``trace.json.gz`` written here, with a ``/device:TPU:0`` process; the
port's ``main`` reads the same events as a torch.profiler
``.pt.trace.json``.  capture_trace and profile_chain run their plain
sweeps (CPU tensors); their numbers are held to ugrt's render_and_grad,
grid builds, trace_primary and ray_light_cells on the same inputs.  A
card-only ``main`` exits non-zero without a card.  trace_psum_overlap
runs on a gloo world in tests/test_torch_dist.py.

Tolerances: parse_trace's totals, keys and counts equal and its ms to
1e-9; the loss rtol 1e-5, atol 1e-7 (__graft_entry__.py:122); grid and
ray counts exact, means rtol 1e-6; the cathedral PNG's decoded bytes
equal; the reflective Cornell box on at most 0.1% of pixels
(README.md:108-113, the knife-edge rule: jitted ugrt's reflection t
differs by up to 2e-4 relative, ROADMAP Queue 3).
"""

import dataclasses
import gzip
import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_micro import _load_script
from ugrt.api import io as io_j
from ugrt.api.renderer import Renderer as Renderer_j
from ugrt.api.renderer import render_frame_reflective as reflective_j
from ugrt.core import camera as cam
from ugrt.diff import render_grad as rg_j
from ugrt.grid import binning as binning_j
from ugrt.grid import build as build_j
from ugrt.scene import procedural as proc_j
from ugrt.trace import primary as primary_j
from ugrt_torch import bridge
from ugrt_torch.micro import (capture_trace, parse_trace, profile_chain,
                              profile_crash, render_samples,
                              trace_psum_overlap)
from ugrt_torch.scene import procedural
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# bench.py:170-179, profile_chain.py's camera and light.
SPEC = cam.CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                      up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
LIGHT = cam.CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                       up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
NAMES = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, float, float)",
    "primary_sweep_kernel(float4 const*, int, int)",
    "fusion.123",
    "loop_add_fusion.7",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "all-reduce.2",
    "copy.17.clone",
    "Memcpy HtoD (Pageable -> Device)",
]
PIXEL_BOUND = 1e-3


def _events(names, rng):
    """Complete events for ``names``, some of them twice, as (name, ts,
    dur) in microseconds."""
    out, ts = [], 1000.0
    for name in names:
        for _ in range(int(rng.integers(1, 3))):
            dur = float(rng.uniform(0.5, 900.0))
            out.append((name, ts, dur))
            ts += dur + float(rng.uniform(0.0, 40.0))
    return out


def _write_jax_trace(path, events):
    """A jax.profiler trace: the events on a /device:TPU:0 process and one
    host event that must not count."""
    ev = [{"ph": "M", "name": "process_name", "pid": 3,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 7,
           "args": {"name": "/host:CPU"}},
          {"ph": "X", "pid": 7, "tid": 1, "name": "host_op", "ts": 0.0,
           "dur": 5000.0}]
    ev += [{"ph": "X", "pid": 3, "tid": 1, "name": n, "ts": t, "dur": d}
           for n, t, d in events]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def _write_torch_trace(path, events):
    """A torch.profiler Chrome trace: the events as kernels on the card's
    track, beside host events (an op, a runtime call, the profiler step's
    device annotation) that must not count."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
           "tid": 1, "ts": 0.0, "dur": 5000.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 1, "tid": 1, "ts": 10.0, "dur": 3.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#1",
           "pid": 0, "tid": 7, "ts": 900.0, "dur": 9000.0}]
    ev += [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n,
            "ts": t, "dur": d} for n, t, d in events]
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": ev}, f)


def _rows(text):
    """(total, [(ms, count, key)]) of parse_trace's printout."""
    total = float(re.search(r"total device op time: ([0-9.]+) ms",
                            text).group(1))
    rows = [(float(m.group(1)), int(m.group(2)), m.group(3)) for m in
            re.finditer(r"^\s*([0-9.]+) ms  x(\d+)\s* (.*)$", text, re.M)]
    return total, rows


def _main_output(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["parse_trace.py", *argv])
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_group_key_is_ugrt_grouping(name, tmp_path, monkeypatch, capsys):
    """group_key(name) is the key ugrt's main prints for an event named
    ``name`` (its two substitutions, :47-48)."""
    ugrt = _load_script("parse_trace", {})
    path = tmp_path / "t.trace.json.gz"
    _write_jax_trace(str(path), [(name, 1.0, 2.0)])
    _, rows = _rows(_main_output(ugrt["main"], [str(path)], monkeypatch,
                                 capsys))
    assert [r[2] for r in rows] == [parse_trace.group_key(name)[:110]]


def test_parse_trace_main_equals_ugrt(tmp_path, monkeypatch, capsys):
    """The same device events through ugrt's main (a jax trace.json.gz,
    found under a directory) and the port's (a torch .pt.trace.json,
    found under a directory): totals, keys and counts equal, ms to 1e-9;
    host events and the profiler's device annotation do not count.  The
    port's span and busy share are those of the events."""
    rng = np.random.default_rng(0)
    events = _events(NAMES, rng)
    (tmp_path / "jax" / "plugins").mkdir(parents=True)
    (tmp_path / "torch").mkdir()
    _write_jax_trace(str(tmp_path / "jax" / "plugins" / "h.trace.json.gz"),
                     events)
    _write_torch_trace(str(tmp_path / "torch" / "step.pt.trace.json"), events)
    ugrt = _load_script("parse_trace", {})
    want = _rows(_main_output(ugrt["main"], [str(tmp_path / "jax"), "5"],
                              monkeypatch, capsys))
    text = _main_output(lambda: parse_trace.main(), [
        str(tmp_path / "torch"), "5"], monkeypatch, capsys)
    got = _rows(text)
    assert got[0] == pytest.approx(want[0], abs=1e-9)
    assert len(got[1]) == len(want[1]) == 5
    for g, w in zip(got[1], want[1]):
        assert g[1:] == w[1:] and g[0] == pytest.approx(w[0], abs=1e-9)

    s = parse_trace.aggregate(parse_trace.device_events(parse_trace.load(
        str(tmp_path / "torch"))))
    total = sum(d for _, _, d in events) / 1e3
    span = (events[-1][1] + events[-1][2] - events[0][1]) / 1e3
    assert s.total_ms == pytest.approx(total, rel=1e-12)
    assert s.span_ms == pytest.approx(span, rel=1e-12)
    assert s.busy == pytest.approx(total / span, rel=1e-12)
    assert len(s.rows) == len({parse_trace.group_key(n) for n in NAMES})
    assert f"busy {100 * s.busy:.1f}%" in text


def _tiny(tiny_cfg, mode, **kw):
    """(ugrt's config, the port's) at tiny_cfg in light-grid ``mode``."""
    cfg = dataclasses.replace(tiny_cfg, light_grid_mode=mode, **kw)
    return cfg, bridge.render_config(cfg)


def test_capture_trace_cpu(tiny_cfg, tmp_path):
    """On the CPU: the trace lands in --out's directory and parse_trace
    reads it; the warm-up loss is ugrt's render_and_grad's on the same
    inputs (bench's camera and light, a zero target)."""
    cfg_j, cfg = _tiny(tiny_cfg, "windowed")
    sc = proc_j.cathedral(num_faces_target=2000)
    out = capture_trace.run(cfg, procedural.cathedral(num_faces_target=2000),
                            "cpu", str(tmp_path / "trace"))
    assert out["trace"].startswith(str(tmp_path / "trace"))
    trace = parse_trace.load(str(tmp_path / "trace"))
    assert trace["traceEvents"]
    assert parse_trace.device_events(trace) == []

    cc = jnp.asarray(cam.camcoords_from_spec(SPEC, cfg.fovy_deg, 1.0))
    lcc = jnp.asarray(cam.camcoords_from_spec(LIGHT, cfg.fovy_deg, 1.0))
    want = rg_j.render_and_grad(
        jnp.asarray(sc.vertices), jnp.asarray(sc.materials),
        jnp.asarray(sc.faces), jnp.asarray(sc.mat_index), cc, lcc[None],
        jnp.asarray(np.asarray(LIGHT.eye, np.float32)),
        jnp.zeros((64, 64, 3), jnp.float32), cfg=cfg_j,
        capacity=cfg_j.pair_capacity(sc.num_faces), num_lights=1,
        use_spot=True)
    np.testing.assert_allclose(out["loss"], float(want["loss"]), rtol=1e-5,
                               atol=1e-7)
    assert out["traced_loss"] == out["loss"]


def test_profile_chain_cpu(tiny_cfg, capsys):
    """Every line item in order, ms >= 0; the statistics equal those of
    ugrt's grid builds and of ray_light_cells over ugrt's trace_primary
    hit points.  A heavy threshold of 8 cells gives both grids heavy
    faces at this size."""
    cfg_j, cfg = _tiny(tiny_cfg, "reference", heavy_threshold=8)
    sc = proc_j.cathedral(num_faces_target=2000)
    rows, stats = profile_chain.run(cfg, bridge.scene(sc), "cpu", n=1)
    assert [r[0] for r in rows] == list(profile_chain.LINE_ITEMS)
    assert all(h >= 0 and e is None for _, h, e in rows)
    assert sorted(stats) == sorted(profile_chain.STATS)
    assert "windows (window_span ranges" in capsys.readouterr().out

    v, f = jnp.asarray(sc.vertices), jnp.asarray(sc.faces)
    cc = jnp.asarray(cam.camcoords_from_spec(SPEC, cfg.fovy_deg, 1.0))
    lcc = jnp.asarray(cam.camcoords_from_spec(LIGHT, cfg.fovy_deg, 1.0))
    cap = cfg_j.pair_capacity(sc.num_faces)
    grid = build_j.build_perspective_grid(v, f, cc, cfg=cfg_j, capacity=cap)
    lgrid = build_j.build_spherical_grid(v, f, lcc, cfg=cfg_j, capacity=cap)
    prim = primary_j.trace_primary(v, f, cc, grid, cfg_j)
    n = cfg.image_size
    pts = cc[0:3][None] + prim["t"].reshape(n)[:, None] * prim[
        "ray_dir"].reshape(n, 3)
    cells = np.asarray(binning_j.ray_light_cells(
        pts, lcc, cfg.grid_x, cfg.grid_y, cfg.angular_extent,
        cfg.angular_extent, cfg.quirks.y_forward_dot_typo, xp=jnp))
    live = cells < cfg.cell_sentinel
    _, per_cell = np.unique(cells[live], return_counts=True)
    lc = np.asarray(lgrid.cell_count)
    want = dict(
        faces=sc.num_faces, capacity=cap,
        persp_pairs=int(grid.total_pairs), persp_heavy=int(grid.heavy_count),
        sph_pairs=int(lgrid.total_pairs), sph_heavy=int(lgrid.heavy_count),
        rays=n, rays_in_grid=int(live.sum()),
        distinct_cells=int(per_cell.size),
        max_rays_per_cell=int(per_cell.max()),
        p99_rays_per_cell=float(np.percentile(per_cell, 99)),
        light_cells_occupied=int((lc > 0).sum()),
        max_tris_per_cell=int(lc.max()))
    assert want["persp_heavy"] > 0 and want["sph_heavy"] > 0
    assert {k: stats[k] for k in want} == want
    np.testing.assert_allclose(stats["mean_tris_per_occupied_cell"],
                               lc[lc > 0].mean(), rtol=1e-6)
    nb = cfg.grid_x * cfg.grid_y // 2
    assert stats["primary_blocks"] == stats["shadow_blocks"] == nb
    assert stats["primary_windows"] >= 0 and stats["shadow_windows"] > 0


def test_render_samples_cpu(tiny_cfg, tmp_path):
    """At 64x64 (the cathedral and the Cornell box each over an 8x8
    grid): the cathedral PNG decodes to the bytes of ugrt's Renderer
    image as ugrt's io.write_png writes it; the reflective Cornell box
    differs from ugrt's on at most 0.1% of pixels."""
    cfg_j, cfg = _tiny(tiny_cfg, "reference")
    sc, box = (proc_j.cathedral(num_faces_target=2000),
               proc_j.cornell_box(subdiv=4))
    out = render_samples.run(cfg, bridge.scene(sc), "cpu", str(tmp_path),
                             cornell_cfg=cfg)
    assert out["shadowed_px"] >= 0

    r = Renderer_j(sc, cfg_j)
    r.frame_cnt = 5
    img = r.render(SPEC, [LIGHT], (10.0, 12.0, 6.0), use_spot=True)["image"]
    io_j.write_png(str(tmp_path / "ugrt.png"), np.asarray(img), flip=True)
    got = render_samples.read_png(out["cathedral"])
    assert got.shape == (64, 64, 3)
    assert got.tobytes() == render_samples.read_png(
        str(tmp_path / "ugrt.png")).tobytes()

    rs = render_samples
    cc = jnp.asarray(cam.camcoords_from_spec(rs.CORNELL_CAMERA,
                                             cfg.fovy_deg, 1.0))
    lcc = jnp.asarray(cam.camcoords_from_spec(rs.CORNELL_LIGHT,
                                              cfg.fovy_deg, 1.0))[None]
    want = reflective_j(
        jnp.asarray(box.vertices), jnp.asarray(box.faces),
        jnp.asarray(box.mat_index), jnp.asarray(box.materials), cc, lcc,
        jnp.asarray(np.asarray(rs.CORNELL_LIGHT.eye, np.float32)),
        cfg=cfg_j, capacity=cfg_j.pair_capacity(box.num_faces),
        num_lights=1, use_spot=True, uniform_dims=rs.UDIMS,
        uniform_capacity=rs.UCAP, reflectivity=rs.REFLECTIVITY)
    want = np.asarray(want["image"])[::-1]
    got = render_samples.read_png(out["cornell"])
    assert got.shape == want.shape
    diff = int((got != want).any(axis=-1).sum())
    assert diff <= PIXEL_BOUND * got.shape[0] * got.shape[1]


@pytest.mark.parametrize("module", [profile_chain, capture_trace,
                                    render_samples, trace_psum_overlap,
                                    profile_crash])
def test_main_refuses_to_run_without_a_card(monkeypatch, module, tmp_path):
    """A card-only main exits non-zero with the "CUDA is not available"
    message and writes nothing; nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ([] if module in (profile_chain, profile_crash)
            else ["--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit) as e:
        module.main(argv)
    assert e.value.code not in (0, None)
    assert "CUDA is not available" in str(e.value.code)
    assert not (tmp_path / "o").exists()


def test_profile_crash_names_exist_in_chip_smoke():
    """profile_crash patches chip_smoke.py's phase functions and reads its
    G1 kernel names by name: every one of them exists there (and the two
    sums of core.gather that --plain-sums replaces), so that a renamed
    phase is refused instead of being added as a new attribute."""
    import importlib.util

    from ugrt_torch.core import gather

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_names", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert profile_crash.missing_names(cs, gather) == []
    assert set(cs.G1_KERNELS) == {"face_corner_sum", "segment_sum"}
    assert "profiling_phase" in profile_crash.missing_names(object(), gather)
