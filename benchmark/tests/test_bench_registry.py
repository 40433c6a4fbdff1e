"""The benchmark's own tests, on the CPU (the ``cuda`` ones run on the
card): the registry, the traffic generator, the frozen copies, the
reference against the program's plain path, the result line, the check
against the control and the planted faults, the launcher on a gloo
world, and the entry's refusals.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import (check, drivers, faults, frame_call, harness, registry,
                       scene, traffic)
from benchmark.tests import tiny

ROOT = registry.ROOT
SPEC = registry.load(ROOT).spec
CELLS = [w["name"] for w in SPEC["workloads"]]
ONE_CARD = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]


def cathedral(faces, seed):
    return scene.generate(dict(generator="cathedral",
                               num_faces_target=faces), seed)


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return registry.load(tiny.tiny_root(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(autouse=True)
def short_rate_call(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_tiny(bench, name, seed=7, seconds=0.2):
    return harness.run_cell(bench.cell(name), name, seed, seconds, False,
                            "cpu", 0.0)


# --- the registry ---------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_registry_finds_every_file(name):
    cell = registry.load(ROOT).cell(name)
    assert cell.traffic["kind"] in drivers.DRIVERS
    assert os.path.exists(registry.traffic_path(ROOT, [
        w for w in SPEC["workloads"] if w["name"] == name][0]["traffic"]))
    for m in cell.per_layer:
        assert callable(registry.metric_reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert set(cell.config["limits"][cell.traffic["kind"]])


def test_every_metric_has_a_reader_and_every_config_a_file():
    for m in SPEC["per_layer"]:
        assert os.path.exists(registry.metric_path(m["name"]))
    for c in SPEC["configs"]:
        cfg = registry.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    with pytest.raises(KeyError):
        registry.load(ROOT).cell("no-such-cell")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["moves"] for m in SPEC["per_layer"]}
    assert layers <= {m["name"] for m in SPEC["end_to_end"]}


# --- the traffic ------------------------------------------------------------

def test_cathedral_copy_equals_the_program_generator_at_seed_0():
    from ugrt_torch.scene import procedural
    ours, theirs = cathedral(75000, 0), procedural.cathedral(75000, 0)
    for name in ("vertices", "faces", "mat_index", "materials"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name))
    assert ours.faces.shape == (73824, 3)
    assert sum(c.count for c in ours.columns) == 12 * 8 * 49


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_traffic_is_deterministic_and_in_range(seed):
    cfg = registry.load_json(os.path.join(ROOT, SPEC["configs"][0]["file"]))
    cfg["render"].update(tiny.SIZE)
    cfg["scene"]["num_faces_target"] = tiny.FACES
    for name in ("train", "dynamic-frames"):
        t = registry.load_json(registry.traffic_path(ROOT, name))
        a = traffic.generate(t, cfg, seed, "cpu")
        b = traffic.generate(t, cfg, seed, "cpu")
        assert a.views == b.views and len(a.views) == t["views"]
        for v in a.views:
            assert np.linalg.norm(np.subtract(v.eye, t["eye_center"])) \
                <= t["eye_radius"]
            assert np.linalg.norm(np.subtract(v.look_at, t["look_center"])) \
                <= t["look_radius"]
        for x, y in zip(a.targets, b.targets):
            assert torch.equal(x, y) and x.shape == (64, 64, 3)
            assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
            assert float(x.max()) > 0.0
        for x, y in zip(a.vertex_frames, b.vertex_frames):
            assert np.array_equal(x, y)
        if t["kind"] == "frames":
            assert len(a.vertex_frames) == t["vertex_frames"]
            base = a.scene.vertices
            walls = slice(0, a.scene.columns[0].start)
            assert np.array_equal(a.vertex_frames[0][walls], base[walls])
            assert np.array_equal(a.vertex_frames[0][:, 2], base[:, 2])
    other = traffic.views(t, seed + 1, 4)
    assert other != traffic.views(t, seed, 4)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_target_scene_is_a_small_seeded_perturbation(seed):
    """The targets' scene: every vertex within ``target_vertex_offset``
    per axis, the walls' faces unchanged, materials scaled within
    ``target_material_scale`` (or clipped); another seed, another
    scene."""
    t = registry.load_json(registry.traffic_path(ROOT, "train"))
    sc = cathedral(tiny.FACES, seed)
    v, m = traffic.target_scene(t, seed, sc)
    v2, _ = traffic.target_scene(t, seed, sc)
    assert np.array_equal(v, v2) and v.dtype == np.float32
    gap = np.abs(v.astype(np.float64) - sc.vertices)
    assert gap.max() <= t["target_vertex_offset"] + 1e-6
    assert gap.max() > 0.1 * t["target_vertex_offset"]
    lo, hi = t["target_material_scale"]
    ratio = m / sc.materials
    assert ((ratio >= lo - 1e-6) & (ratio <= hi + 1e-6) | (m == 1.0)).all()
    assert not np.array_equal(v, traffic.target_scene(t, seed + 1, sc)[0])


def test_seed_moves_only_column_radii():
    a, b = cathedral(75000, 1), cathedral(75000, 2)
    assert a.faces.shape == b.faces.shape
    assert np.array_equal(a.faces, b.faces)
    walls = slice(0, a.columns[0].start)
    assert np.array_equal(a.vertices[walls], b.vertices[walls])
    assert not np.array_equal(a.vertices, b.vertices)


# --- the reference ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["reference", "windowed"])
def test_reference_equals_the_program_plain_path(mode):
    """The frozen reference and the program's eager frame, reflective
    frame and step, both on the CPU (the program's plain versions), give
    the same bits at a tiny size."""
    import dataclasses

    from benchmark.reference import config as rcfg
    from benchmark.reference import frame as rframe
    from ugrt_torch import bridge
    from ugrt_torch import config as pcfg
    from ugrt_torch.api import renderer
    from ugrt_torch.core.host_camera import CameraSpec
    from ugrt_torch.diff import render_grad
    sc = cathedral(2000, 3)
    kw = dict(tiny.SIZE, light_grid_mode=mode)
    pc = dataclasses.replace(pcfg.RenderConfig(), **kw)
    rc = dataclasses.replace(rcfg.RenderConfig(), **kw)
    view = traffic.View((3.0, 15.0, 5.0), (13.0, 13.0, 3.0), (0.0, 0.0, 1.0),
                        0.1, 100.0)
    light = traffic.View((14.0, 13.0, 8.0), (14.0, 13.0, 0.0),
                         (0.0, 1.0, 0.0), 0.1, 100.0)
    fc = frame_call.FrameCall(False, (light,), (10.0, 12.0, 6.0), 1.0, 1.0,
                              {})
    cc = fc.camcoords(view, rc.fovy_deg, "cpu")
    lcc = fc.light_camcoords(rc.fovy_deg, "cpu")
    assert torch.equal(cc, bridge.camcoords_to_torch(
        CameraSpec(*view), 45.0, 1.0, "cpu"))
    v, f, mi, m = (torch.from_numpy(getattr(sc, n)) for n in
                   ("vertices", "faces", "mat_index", "materials"))
    lp = torch.tensor([10.0, 12.0, 6.0])
    cap = pc.pair_capacity(f.shape[0])
    args = (v, f, mi, m, cc, lcc, lp)
    common = dict(capacity=cap, num_lights=1, use_spot=True)
    a = renderer.render_frame(*args, cfg=pc, **common)
    b = rframe.render_frame(*args, cfg=rc, **common)
    for n in ("image", "color", "shadowed"):
        assert torch.equal(a[n], b[n])
    assert torch.equal(a["primary"]["face_id"], b["primary"]["face_id"])
    refl = dict(uniform_dims=(8, 8, 8), uniform_capacity=1 << 16,
                reflectivity=0.3, max_batches=8)
    a = renderer.render_frame_reflective.fn(*args, cfg=pc, **common, **refl)
    b = rframe.render_frame_reflective(*args, cfg=rc, **common, **refl)
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["reflection"]["face_id"],
                       b["reflection"]["face_id"])
    target = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(1))
    o = render_grad.render_and_grad.fn(v, m, f, mi, cc, lcc, lp, target,
                                       cfg=pc, capacity=cap, num_lights=1,
                                       use_spot=True)
    loss, gv, gm, _ = rframe.train_step(v, m, f, mi, cc, lcc, lp, target,
                                        cfg=rc, capacity=cap)
    assert torch.equal(o["loss"], loss)
    assert torch.equal(o["grad_vertices"], gv)
    assert torch.equal(o["grad_materials"], gm)


@pytest.mark.parametrize("name", ONE_CARD)
def test_roofline_sites_and_counts(tiny_bench, name):
    """The reference's first frame or step records each kernel's call
    site of the cell, and the work counted from it is positive."""
    from benchmark import roofline
    from benchmark.reference.sweeps import uniform_dda_plain
    d = drivers.make(tiny_bench.cell(name), 5, "cpu")
    sites = roofline.record(d)
    kind = d.cell.traffic["kind"]
    assert len(sites["heavy_primary_sweep"]) == 1
    key = [c for c in sites["shadow_sweep"] if not c[1].get("box")]
    (tri, rays, _, _), kw, out = key[0]
    assert kw.get("serial") == (d.cfg.light_grid_mode != "windowed")
    need = roofline.keyed_tests(tri, 10, rays, 4, only=out == 0)
    assert need + int((out != 0).sum()) > 0
    assert bool(sites["face_corner_sum"]) == (kind == "train")
    assert bool(sites["uniform_dda"]) == getattr(d, "reflective", False)
    if sites["uniform_dda"]:
        args, kw, _ = sites["uniform_dda"][0]
        stats = {}
        uniform_dda_plain(*args, **kw, stats=stats)
        assert stats["needed"] > 0
    if sites["face_corner_sum"]:
        (values, fid, faces, rows), _, _ = sites["face_corner_sum"][0]
        assert values.shape == (64 * 64, 9) and fid.dtype == torch.int32
        assert 0 < roofline.nbytes(*roofline.read_once(values, fid, faces))
    b_ms, by = roofline.bound(3e9, 0)
    assert by == "operations" and b_ms == pytest.approx(3e9 / 67e12 * 1e3)


@pytest.mark.parametrize("name", ONE_CARD)
def test_every_stage_reader_runs(tiny_bench, name, monkeypatch):
    """Each per-layer reader of the cell that reads stage times calls its
    stages' programs without error (the CPU has no events, so a stage
    reads 1 ms here; the rooflines' sites are tested above)."""
    cell = tiny_bench.cell(name)
    d = drivers.make(cell, 5, "cpu")
    d.setup(0.1)
    w = d.window(0.1)
    monkeypatch.setattr(harness.Layers, "stage_ms",
                        lambda self, n: self.stages.ms(n) or 1.0)
    ctx = harness.Layers(d, w, harness.end_to_end(cell, w))
    for m in cell.per_layer:
        if not m["name"].endswith("_roofline"):
            assert isinstance(registry.metric_reader(m["name"])(ctx), float)


# --- a run at a tiny size: the result line, the check, the faults -----------

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "compared"]


@pytest.mark.parametrize("name", ONE_CARD)
def test_tiny_run_is_correct_and_its_line_has_the_keys(tiny_bench, name):
    result, lines = run_tiny(tiny_bench, name)
    assert list(result) == RESULT_KEYS
    assert result["correct"] is True, result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = tiny_bench.cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [ln.split(":")[0] for ln in lines] == [
        f"compared {n}" for n in result["compared"]]
    json.dumps(result)


@pytest.mark.parametrize("name", ONE_CARD)
def test_control_fails(tiny_bench, name):
    """The reference in bfloat16 in the program's place: not correct."""
    cell = tiny_bench.cell(name)
    d = drivers.make(cell, 11, "cpu")
    d.setup(0.1)
    d.window(0.1)
    numbers = d.check(lowp=torch.bfloat16)
    assert not check.verdict(numbers, cell.config["limits"][
        cell.traffic["kind"]]), numbers


FAULT_CASES = [(n, f) for n in ONE_CARD
               for f in faults.FAULTS[registry.load(ROOT).cell(n)
                                      .traffic["kind"]]]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(tiny_bench, name, fault):
    cell = tiny_bench.cell(name)
    with faults.plant(cell.traffic["kind"], fault):
        result, _ = run_tiny(tiny_bench, name, seed=13)
    assert result["correct"] is False, result["compared"]


def test_overflow_counts_as_failed(tiny_bench, monkeypatch):
    """A frame that sets the overflow flag fails, and the run is not
    correct."""
    from ugrt_torch.api import renderer

    def make(program):
        def flagged(*args, **kw):
            out = program(*args, **kw)
            return dict(out, overflow=torch.ones((), dtype=torch.bool))
        flagged.clear = program.clear
        flagged.capture_seconds = program.capture_seconds
        flagged.__name__ = program.__name__
        return flagged
    with faults.patched(renderer, "render_frame_device", make):
        result, _ = run_tiny(tiny_bench, "sibenik75k.dynamic-frames")
    assert result["failed"] == result["attempted"] > 0
    assert result["correct"] is False


# --- a new cell is new files and entries -------------------------------------

def _add_cell(root, config_name, traffic_name, edit_config, edit_traffic,
              base_cell):
    """Writes a configuration and a traffic file edited from those of
    ``base_cell`` under ``root`` and adds their entries and a cell to its
    BENCHMARK.json, as a later change would; returns the cell's name."""
    spec = registry.load(root).spec
    w = [x for x in spec["workloads"] if x["name"] == base_cell][0]
    c = [x for x in spec["configs"] if x["name"] == w["config"]][0]
    cfg = registry.load_json(os.path.join(root, c["file"]))
    cfg["name"] = config_name
    edit_config(cfg)
    t = registry.load_json(registry.traffic_path(root, w["traffic"]))
    edit_traffic(t)
    cfile = os.path.join("benchmark", "configs", config_name + ".json")
    with open(os.path.join(root, cfile), "w") as f:
        json.dump(cfg, f)
    with open(registry.traffic_path(root, traffic_name), "w") as f:
        json.dump(t, f)
    name = f"{config_name}.{traffic_name}"
    spec["configs"].append(dict(c, name=config_name, file=cfile))
    spec["workloads"].append(dict(w, name=name, config=config_name,
                                  traffic=traffic_name))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base_cell in m.get("workloads", [name]):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return name


def _second_light(cfg):
    light = dict(cfg["lights"][0], eye=[20.0, 8.0, 8.0],
                 look_at=[20.0, 8.0, 0.0])
    cfg["lights"] = cfg["lights"] + [light]


NEW_CELLS = {
    "two-lights": ("sibenik75k.dynamic-frames", _second_light,
                   lambda t: None),
    "two-lights-reflect": ("sibenik75k-reflect.dynamic-frames",
                           _second_light, lambda t: None),
    "checkpoints": ("sibenik75k.train", lambda c: None,
                    lambda t: t.update(checkpoint_every=2)),
}


@pytest.mark.parametrize("case", sorted(NEW_CELLS))
def test_a_new_cell_needs_no_edit(tmp_path, monkeypatch, case):
    """Multi-light frames (plain and reflective) and a training job that
    saves checkpoints are a configuration or traffic file and entries
    only; each runs correct at the tiny size, and the checkpoints go
    into the run's TMPDIR and are removed."""
    base, edit_config, edit_traffic = NEW_CELLS[case]
    root = tiny.tiny_root(tmp_path / "root")
    name = _add_cell(root, "cfg-" + case, "traffic-" + case, edit_config,
                     edit_traffic, base)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setenv("TMPDIR", str(scratch))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    saved = []
    if case == "checkpoints":
        from ugrt_torch.api import checkpoint as ckpt
        real = ckpt.save_checkpoint

        def save(folder, state, step):
            saved.append((folder, step))
            return real(folder, state, step)
        monkeypatch.setattr(ckpt, "save_checkpoint", save)
    result, _ = run_tiny(registry.load(root), name)
    assert result["correct"] is True, result["compared"]
    if case == "checkpoints":
        assert saved and all(f.startswith(str(scratch)) for f, _ in saved)
        assert not [n for n in os.listdir(scratch)
                    if n.startswith("bench-ckpt-")]


def test_scene_generators_are_found_by_name(tmp_path, monkeypatch):
    """A configuration's ``scene.generator`` is ``scenes/<name>.py``: the
    committed one, and a new file that a later change would add."""
    assert registry.scene_builder("cathedral") is not None
    path = tmp_path / "tiny_box.py"
    path.write_text(
        "from benchmark.scenes import cathedral\n"
        "def build(params, seed):\n"
        "    return cathedral.cathedral(params['faces'], seed)\n")
    monkeypatch.setattr(registry, "scene_path", lambda g: str(
        tmp_path / f"{g}.py"))
    sc = scene.generate(dict(generator="tiny_box", faces=1000), 4)
    assert sc.faces.shape[0] > 0 and len(sc.columns) == 12
    with pytest.raises(FileNotFoundError):
        scene.generate(dict(generator="no_such_scene"), 4)


# --- the launcher on a gloo world of 2 --------------------------------------

# The launcher's cells: every training cell, sharded over two gloo ranks
# (the committed cells use one card; the launcher serves any cell that
# asks for more).
SHARDED = [w["name"] for w in SPEC["workloads"]
           if registry.load(ROOT).cell(w["name"]).traffic["kind"] == "train"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
@pytest.mark.parametrize("name", SHARDED)
def test_launcher_gloo_world_of_two(tiny_bench, name, fault):
    """Two gloo ranks, each a spawned process: correct, the slowest
    rank's times; with the gradients' all-reduce left out, not correct.
    """
    from benchmark import launcher
    cell = tiny_bench.cell(name)._replace(chips=2)
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import launcher, registry\n"
        "if __name__ == '__main__':\n"
        f"    cell = registry.load({tiny_bench.root!r}).cell({name!r})"
        "._replace(chips=2)\n"
        f"    r, _ = launcher.run(cell, {name!r}, 5, 0.1, False, 0.0, "
        f"root={tiny_bench.root!r}, device_type='cpu', fault={fault!r})\n"
        "    print(json.dumps(r))\n")
    assert launcher.JOIN_S >= 60 and cell.chips == 2
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["device"]["count"] == 2
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] is (fault is None), result["compared"]


def test_a_failing_rank_fails_the_run(tiny_bench, monkeypatch, tmp_path):
    """A rank that raises: every step failed, not correct, no result
    numbers."""
    from benchmark import launcher
    reports = [dict(rank=0, ok=True, window=dict(
        attempted=8, failed=0, window_s=1.0, latencies_s=[], error=None), window_start=0.5, numbers={}),
        dict(rank=1, ok=False, error="boom")]
    monkeypatch.setattr(launcher, "spawn", lambda *a, **k: reports)
    cell = tiny_bench.cell(SHARDED[0])._replace(chips=2)
    result, _ = launcher.run(cell, SHARDED[0], 1, 0.1, False, 0.0,
                             root=tiny_bench.root, device_type="cpu")
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] == 8


# --- the entry ----------------------------------------------------------------

def test_entry_exits_nonzero_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_entry_exits_nonzero_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the entry fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_a_run_loads_no_jax_and_no_ugrt(tiny_bench):
    """A whole tiny run in a fresh process (set-up, window, check and the
    launcher's and profiler's modules imported): no module whose
    top-level name is jax, jaxlib, flax or ugrt is loaded."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.run as run\n"
        "from benchmark import (calibrate, drivers, faults, harness, "
        "launcher, profiler_child, registry, stages)\n"
        f"b = registry.load({tiny_bench.root!r})\n"
        f"for name in {ONE_CARD!r}:\n"
        "    harness.run_cell(b.cell(name), name, 3, 0.1, False, 'cpu', 0.0)\n"
        "bad = run.forbidden_modules()\n"
        "assert 'ugrt_torch' in sys.modules\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def test_forbidden_names_are_compared_whole():
    from benchmark import run
    sys.modules.setdefault("ugrt_torch", sys.modules.get("ugrt_torch"))
    assert all(m.split(".")[0] in run.FORBIDDEN
               for m in run.forbidden_modules())
    assert "ugrt_torch" not in run.FORBIDDEN


def test_trace_summary_busy_and_gaps():
    """The profiler child's summary of a synthetic Chrome trace."""
    from benchmark import profiler_child as pc
    ev = [dict(ph="X", name=pc.WINDOW_NAME, cat="user_annotation", ts=0,
               dur=100),
          dict(ph="X", name="cudaGraphLaunch", cat="cuda_runtime", ts=35,
               dur=20),
          dict(ph="X", name="k1<1>", cat="kernel", ts=10, dur=20),
          dict(ph="X", name="k1<2>", cat="kernel", ts=20, dur=20),
          dict(ph="X", name="memcpy", cat="gpu_memcpy", ts=60, dur=10),
          dict(ph="X", name="late", cat="kernel", ts=200, dur=10)]
    s = pc.summarize(dict(traceEvents=ev))
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["breakdown"]["device_ops"][0] == ["k#<#>", pytest.approx(40e-6)]
    assert s["breakdown"]["idle_gaps"][0] == ["cudaGraphLaunch",
                                              pytest.approx(20e-6)]


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_on_the_card_is_correct(card, name):
    """The committed cell, two seconds of its window on the card."""
    cell = registry.load(ROOT).cell(name)
    result, _ = harness.run_cell(cell, name, 2**31 + 101, 2.0, False, card,
                                 0.0)
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_control_fails_on_the_card(card, name):
    cell = registry.load(ROOT).cell(name)
    d = drivers.make(cell, 2**31 + 202, card)
    d.setup(1.0)
    d.window(1.0)
    d.free()
    assert not check.verdict(d.check(lowp=torch.bfloat16),
                             cell.config["limits"][cell.traffic["kind"]])
