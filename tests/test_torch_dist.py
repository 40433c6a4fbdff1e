"""ugrt_torch.dist.mesh and train(use_mesh=True) on gloo process groups of
2 and 4 CPU ranks, against the port's single-device path and ugrt's
sharded path on its 8-device CPU mesh (tests/test_dist.py).

Each world runs as separate processes (tests/torch_dist_worker.py,
started with subprocess, joined through a FileStore under tmp_path, each
wait bounded), which import torch, numpy and ugrt_torch only.  Sizes:
small_cfg (128², 16x16 grid) for frames, tiny_cfg (64², 8x8) for the
step and training; the Cornell box with tests/conftest.py's camera and
light.

Tolerances:
- sharded image: bitwise equal to the port's single-device render_color
  in all three light modes (each strip's rays are its own; the extents
  and windows reduce by MAX/MIN, which commute, before the margin), and
  within test_torch_grad.py's COLOR_ATOL of ugrt's sharded image (ugrt's
  jitted forward fuses multiply-adds);
- sharded step against ugrt's: loss rtol 1e-5, atol 1e-7; gradients
  rtol 1e-4, atol 1e-6 (tests/test_dist.py:80-84);
- train(use_mesh=True) against use_mesh=False: losses rtol 1e-5 (the
  sharded loss sums the strips' sums, not torch.mean's order),
  materials atol 1e-6;
- the sharded Programs against their eager bodies (``.fn``): bitwise,
  on two inputs in turn (two cameras, two targets) and one of another
  shape, which adds the Program's second key.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grad import COLOR_ATOL
from test_torch_train import LR, _triangle_case
from ugrt.core import camera as cam
from ugrt.diff import render_grad as rg_j
from ugrt.dist import mesh as dmesh_j
from ugrt_torch import bridge
from ugrt_torch.api import train as train_t
from ugrt_torch.diff import render_grad as rg_t
from ugrt_torch.dist import mesh as dmesh_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
MODES = ("reference", "windowed", "extent")
WORLDS = (2, 4)
TIMEOUT_S = 300          # every rank, every wait
TRAIN_STEPS = (3, 5)     # the first run, then its resume
# A second camera for the Programs' second input (test_torch_program.py's).
OTHER_CAMERA = cam.CameraSpec(eye=(0.3, -0.1, 2.2), look_at=(0.0, 0.05, 0.0),
                              up=(0.0, 1.0, 0.02), near=0.1, far=100.0)
PROGRAM_RESULTS = {"render": ("image", "overflow"),
                   "step": ("loss", "grad_vertices", "grad_materials",
                            "overflow")}


def _frame_arrays(cfg, scene, camera, light):
    """render_color's positional inputs as numpy arrays."""
    aspect = cfg.screen_width / cfg.screen_height
    return dict(
        vertices=scene.vertices.astype(np.float32),
        materials=scene.materials.astype(np.float32),
        faces=scene.faces.astype(np.int32),
        mat_index=scene.mat_index.astype(np.int32),
        camcoords=cam.camcoords_from_spec(camera, cfg.fovy_deg, aspect),
        light_camcoords=cam.camcoords_from_spec(light, cfg.fovy_deg,
                                                aspect)[None],
        light_position=np.asarray(light.eye, np.float32))


def _cfg_fields(cfg):
    return dataclasses.asdict(bridge.render_config(cfg))


def _spec(camera):
    return {k: getattr(camera, k) for k in ("eye", "look_at", "up", "near",
                                            "far")}


def _run_world(d, world, spec, arrays):
    """Run ``world`` worker ranks on ``spec``; returns each rank's
    results.  Fails (killing every rank) when one does not finish in
    TIMEOUT_S or exits non-zero."""
    d.mkdir()
    np.savez(d / "inputs.npz", **arrays)
    (d / "spec.json").write_text(json.dumps(dict(spec, timeout_s=TIMEOUT_S)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(d), str(r),
                               str(world)], env=env, cwd=str(d),
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    text = "".join(f"== rank {r}\n{(d / f'rank{r}.log').read_text()}"
                   for r in range(world))
    assert codes == [0] * world, text
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, small_cfg, tiny_cfg, cornell, generic_camera,
         generic_light):
    """Both worlds' results, {world: [rank results]}, and the inputs."""
    arrays, tasks = {}, []
    small = _frame_arrays(small_cfg, cornell, generic_camera, generic_light)
    arrays.update({f"small/{k}": v for k, v in small.items()})
    for mode in MODES:
        cfg = dataclasses.replace(small_cfg, light_grid_mode=mode)
        tasks.append(dict(name="render", key=f"render_{mode}",
                          inputs="small", cfg=_cfg_fields(cfg),
                          capacity=cfg.pair_capacity(cornell.num_faces),
                          use_spot=True))
    tiny = _frame_arrays(tiny_cfg, cornell, generic_camera, generic_light)
    target, _ = rg_j.render_color(
        *(jnp.asarray(tiny[k]) for k in ("vertices",)),
        jnp.asarray(tiny["materials"] * np.float32(0.7)),
        *(jnp.asarray(tiny[k]) for k in (
            "faces", "mat_index", "camcoords", "light_camcoords",
            "light_position")), cfg=tiny_cfg,
        capacity=tiny_cfg.pair_capacity(cornell.num_faces), num_lights=1,
        use_spot=False)
    tiny["target"] = np.asarray(target)
    arrays.update({f"tiny/{k}": v for k, v in tiny.items()})
    tasks.append(dict(name="step", key="step", inputs="tiny",
                      cfg=_cfg_fields(tiny_cfg),
                      capacity=tiny_cfg.pair_capacity(cornell.num_faces),
                      use_spot=False))

    sc, spec, light, tri_target = _triangle_case(tiny_cfg)
    arrays.update({f"tri/{k}": getattr(sc, k) for k in (
        "vertices", "materials", "faces", "mat_index")})
    arrays["tri/target"] = tri_target
    # The Programs: the first inputs, a second camera or target, then
    # the triangle's geometry (another shape: a second key).
    arrays["small/camcoords_2"] = cam.camcoords_from_spec(
        OTHER_CAMERA, small_cfg.fovy_deg, 1.0)
    arrays["tiny/target_2"] = np.random.default_rng(0).uniform(
        0.0, 0.3, tiny["target"].shape).astype(np.float32)
    tri = {k: f"tri/{k}" for k in ("vertices", "materials", "faces",
                                    "mat_index")}
    windowed = dataclasses.replace(small_cfg, light_grid_mode="windowed")
    tasks.append(dict(name="program_render", key="program_render",
                      inputs="small", cfg=_cfg_fields(windowed),
                      capacity=windowed.pair_capacity(cornell.num_faces),
                      use_spot=True, variants=[
                          {}, {"camcoords": "small/camcoords_2"}, tri]))
    tasks.append(dict(name="program_step", key="program_step",
                      inputs="tiny", cfg=_cfg_fields(tiny_cfg),
                      capacity=tiny_cfg.pair_capacity(cornell.num_faces),
                      use_spot=True, variants=[
                          {}, {"target": "tiny/target_2"}, tri]))
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        train = dict(name="train", key="train", inputs="tri",
                     cfg=_cfg_fields(tiny_cfg), camera=_spec(spec),
                     light=_spec(light), steps=TRAIN_STEPS, train=dict(
                         learning_rate=LR, optimize_vertices=False,
                         checkpoint_dir=str(d / "ck"), checkpoint_every=2,
                         use_mesh=True))
        # trace_psum_overlap.py:30-33's configuration at this world: the
        # Cornell box (subdiv=2), 64 rows, grid_x = 2 * world.
        gx = 2 * world
        psum_cfg = dataclasses.replace(small_cfg, screen_width=8 * gx,
                                       screen_height=64, grid_x=gx, grid_y=8,
                                       light_grid_mode="reference")
        psum = dict(name="psum_overlap", key="psum_overlap", inputs="small",
                    cfg=_cfg_fields(psum_cfg), out_dir=str(d / "psum"))
        # world 2 also trains and profiles; both worlds render and step.
        spec_w = dict(tasks=tasks + ([train, psum] if world == 2 else []))
        out[world] = _run_world(d / "run", world, spec_w, arrays)
    return out, small, tiny


def _port(arrays):
    return [bridge.from_numpy(arrays[k], "cpu") for k in (
        "vertices", "materials", "faces", "mat_index", "camcoords",
        "light_camcoords", "light_position")]


def _ranks_agree(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key], err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_render_equals_single_device(runs, small_cfg, cornell, mode,
                                             world):
    out, small, _ = runs
    cfg = bridge.render_config(dataclasses.replace(small_cfg,
                                                   light_grid_mode=mode))
    want, overflow = rg_t.render_color(
        *_port(small), cfg=cfg, capacity=cfg.pair_capacity(cornell.num_faces),
        num_lights=1, use_spot=True)
    assert not bool(overflow)
    results = out[world]
    for key in (f"render_{mode}/image", f"render_{mode}/overflow"):
        _ranks_agree(results, key)
    got = results[0][f"render_{mode}/image"]
    assert got.shape == (128, 128, 3) and not results[0][
        f"render_{mode}/overflow"]
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_render_close_to_ugrt(runs, small_cfg, cornell, mode):
    """Against ugrt's sharded_render on its 8-device mesh."""
    out, small, _ = runs
    cfg = dataclasses.replace(small_cfg, light_grid_mode=mode)
    render = dmesh_j.sharded_render(
        dmesh_j.make_mesh(), cfg=cfg,
        capacity=cfg.pair_capacity(cornell.num_faces), num_lights=1,
        use_spot=True)
    want, overflow = render(*(jnp.asarray(small[k]) for k in (
        "vertices", "materials", "faces", "mat_index", "camcoords",
        "light_camcoords", "light_position")))
    assert not bool(overflow)
    for world in WORLDS:
        np.testing.assert_allclose(out[world][0][f"render_{mode}/image"],
                                   np.asarray(want), rtol=0, atol=COLOR_ATOL)


@pytest.fixture(scope="module")
def ugrt_step(runs, tiny_cfg, cornell):
    """ugrt's sharded_train_step on its 8-device mesh, the same inputs."""
    step = dmesh_j.sharded_train_step(
        dmesh_j.make_mesh(), cfg=tiny_cfg,
        capacity=tiny_cfg.pair_capacity(cornell.num_faces), num_lights=1,
        use_spot=False)
    tiny = runs[2]
    out = step(*(jnp.asarray(tiny[k]) for k in (
        "vertices", "materials", "faces", "mat_index", "camcoords",
        "light_camcoords", "light_position", "target")))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_train_step_matches_ugrt(runs, ugrt_step, world):
    out = runs[0]
    loss, gv, gm, overflow = ugrt_step
    assert not bool(overflow)
    results = out[world]
    for key in ("loss", "grad_vertices", "grad_materials", "overflow"):
        _ranks_agree(results, f"step/{key}")
    r = results[0]
    assert not r["step/overflow"] and float(r["step/loss"]) > 0
    np.testing.assert_allclose(float(r["step/loss"]), float(loss), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(r["step/grad_vertices"], np.asarray(gv),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["step/grad_materials"], np.asarray(gm),
                               rtol=1e-4, atol=1e-6)
    assert np.abs(r["step/grad_materials"]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["render", "step"])
def test_sharded_program_equals_eager_body(runs, world, name):
    """Each rank's Program call bitwise its eager body's (.fn), on every
    input in turn, and every rank's equal to rank 0's; the two inputs of
    one shape give different results (the Program reads its new
    inputs)."""
    results = runs[0][world]
    key = f"program_{name}"
    for r in results:
        for i in range(3):
            for res in PROGRAM_RESULTS[name]:
                got = r[f"{key}/{i}/program/{res}"]
                want = r[f"{key}/{i}/eager/{res}"]
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(
                    got.view(np.int32) if got.dtype == np.float32 else got,
                    want.view(np.int32) if want.dtype == np.float32
                    else want, err_msg=f"input {i}: {res}")
    for i in range(3):
        for res in PROGRAM_RESULTS[name]:
            _ranks_agree(results, f"{key}/{i}/program/{res}")
    r = results[0]
    first = PROGRAM_RESULTS[name][0]
    assert not np.array_equal(r[f"{key}/0/program/{first}"],
                              r[f"{key}/1/program/{first}"])
    assert not any(r[f"{key}/{i}/program/overflow"] for i in range(3))
    if name == "render":
        assert r[f"{key}/0/program/image"].shape == (128, 128, 3)
    else:
        assert np.abs(r[f"{key}/0/program/grad_materials"]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_programs_one_key_per_shape(runs, world):
    """A sharded Program holds one key per input shape: the second
    camera or target reuses the first key, the triangle's geometry adds
    a second, on every rank."""
    for r in runs[0][world]:
        for name in PROGRAM_RESULTS:
            assert [int(r[f"program_{name}/{i}/keys"])
                    for i in range(3)] == [1, 1, 2], name


def test_trace_psum_overlap_gloo(runs):
    """micro.trace_psum_overlap on gloo world 2 (the script's Cornell
    configuration): every rank's profiled step holds an all-reduce, each
    share lies in [0, 1], the span is the slowest rank's on every rank
    and the loss is positive and the same on both ranks."""
    results = runs[0][2]
    spans = [r["psum_overlap/span_ms"] for r in results]
    for r in results:
        assert int(r["psum_overlap/all_reduces"]) >= 1
        shares = r["psum_overlap/shares"]
        assert shares.size >= 3 and ((shares >= 0) & (shares <= 1)).all()
        assert r["psum_overlap/loss"] > 0
        assert r["psum_overlap/loss"] == results[0]["psum_overlap/loss"]
    assert all(s[0] == max(t[1] for t in spans) for s in spans)


def test_train_use_mesh_matches_single_device(runs, tiny_cfg, tmp_path):
    """train(use_mesh=True) at world 2, 3 steps then a resume to 5 (a
    checkpoint every 2 steps), against the same two runs without the
    mesh: the same losses and materials on every rank; only rank 0 wrote
    checkpoints (steps 1 and 3); the resume started at step 2."""
    out, _, _ = runs
    results = out[2]
    for key in ("train/log0", "train/log1", "train/materials",
                "train/vertices", "train/latest"):
        _ranks_agree(results, key)
    assert list(results[0]["train/saves"]) == [1, 3]
    assert list(results[1]["train/saves"]) == []
    assert int(results[0]["train/latest"]) == 3

    sc, spec, light, target = _triangle_case(tiny_cfg)
    logs = []
    for steps in TRAIN_STEPS:
        _, mats, log = train_t.train(
            bridge.scene(sc), [bridge.camera_spec(spec)],
            bridge.camera_spec(light), light.eye, [target],
            bridge.render_config(tiny_cfg), train_t.TrainConfig(
                learning_rate=LR, steps=steps, optimize_vertices=False,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2),
            verbose=False, device="cpu")
        logs.append(log)
    r = results[0]
    assert [len(r["train/log0"]), len(r["train/log1"])] == [3, 3]
    for i in (0, 1):
        np.testing.assert_allclose(r[f"train/log{i}"], logs[i], rtol=1e-5)
    np.testing.assert_allclose(r["train/materials"], mats.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(r["train/vertices"], sc.vertices)
    assert np.abs(r["train/materials"] - sc.materials).max() > 0.05


@pytest.mark.parametrize("n", [2, 4])
def test_strip_color_without_group(small_cfg, cornell, generic_camera,
                                   generic_light, n):
    """render_color's strips (bx0, n_bx) with group=None run no
    collective: in reference mode (no window depends on the hit points)
    the n strips side by side are bitwise the whole render_color."""
    arrays = _frame_arrays(small_cfg, cornell, generic_camera, generic_light)
    cfg = bridge.render_config(small_cfg)
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(cornell.num_faces),
              num_lights=1, use_spot=True)
    want, _ = rg_t.render_color(*_port(arrays), **kw)
    n_bx = cfg.grid_x // n
    strips = [rg_t.render_color(*_port(arrays), **kw, bx0=d * n_bx,
                                n_bx=n_bx)[0] for d in range(n)]
    assert torch.equal(torch.cat(strips, dim=1), want)


def test_make_mesh_binds_the_rank_card(monkeypatch):
    """On the card, make_mesh takes cuda:<LOCAL_RANK> and makes it the
    process's current device, so the kernels' launches, the allocator and
    NCCL work on the rank's own card (with a group started without
    device_id the current device would stay cuda:0 on every rank)."""
    bound = []
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group: 3)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    mesh = dmesh_t.make_mesh(group="group")
    assert mesh == dmesh_t.Mesh("group", 3, 4, torch.device("cuda", 3))
    assert bound == [torch.device("cuda", 3)]
    assert dmesh_t.make_mesh(group="group", device="cuda:1").device == \
        torch.device("cuda", 1) and bound[-1] == torch.device("cuda", 1)
    monkeypatch.undo()
    assert not torch.distributed.is_initialized()


def test_mesh_refuses_what_it_cannot_run(small_cfg, tiny_cfg):
    """grid_x not divisible by the world size raises ValueError; without
    an initialized process group make_mesh and train(use_mesh=True) raise
    RuntimeError (no group is started behind the caller's back)."""
    assert not torch.distributed.is_initialized()
    cfg = bridge.render_config(small_cfg)
    mesh = dmesh_t.Mesh(None, 0, 3, torch.device("cpu"))
    for make in (dmesh_t.sharded_render, dmesh_t.sharded_train_step):
        with pytest.raises(ValueError, match="divide"):
            make(mesh, cfg=cfg, capacity=1, num_lights=1, use_spot=True)
    with pytest.raises(RuntimeError, match="process group"):
        dmesh_t.make_mesh(device="cpu")
    sc, spec, light, target = _triangle_case(tiny_cfg)
    with pytest.raises(RuntimeError, match="process group"):
        train_t.train(bridge.scene(sc), [bridge.camera_spec(spec)],
                      bridge.camera_spec(light), light.eye, [target],
                      bridge.render_config(tiny_cfg),
                      train_t.TrainConfig(steps=1, use_mesh=True),
                      verbose=False, device="cpu")
    assert not torch.distributed.is_initialized()
