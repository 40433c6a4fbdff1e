"""ugrt_torch's checkpoints, optimizer and training loop vs
ugrt's (tests/test_api.py:55-130).

Tolerances:
- checkpoints: arrays exactly equal, both ways between the packages;
- Adam: the port's optimizer (torch.optim.Adam, evaluated with float64
  bias corrections) within rtol 1e-6, atol 1e-6 of an exact float64
  Adam on float32 gradients, and within rtol 1e-6, atol OPTAX_ATOL of
  optax.adam, which evaluates 1 - b^t in float32 (measured on these
  gradients: optax 2.5e-6 from the float64 Adam at most, the port
  3.0e-7);
- train(): losses within rtol 1e-4 and final materials within atol 1e-5
  of ugrt's train() (materials only: the gradients are large or exactly
  zero, so Adam does not magnify rounding differences).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.api import checkpoint as ckpt_j
from ugrt.api import train as train_j
from ugrt.core import camera as cam
from ugrt.diff import render_grad
from ugrt.scene import procedural
from ugrt_torch import bridge
from ugrt_torch.api import checkpoint as ckpt_t
from ugrt_torch.api import train as train_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 5e-2
# |optax - exact float64 Adam| over 10 steps at LR: one f32 rounding of
# 1 - b2^t (~2^-24 / (1 - b2^t), halved by the square root) per step,
# summed: LR * sum_t 2^-24 / (2e-3 t) < 2e-5.
OPTAX_ATOL = 2e-5


def test_checkpoint_roundtrip_npz(tmp_path):
    state = {"params": {"vertices": torch.ones((4, 3)) * 2,
                        "materials": np.zeros((2, 6), np.float32)}}
    p = str(tmp_path / "ck")
    fn = ckpt_t.save_checkpoint(p, state, step=7)
    assert fn.endswith("step_7.npz")
    assert ckpt_t.latest_step(p) == 7
    loaded = ckpt_t.load_checkpoint(p)
    assert sorted(loaded) == ["params/materials", "params/vertices"]
    np.testing.assert_array_equal(loaded["params/vertices"],
                                  np.full((4, 3), 2, np.float32))
    assert ckpt_t.load_checkpoint(fn).keys() == loaded.keys()


def test_checkpoint_latest_of_many(tmp_path):
    p = str(tmp_path / "ck")
    assert ckpt_t.latest_step(p) is None
    for s in (1, 5, 3):
        ckpt_t.save_checkpoint(p, {"x": np.full(2, s, np.float32)}, step=s)
    assert ckpt_t.latest_step(p) == 5
    assert ckpt_t.load_checkpoint(p)["x"][0] == 5
    assert ckpt_t.load_checkpoint(p, step=3)["x"][0] == 3


@pytest.mark.parametrize("writer", ["ugrt", "port"])
def test_checkpoint_cross_read(tmp_path, writer):
    """ugrt (use_orbax=False) reads the port's files and the port reads
    ugrt's."""
    rng = np.random.default_rng(0)
    state = {"params": {"vertices": rng.standard_normal((5, 3)).astype(
        np.float32), "materials": rng.random((2, 6)).astype(np.float32)}}
    p = str(tmp_path / "ck")
    if writer == "ugrt":
        ckpt_j.save_checkpoint(p, state, step=4, use_orbax=False)
        loaded = ckpt_t.load_checkpoint(p)
    else:
        ckpt_t.save_checkpoint(p, state, step=4)
        loaded = ckpt_j.load_checkpoint(p, use_orbax=False)
    assert ckpt_t.latest_step(p) == ckpt_j.latest_step(p) == 4
    assert sorted(loaded) == ["params/materials", "params/vertices"]
    for k in ("vertices", "materials"):
        np.testing.assert_array_equal(loaded[f"params/{k}"],
                                      state["params"][k])


def test_checkpoint_refuses_orbax(tmp_path):
    """A step ugrt wrote in Orbax form raises, naming Orbax."""
    pytest.importorskip("orbax.checkpoint")
    p = str(tmp_path / "ck")
    ckpt_j.save_checkpoint(p, {"x": np.ones(2, np.float32)}, step=2,
                           use_orbax=True)
    assert ckpt_t.latest_step(p) == 2
    for step in (None, 2):
        with pytest.raises(ValueError, match="Orbax"):
            ckpt_t.load_checkpoint(p, step)
    ckpt_t.save_checkpoint(p, {"x": np.zeros(2, np.float32)}, step=1)
    assert ckpt_t.load_checkpoint(p)["x"][0] == 0


def _exact_adam(p0, grads, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    p, m, v = p0.astype(np.float64), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        g = g.astype(np.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * (m / (1 - b1**t)) / (np.sqrt(v / (1 - b2**t)) + eps)
    return p


def test_adam_matches_optax():
    """The same 10 gradient arrays (magnitudes 1e-6 to 10) through
    optax.adam(LR) and the port's optimizer."""
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((6, 3)).astype(np.float32)
    grads = [(rng.standard_normal((6, 3)) * 10.0 ** rng.integers(-6, 2))
             .astype(np.float32) for _ in range(10)]
    opt = optax.adam(LR)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    pt = torch.from_numpy(p0.copy())
    opt_t = train_t.make_optimizer([pt], LR)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
        pt.grad = torch.from_numpy(g)
        opt_t.step()
    exact = _exact_adam(p0, grads)
    np.testing.assert_allclose(pt.numpy(), exact, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=OPTAX_ATOL)
    assert np.abs(pt.numpy() - p0).max() > 0.1


def _triangle_case(cfg):
    """tests/test_api.py:96-115: the tilted single triangle, its camera
    and light, and the target rendered with the materials halved."""
    sc = dataclasses.replace(procedural.single_triangle(), vertices=np.asarray(
        [[-1.0, -1.1, -3.1], [1.1, -0.9, -2.7], [0.05, 1.2, -3.4]],
        dtype=np.float32))
    spec = cam.CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0, 0, -1),
                          up=(0, 1, 0), near=0.1, far=100.0)
    light = cam.CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0, 0, -3),
                           up=(0, 1, 0), near=0.1, far=100.0)
    cc = jnp.asarray(cam.camcoords_from_spec(spec, cfg.fovy_deg, 1.0))
    lcc = jnp.asarray(cam.camcoords_from_spec(light, cfg.fovy_deg, 1.0))[None]
    target, _ = render_grad.render_color(
        jnp.asarray(sc.vertices), jnp.asarray(sc.materials) * 0.5,
        jnp.asarray(sc.faces), jnp.asarray(sc.mat_index), cc, lcc,
        jnp.asarray(np.asarray(light.eye, np.float32)), cfg=cfg,
        capacity=cfg.pair_capacity(sc.num_faces), num_lights=1,
        use_spot=True)
    return sc, spec, light, np.asarray(target)


def _train_port(cfg, case, tcfg):
    sc, spec, light, target = case
    return train_t.train(bridge.scene(sc), [bridge.camera_spec(spec)],
                         bridge.camera_spec(light), light.eye, [target],
                         bridge.render_config(cfg), tcfg, verbose=False,
                         device="cpu")


def test_train_matches_ugrt(tiny_cfg):
    """5 steps, materials only, against ugrt's train() (no checkpoint_dir:
    ugrt's checkpoints default to Orbax here)."""
    case = _triangle_case(tiny_cfg)
    sc, spec, light, target = case
    _, mats_j, log_j = train_j.train(
        sc, [spec], light, light.eye, [target], tiny_cfg,
        train_j.TrainConfig(learning_rate=LR, steps=5,
                            optimize_vertices=False), verbose=False)
    verts, mats, log = _train_port(tiny_cfg, case, train_t.TrainConfig(
        learning_rate=LR, steps=5, optimize_vertices=False))
    np.testing.assert_allclose(log, log_j, rtol=1e-4)
    np.testing.assert_allclose(mats.numpy(), np.asarray(mats_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(verts.numpy(), sc.vertices)
    assert np.abs(mats.numpy() - sc.materials).max() > 0.1


def test_train_recovers_materials_and_resumes(tiny_cfg, tmp_path):
    """tests/test_api.py:87-130 for the port: the loss falls below 0.2x
    its first value in 30 steps; checkpoints every 10 steps hold the
    parameters; a resumed run starts at step 30."""
    case = _triangle_case(tiny_cfg)
    d = str(tmp_path / "ck")
    tcfg = train_t.TrainConfig(learning_rate=LR, steps=30,
                               optimize_vertices=False, checkpoint_dir=d,
                               checkpoint_every=10)
    _, mats, log = _train_port(tiny_cfg, case, tcfg)
    assert len(log) == 30 and log[-1] < log[0] * 0.2, f"{log[0]} -> {log[-1]}"
    assert ckpt_t.latest_step(d) == 29
    saved = ckpt_t.load_checkpoint(d)
    np.testing.assert_array_equal(saved["params/materials"], mats.numpy())
    _, _, log2 = _train_port(tiny_cfg, case,
                             dataclasses.replace(tcfg, steps=35))
    assert len(log2) == 5 and ckpt_t.latest_step(d) == 29


def test_train_refuses_what_it_cannot_run(tiny_cfg):
    case = _triangle_case(tiny_cfg)
    # use_mesh runs on every rank of an initialized process group; with
    # none initialized it raises rather than start one.
    with pytest.raises(RuntimeError, match="process group"):
        _train_port(tiny_cfg, case, train_t.TrainConfig(steps=1,
                                                        use_mesh=True))
    if not torch.cuda.is_available():
        sc, spec, light, target = case
        with pytest.raises(RuntimeError, match="CUDA"):
            train_t.train(bridge.scene(sc), [bridge.camera_spec(spec)],
                          bridge.camera_spec(light), light.eye, [target],
                          bridge.render_config(tiny_cfg),
                          train_t.TrainConfig(steps=1), verbose=False)
