"""ugrt_torch's CUDA kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (and nvcc, for the first build): every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX, so
on a machine without it run it without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none for the kernels and frames.  The kernels are compiled
without FMA contraction and with IEEE division and square root
(kernels/_build.py), so (t, face) are bitwise equal and shadow flags
exact.  The whole small frame on the card must also equal the same frame
rendered on the CPU.  The differentiable step's image must too; its loss
is a mean (rtol 1e-5, atol 1e-7) and its gradients sums over pixels in
another order on each device (within 1e-5 * max|g|).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.scene import procedural

pytestmark = pytest.mark.cuda

SMALL = dataclasses.replace(RenderConfig(), screen_width=128,
                            screen_height=128, grid_x=16, grid_y=16)
CAMERA = cam.CameraSpec(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                        up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
INSIDE_BOX = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                            up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
LIGHT = cam.CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                       up=(0.0, 0.0, 1.0), near=0.1, far=100.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _recorded_sweeps(cfg, camera, heavy_threshold=None, mode="reference"):
    """Run one frame on the card and record each sweep's inputs."""
    from ugrt_torch.api.renderer import Renderer
    from ugrt_torch.trace import primary as tprimary
    from ugrt_torch.trace import shadow as tshadow

    sites = {}
    names = [(tprimary, "primary_sweep"), (tprimary, "heavy_primary_sweep"),
             (tshadow, "shadow_sweep")]
    originals = [(m, n, getattr(m, n)) for m, n in names]

    def recorder(name, fn):
        def record(*args, **kwargs):
            site = name + ("_box" if kwargs.get("box") else "")
            sites.setdefault(site, (fn, [a.clone() if torch.is_tensor(a)
                                         else a for a in args], kwargs))
            return fn(*args, **kwargs)
        return record

    cfg = dataclasses.replace(cfg, light_grid_mode=mode)
    if heavy_threshold is not None:
        cfg = dataclasses.replace(cfg, heavy_threshold=heavy_threshold)
    scene = procedural.cornell_box(subdiv=2)
    try:
        for m, n, fn in originals:
            setattr(m, n, recorder(n, fn))
        Renderer(scene, cfg, capacity=cfg.pair_capacity(scene.num_faces) * 16,
                 device="cuda").render(camera, [LIGHT], LIGHT.eye)
    finally:
        for m, n, fn in originals:
            setattr(m, n, fn)
    return sites


def _plain_of(site):
    from ugrt_torch.kernels import heavy_primary_sweep as k2
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.kernels import shadow_sweep as k3
    return {"primary_sweep": k1.primary_sweep_plain,
            "heavy_primary_sweep": k2.heavy_primary_sweep_plain,
            "shadow_sweep": k3.shadow_sweep_plain,
            "shadow_sweep_box": k3.shadow_sweep_plain}[site]


@pytest.mark.parametrize("camera,heavy_threshold,mode", [
    (CAMERA, None, "reference"), (CAMERA, 4, "windowed"),
    (INSIDE_BOX, 16, "reference"), (CAMERA, 1, "windowed")])
def test_kernels_match_plain(card, camera, heavy_threshold, mode):
    sites = _recorded_sweeps(SMALL, camera, heavy_threshold, mode)
    assert "primary_sweep" in sites and "shadow_sweep" in sites
    for site, (fn, args, kwargs) in sites.items():
        before = fn.launches
        got = fn(*args, **kwargs)
        assert fn.launches == before + 1
        want = _plain_of(site)(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            assert torch.equal(g, w), site


def test_primary_sweep_edges(card):
    """Empty ranges, ranges past the last window and a single block."""
    from ugrt_torch.kernels import primary_sweep as k1

    g = torch.Generator().manual_seed(0)
    tri = torch.rand((3, 128, 16), generator=g) * 2 - 1
    tri[..., 9] = torch.randint(0, 3, (3, 128), generator=g).float()
    tri[..., 10] = torch.arange(3 * 128).reshape(3, 128).float()
    rays = torch.rand((2, 128, 8), generator=g) * 2 - 1
    rays[..., 3] = torch.randint(0, 3, (2, 128), generator=g).float()
    w_lo = torch.tensor([2, 0], dtype=torch.int32)
    w_hi = torch.tensor([1, 7], dtype=torch.int32)
    cfg = SMALL
    a = [x.to(card) for x in (tri, rays, w_lo, w_hi)]
    got = k1.primary_sweep(*a, cfg=cfg)
    want = k1.primary_sweep_plain(*a, cfg=cfg)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (got[0][0] == 3e38).all() and (got[1][0] == 2**31 - 1).all()
    assert (got[0][1] < 3e38).any()


def test_frame_on_card_equals_cpu(card):
    """The whole small frame (grid, sweeps, shading) on the card equals
    the port's CPU frame bit for bit."""
    from ugrt_torch.api.renderer import Renderer

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode="windowed")
    outs = [Renderer(scene, cfg, device=d).render(CAMERA, [LIGHT], LIGHT.eye)
            for d in ("cuda", "cpu")]
    for key in ("image", "color", "shadowed"):
        np.testing.assert_array_equal(outs[0][key].cpu().numpy(),
                                      outs[1][key].numpy(), err_msg=key)
    for key in ("t", "face_id", "normal"):
        np.testing.assert_array_equal(outs[0]["primary"][key].cpu().numpy(),
                                      outs[1]["primary"][key].numpy(),
                                      err_msg=key)


def test_render_and_grad_card_equals_cpu(card):
    """render_and_grad on the rotated Cornell box (tests/test_grad.py:
    154-182) at 64^2, on the card and on the CPU."""
    from ugrt_torch import bridge
    from ugrt_torch.diff.render_grad import render_and_grad

    a, b = 0.11, 0.07
    rx = np.asarray([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], dtype=np.float32)
    ry = np.asarray([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                     [-np.sin(b), 0, np.cos(b)]], dtype=np.float32)
    scene = procedural.cornell_box(subdiv=2)
    scene = dataclasses.replace(scene, vertices=np.ascontiguousarray(
        scene.vertices @ (rx @ ry).T))
    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8)
    light = cam.CameraSpec(eye=(0.1, 0.85, 0.4), look_at=(0.0, -1.0, 0.3),
                           up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
    target = np.random.default_rng(0).uniform(0, 0.3, (64, 64, 3)).astype(
        np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        t = bridge.scene_to_torch(scene, dev)
        cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, dev)
        lcc = bridge.camcoords_to_torch(light, cfg.fovy_deg, 1.0, dev)[None]
        outs.append(render_and_grad(
            t["vertices"], t["materials"], t["faces"], t["mat_index"], cc,
            lcc, bridge.from_numpy(light.eye, dev, np.float32),
            bridge.from_numpy(target, dev), cfg=cfg,
            capacity=cfg.pair_capacity(scene.num_faces), num_lights=1,
            use_spot=True))
    got, want = outs
    assert not bool(got["overflow"])
    np.testing.assert_array_equal(got["color"].cpu().numpy(),
                                  want["color"].numpy())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    for key in ("grad_vertices", "grad_materials"):
        w = want[key].numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got[key].cpu().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name,sizes", [
    ("micro_mxu", dict(n_items=64)),
    ("pallas_micro", dict(cap8=4096, n_items=640, n_tiles=64)),
    ("micro_heavy", dict(nb=65)),
])
def test_probes_match_plain_on_card(card, name, sizes):
    """The probes S1-S3 at small sizes: every variant bitwise equal to its
    plain version (S1 mma within its bound), as chip_smoke's phase 7
    checks at the scripts' sizes."""
    import importlib

    mod = importlib.import_module(f"ugrt_torch.micro.{name}")
    records = mod.run(iters=1, workload=mod.make_workload(card, **sizes))
    assert records
    assert not [r for r in records if r["mismatches"]]
