"""ugrt_torch's CUDA kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (and nvcc, for the first build): every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX and
nothing of ugrt, so on a machine without them run it without the JAX
test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none for the kernels and frames.  The kernels are compiled
without FMA contraction and with IEEE division and square root
(kernels/_build.py), so (t, face) are bitwise equal and shadow flags
exact.  The whole small frame on the card must also equal the same frame
rendered on the CPU.  The differentiable step's image must too; its loss
is a mean (rtol 1e-5, atol 1e-7) and its gradients sums over pixels in
another order on each device (within 1e-5 * max|g|).  The captured
programs (render_frame_device, render_frame_reflective, render_and_grad)
replay bitwise what their eager functions compute on the card; train()
through them stays within rtol 1e-6 of train() with the eager step.  The
reflection DDA D1 is bitwise equal to its plain version (t, face_id,
overflow) on the Cornell reflective frame's rays, in pixel order and
shuffled, and on the DDA's edge case (ugrt_torch/micro/dda_edge.py),
also in batches of 48 faces over a coarser grid.  The bench entry
``python -m ugrt_torch.bench`` runs as a user runs it, its parity gate
included (face_id and t bitwise, at most 16 shadow pixels apart).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.scene import procedural

pytestmark = pytest.mark.cuda

SMALL = dataclasses.replace(RenderConfig(), screen_width=128,
                            screen_height=128, grid_x=16, grid_y=16)
CAMERA = CameraSpec(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                    up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
INSIDE_BOX = CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                        up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
LIGHT = CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
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
    """Empty ranges, ranges past the last window and a single block, at
    every chunk size."""
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
    want = k1.primary_sweep_plain(*a, cfg=cfg)
    for chunk in (1, 2, 4, 8):
        got = k1.primary_sweep(*a, cfg=cfg, chunk=chunk)
        for x, y in zip(got, want):
            assert torch.equal(x, y), chunk
        assert (got[0][0] == 3e38).all() and (got[1][0] == 2**31 - 1).all()
        assert (got[0][1] < 3e38).any()


def test_primary_sweep_skewed_on_card(card):
    """K1 on its skewed case (one ray block spanning 119 windows beside
    empty ranges, two-cell blocks and a range past the end) at every
    chunk size: bitwise equal to the plain version, twice in a row
    (bitwise repeatable, whatever order the items merge in); its warp
    counts add up to the tests of every item's windows."""
    from ugrt_torch.kernels import _plain
    from ugrt_torch.kernels import primary_sweep as k1
    from ugrt_torch.micro.k3_chunks import skewed_primary_case

    args = skewed_primary_case(card, 0)
    want = k1.primary_sweep_plain(*args, cfg=SMALL)
    assert int((want[0] < 3e38).sum()) > 1000
    tri, _, w_lo, w_hi = args
    for chunk in (1, 2, 4, 8):
        before = k1.primary_sweep.launches
        got = [k1.primary_sweep(*args, cfg=SMALL, chunk=chunk)
               for _ in range(2)]
        assert k1.primary_sweep.launches == before + 2
        for g in got:
            assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
        stats = k1.primary_sweep_stats(*args, cfg=SMALL, chunk=chunk)
        assert k1.primary_sweep.launches == before + 2
        _, w0, w1 = _plain.chunk_windows(_plain.chunk_item_end(
            w_lo, w_hi, tri.shape[0], chunk), w_lo, w_hi, tri.shape[0],
            chunk)
        walked = int((w1 - w0 + 1).sum()) * 128 * 128
        assert stats["tested"] + stats["skipped"] == walked
        assert 0 < stats["tested"] < walked // 4


def _heavy_case(device, nb=5, live=300, width=384, seed=0):
    """(heavy_count, table [16, width], rays [nb, 128, 8]) for K2, from
    numpy ``seed``: random coefficient rows; ray block b's two tiles sit
    in cells (2b, 0) and (2b + 1, 0), except the first block's second
    tile, whose rays take cells 0, 1, 2 in turn (warps of mixed cells),
    and the last block's second tile, which lies in no footprint.  Faces 0-99 hold only tile 0 of block f % nb, faces 100-199
    both tiles of one block, the rest the whole first row of cells; faces
    200-249 have det 0 (never accepted).  Columns from ``live`` on are
    dead.  nb is odd, so the last CUDA block holds one ray block."""
    rng = np.random.default_rng(seed)
    table = np.zeros((16, width), np.float32)
    table[0:10] = rng.standard_normal((10, width))
    f = np.arange(width)
    b = f % nb
    table[10] = np.where(f < 200, 2 * b, 0)
    table[11] = np.where(f < 100, 2 * b, np.where(f < 200, 2 * b + 1,
                                                  2 * nb - 2))
    table[12], table[13] = 0, 0
    table[0:3, 200:250] = 0.0
    table[14] = f
    table[10:15, live:] = np.asarray([1, 0, 1, 0, -1])[:, None]
    table[0:10, live:] = 0.0
    rays = np.zeros((nb, 128, 8), np.float32)
    d = rng.standard_normal((nb, 128, 3))
    rays[:, :, 0:3] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays[:, :64, 4] = 2 * np.arange(nb)[:, None]
    rays[:, 64:, 4] = 2 * np.arange(nb)[:, None] + 1
    rays[0, 64:, 4] = np.arange(64) % 3
    rays[-1, 64:, 4] = 1000.0
    count = torch.tensor(live, dtype=torch.int32, device=device)
    return (count, torch.from_numpy(table).to(device),
            torch.from_numpy(rays).to(device))


def test_heavy_primary_sweep_synthetic_on_card(card):
    """K2 where footprints hold one tile of a block and not the other,
    where one tile's warps mix cells, one tile lies in no footprint (its
    warps accept nothing) and some faces have det 0, with dead columns
    and an odd number of ray blocks: bitwise equal to the plain version;
    its warp counts add up to every (ray, live face) test."""
    from ugrt_torch.kernels import heavy_primary_sweep as k2

    args = _heavy_case(card)
    want = k2.heavy_primary_sweep_plain(*args, cfg=SMALL)
    before = k2.heavy_primary_sweep.launches
    got = k2.heavy_primary_sweep(*args, cfg=SMALL)
    assert k2.heavy_primary_sweep.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    t = want[0]
    assert int((t < 3e38).sum()) > 200
    assert not bool((t[-1, 64:] < 3e38).any())
    stats = k2.heavy_primary_sweep_stats(*args, cfg=SMALL)
    live_tests = 3 * 128 * t.numel()
    assert sum(stats.values()) == live_tests
    assert min(stats.values()) > 0


@pytest.mark.parametrize("all_occluded", [False, True])
def test_shadow_sweep_skewed_on_card(card, all_occluded):
    """K3 on the skewed case (one ray block spanning 300 windows beside
    empty ranges and a range past the end) and on its all-occluded twin
    (every item can stop early), at every chunk size and in both walks:
    exactly equal to the plain version, twice in a row (bitwise
    repeatable)."""
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.micro.k3_chunks import skewed_case

    args = skewed_case(card, 0, all_occluded)
    want = k3.shadow_sweep_plain(*args, cfg=SMALL)
    assert int(want.sum()) > 1000
    for chunk in (1, 2, 4, 8):
        for serial in (False, True):
            before = k3.shadow_sweep.launches
            got = [k3.shadow_sweep(*args, cfg=SMALL, chunk=chunk,
                                   serial=serial) for _ in range(2)]
            assert k3.shadow_sweep.launches == before + 2
            assert torch.equal(got[0], want) and torch.equal(got[1], want)


def test_shadow_sweep_reference_like_on_card(card):
    """K3 on the reference-like case (micro.k3_chunks.reference_case) in
    both walks at every chunk size: exactly equal to the plain version;
    the counting build reports steps and tests consistent with the
    inputs, and launches no kernel of the main path."""
    from ugrt_torch.kernels import _plain
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.micro.k3_chunks import reference_case

    args = reference_case(card, 0)
    want = k3.shadow_sweep_plain(*args, cfg=SMALL)
    live = int((args[1][:, :, 4] >= 0).sum())
    assert 0.6 * live < int(want.sum()) < live
    for chunk in (1, 2, 4, 8, 16):
        for serial in (False, True):
            got = k3.shadow_sweep(*args, cfg=SMALL, chunk=chunk,
                                  serial=serial)
            assert torch.equal(got, want), (chunk, serial)
            before = k3.shadow_sweep.launches
            st = k3.shadow_sweep_stats(*args, cfg=SMALL, chunk=chunk,
                                       serial=serial)
            assert k3.shadow_sweep.launches == before
            assert set(st) == set(k3.STATS) and st["items"] > 0
            assert 0 < st["live_tests"] <= 32 * st["executed_steps"]
            assert st["divided_tests"] <= st["live_tests"]
            assert st["hint_hits"] <= st["hint_steps"]
            if serial:
                # A ray, sentinel rays of a live block too, goes to the
                # second pass at most once a work item of its block; at
                # chunk 16 a block's whole range is one item.
                items = int(_plain.chunk_item_end(args[2], args[3],
                                                  args[0].shape[0],
                                                  chunk)[-1])
                assert st["hint_hits"] > 0
                assert st["deferred_rays"] <= 128 * items
                assert chunk < 16 or st["deferred_rays"] < live
            else:
                assert st["hint_steps"] == st["deferred_rays"] == 0


# A second light on another side of the Cornell box.
SECOND_LIGHT = CameraSpec(eye=(-0.6, 0.5, 0.9), look_at=(0.2, -1.0, 0.0),
                          up=(0.0, 0.0, 1.0), near=0.1, far=100.0)


@pytest.mark.parametrize("lights", [[LIGHT], [LIGHT, SECOND_LIGHT]],
                         ids=["one-light", "two-lights"])
def test_frame_on_card_equals_cpu(card, lights):
    """The whole small frame (grid, sweeps, shading) on the card equals
    the port's CPU frame bit for bit, with one light and with two."""
    from ugrt_torch.api.renderer import Renderer

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode="windowed")
    outs = [Renderer(scene, cfg, device=d).render(CAMERA, lights, LIGHT.eye)
            for d in ("cuda", "cpu")]
    for key in ("image", "color", "shadowed"):
        np.testing.assert_array_equal(outs[0][key].cpu().numpy(),
                                      outs[1][key].numpy(), err_msg=key)
    for key in ("t", "face_id", "normal"):
        np.testing.assert_array_equal(outs[0]["primary"][key].cpu().numpy(),
                                      outs[1]["primary"][key].numpy(),
                                      err_msg=key)


def test_reflective_frame_on_card_equals_cpu(card):
    """render_frame_reflective at 128^2 (uniform grid 8^3): the card's
    reflection (t, face) and image equal the CPU's bit for bit (the same
    elementwise ops in the same order; no FMA contraction across ops)."""
    from ugrt_torch import bridge
    from ugrt_torch.api.renderer import render_frame_reflective

    scene = procedural.cornell_box(subdiv=2)
    outs = []
    for dev in ("cuda", "cpu"):
        t = bridge.scene_to_torch(scene, dev)
        cc = bridge.camcoords_to_torch(CAMERA, SMALL.fovy_deg, 1.0, dev)
        lcc = bridge.camcoords_to_torch(LIGHT, SMALL.fovy_deg, 1.0, dev)
        outs.append(render_frame_reflective(
            t["vertices"], t["faces"], t["mat_index"], t["materials"], cc,
            lcc[None], bridge.from_numpy(LIGHT.eye, dev, np.float32),
            cfg=SMALL, capacity=SMALL.pair_capacity(scene.num_faces),
            num_lights=1, use_spot=True, uniform_dims=(8, 8, 8)))
    got, want = outs
    assert not bool(got["overflow"])
    assert int((want["reflection"]["face_id"] >= 0).sum()) > 5000
    for key in ("t", "face_id"):
        np.testing.assert_array_equal(got["reflection"][key].cpu().numpy(),
                                      want["reflection"][key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(got["image"].cpu().numpy(),
                                  want["image"].numpy())


def _reflective_inputs(device, camera=CAMERA, cfg=SMALL):
    from ugrt_torch import bridge

    scene = procedural.cornell_box(subdiv=2)
    t = bridge.scene_to_torch(scene, device)
    cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)
    args = (t["vertices"], t["faces"], t["mat_index"], t["materials"], cc,
            lcc[None], bridge.from_numpy(LIGHT.eye, device, np.float32))
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True, uniform_dims=(8, 8, 8))
    return args, kw


@pytest.mark.parametrize("case", ["cornell", "edge", "shuffled", "batch-48"])
def test_uniform_dda_matches_plain_on_card(card, monkeypatch, case):
    """D1 against its plain version on the card, bit for bit (t, face_id,
    overflow): on the inputs that the 128^2 Cornell reflective frame gives
    it (8x4 pixel tiles a warp); on the DDA's edge case (a cell deeper
    than its batches, coincident faces, zero direction components, rays
    outside the AABB, inactive rays); on the Cornell rays in a seeded
    random order (a warp's lanes in up to 32 distinct cells, so that its
    loop over cells runs at its worst); and in batches of 48 faces (not a
    multiple of the 32 a warp stages at once) over the edge case on a 2^3
    grid, whose cells hold up to 73 faces (two batches, staged in chunks
    of 32 and 16)."""
    from ugrt_torch.api.renderer import render_frame_reflective
    from ugrt_torch.kernels import uniform_dda as kdda
    from ugrt_torch.micro import dda_edge
    from ugrt_torch.trace import reflect as treflect

    if case == "edge":
        args = dda_edge.dda_edge_inputs(card)
        kw = dict(max_batches=dda_edge.MAX_BATCHES, eps=1e-4,
                  batch=dda_edge.BATCH, skip_k=6)
    elif case == "batch-48":
        args = dda_edge.dda_edge_inputs(card, dims=(2, 2, 2))
        kw = dict(max_batches=2, eps=1e-4, batch=48, skip_k=6)
        assert int(args[1].cell_count.max()) > 64
    else:
        seen = []

        def record(*a, **k):
            seen.append((a, dict(k)))
            return kdda.uniform_dda(*a, **k)

        monkeypatch.setattr(treflect, "uniform_dda", record)
        fargs, fkw = _reflective_inputs(card)
        render_frame_reflective.fn(*fargs, **fkw)
        (args, kw), = seen
        del kw["cfg"]
        assert kw["width"] == SMALL.screen_width
        if case == "shuffled":
            pick = torch.from_numpy(np.random.default_rng(0).permutation(
                args[2].shape[0])).to(card)
            args = (*args[:2], *(x[pick].contiguous() for x in args[2:6]),
                    *args[6:])
    before = kdda.uniform_dda.launches
    got = kdda.uniform_dda(*args, cfg=SMALL, **kw)
    want = kdda.uniform_dda_plain(*args, cfg=SMALL, **kw)
    torch.cuda.synchronize()
    assert kdda.uniform_dda.launches == before + 1
    assert got["t"].device.type == "cuda"
    _bitwise(got["t"], want["t"], "t")
    for key in ("face_id", "overflow"):
        assert torch.equal(got[key], want[key]), key
    assert bool(got["overflow"]) == (case == "edge")
    assert int((want["face_id"] >= 0).sum()) > (500 if "edge" in case
                                                 or "48" in case else 5000)
    assert 0 < int(got["steps"]) <= sum(args[-1])
    stats = kdda.uniform_dda_stats(*args, cfg=SMALL, **kw)
    assert 0 < stats["needed"] <= stats["staged_lane_slots"]
    assert stats["needed"] <= stats["lockstep_lane_slots"]
    assert 0 < stats["rounds"] <= stats["cells"]


@pytest.mark.parametrize("mode", ["windowed", "reference"])
def test_graphed_reflective_frame_equals_eager(card, mode):
    """render_frame_reflective's program at 128^2 (uniform grid 8^3)
    against its eager body, three cameras in turn: image, color,
    shadowed, overflow and the reflection's t and face_id bitwise; each
    replay credits D1 with one launch."""
    from ugrt_torch.api.renderer import render_frame_reflective
    from ugrt_torch.kernels.uniform_dda import uniform_dda

    cfg = dataclasses.replace(SMALL, light_grid_mode=mode)
    hits = 0
    for camera in (CAMERA, INSIDE_BOX, CAMERA):
        args, kw = _reflective_inputs(card, camera, cfg)
        got = render_frame_reflective(*args, **kw)
        before = uniform_dda.launches
        again = render_frame_reflective(*args, **kw)
        assert uniform_dda.launches == before + 1
        want = render_frame_reflective.fn(*args, **kw)
        for out in (got, again):
            for key in FRAME_KEYS:
                _bitwise(out[key], want[key], key)
            for key in ("t", "face_id"):
                _bitwise(out["reflection"][key], want["reflection"][key],
                         key)
        hits += int((want["reflection"]["face_id"] >= 0).sum())
    assert hits > 10000


def test_train_on_card_equals_cpu(card, tmp_path):
    """train() on the single triangle at 64^2 (materials only, 5 steps,
    a checkpoint at step 2): losses within rtol 1e-5 of the CPU's (the
    loss is a mean summed in another order), materials within 1e-6."""
    from ugrt_torch.api import checkpoint
    from ugrt_torch.api.train import TrainConfig, train

    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8)
    scene = procedural.single_triangle()
    spec = CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0, 0, -1),
                      up=(0, 1, 0), near=0.1, far=100.0)
    light = CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0, 0, -3),
                       up=(0, 1, 0), near=0.1, far=100.0)
    target = np.full((64, 64, 3), 0.1, np.float32)
    runs = []
    for dev in ("cuda", "cpu"):
        tcfg = TrainConfig(learning_rate=5e-2, steps=5,
                           optimize_vertices=False,
                           checkpoint_dir=str(tmp_path / dev),
                           checkpoint_every=3)
        runs.append(train(scene, [spec], light, light.eye, [target], cfg,
                          tcfg, verbose=False, device=dev))
        assert checkpoint.latest_step(str(tmp_path / dev)) == 2
    (_, m_g, log_g), (_, m_c, log_c) = runs
    assert m_g.device.type == "cuda" and log_g[-1] < log_g[0]
    np.testing.assert_allclose(log_g, log_c, rtol=1e-5)
    np.testing.assert_allclose(m_g.cpu().numpy(), m_c.numpy(), rtol=0,
                               atol=1e-6)


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
    light = CameraSpec(eye=(0.1, 0.85, 0.4), look_at=(0.0, -1.0, 0.3),
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


def _tied_heavy_case(device):
    """``_heavy_case`` at four windows (v3 takes NWH 4) with tied t: for
    every third column c of the first window, column c + 1 repeats
    column c's face and column c + 128 repeats it too, with the ids of c
    and c + 128 swapped, so the smallest id of three equal candidates
    sits in the later window."""
    count, table, rays = _heavy_case("cpu", width=512)
    for c in range(0, 126, 3):
        table[:14, c + 1] = table[:14, c]
        table[:14, c + 128] = table[:14, c]
        table[14, c], table[14, c + 128] = c + 128, c
    return count.to(device), table.to(device), rays.to(device)


def _tile_edges_case(device):
    """(offs, tiles, tri, rays) for S2: 37 items, so neither 8 nor 64
    items per block divide them; offsets and ray tiles before and past
    the tables' ends (clamped); table rows r and r + 95 equal, so where a
    column's first minimum lies in rows 0-32 its twin ties with it from
    another row slice."""
    rng = np.random.default_rng(5)
    tri = np.tile(rng.standard_normal((95, 128), dtype=np.float32),
                  (11, 1))[:1000]
    offs = rng.integers(0, 1000 - 128, 37).astype(np.int32)
    offs[:4] = (-3, 1000 - 128, 999, 5000)
    tiles = rng.integers(0, 6, 37).astype(np.int32)
    tiles[:3] = (-1, 6, 100)
    rays = rng.standard_normal((6, 8, 128), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (offs, tiles, tri, rays))


@pytest.mark.parametrize("name,case", [
    ("micro_mxu", dict(n_items=64)),
    ("pallas_micro", dict(cap8=4096, n_items=640, n_tiles=64)),
    ("pallas_micro", _tile_edges_case),
    ("micro_heavy", dict(nb=65)),
    ("micro_heavy", lambda device: _heavy_case(device, width=512)),
    ("micro_heavy", _tied_heavy_case),
], ids=["mxu", "tiles", "tiles-edges", "heavy", "heavy-case", "heavy-tied"])
def test_probes_match_plain_on_card(card, name, case):
    """The probes S1-S3 at small sizes (each variant at every mb or
    wchunk): every variant bitwise equal to its plain version (S1 mma
    within its bound), as chip_smoke's phase 7 checks at the scripts'
    sizes; also on S2's and S3's edge cases above and ``_heavy_case``.
    S3's counting builds (K2's too) account for every (ray, live face)
    test; on the synthetic cases each of their four counts is non-zero."""
    import importlib

    mod = importlib.import_module(f"ugrt_torch.micro.{name}")
    workload = (mod.make_workload(card, **case) if isinstance(case, dict)
                else case(card))
    records = mod.run(iters=1, workload=workload)
    assert records
    assert not [r for r in records if r["mismatches"]]
    if name == "pallas_micro" and not isinstance(case, dict):
        _, i = mod.tp.tile_sweep_plain(*workload, "full")
        assert float((i < 33).float().mean()) > 0.2      # ties across slices
    if name == "micro_heavy":
        count, table, rays = workload
        live = min(-(-int(count) // 128), table.shape[1] // 128)
        for r in records:
            assert sum(r["stats"].values()) == live * 128 * rays.shape[0] * 128
            assert isinstance(case, dict) or min(r["stats"].values()) > 0
        if case is _tied_heavy_case:
            face = mod.heavy_primary_sweep_plain(*workload, cfg=SMALL)[1]
            assert bool(torch.isin(face, torch.arange(0, 126, 3,
                                                      device=card)).any())


def _frame_tensors(scene, cfg, device):
    """(vertices, materials, faces, mat_index, camcoords, light_camcoords,
    light_position) of the Cornell frame on ``device``."""
    from ugrt_torch import bridge

    t = bridge.scene_to_torch(scene, device)
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)[None]
    return (t["vertices"], t["materials"], t["faces"], t["mat_index"], cc,
            lcc, bridge.from_numpy(LIGHT.eye, device, np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_strips_on_card_equal_cpu(card, n):
    """trace_primary's strips (dist.mesh's per-rank columns) on the card,
    side by side, equal the CPU's whole trace bit for bit, and
    render_color's strips in reference mode equal the CPU's whole
    render_color."""
    from ugrt_torch.diff.render_grad import render_color
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.trace import primary as tprimary

    scene = procedural.cornell_box(subdiv=2)
    kw = dict(cfg=SMALL, capacity=SMALL.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    n_bx = SMALL.grid_x // n
    traces, colors = {}, {}
    for dev in ("cuda", "cpu"):
        v, m, f, mi, cc, lcc, lp = _frame_tensors(scene, SMALL, dev)
        grid = gbuild.build_perspective_grid(v, f, cc, cfg=SMALL,
                                             capacity=kw["capacity"])
        if dev == "cpu":
            traces[dev] = tprimary.trace_primary(v, f, cc, grid, SMALL)
            colors[dev] = render_color(v, m, f, mi, cc, lcc, lp, **kw)[0]
            continue
        strips = [tprimary.trace_primary(v, f, cc, grid, SMALL,
                                         bx0=d * n_bx, n_bx=n_bx)
                  for d in range(n)]
        traces[dev] = {k: torch.cat([s[k] for s in strips], 1).cpu()
                       for k in strips[0]}
        colors[dev] = torch.cat([render_color(
            v, m, f, mi, cc, lcc, lp, **kw, bx0=d * n_bx, n_bx=n_bx)[0]
            for d in range(n)], 1).cpu()
    for k in ("t", "face_id", "normal"):
        assert torch.equal(traces["cuda"][k], traces["cpu"][k]), k
    assert torch.equal(colors["cuda"], colors["cpu"])


def test_sharded_step_nccl_world_one(card, tmp_path):
    """An NCCL group of one rank: sharded_render bitwise equals
    render_color on the card, and sharded_train_step's loss (rtol 1e-5)
    and gradients (1e-6 * max|g|) match render_and_grad's."""
    import torch.distributed as dist

    from ugrt_torch.diff.render_grad import render_and_grad, render_color
    from ugrt_torch.dist import mesh as dmesh

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode="windowed")
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    frame = _frame_tensors(scene, cfg, "cuda")
    target = torch.full((128, 128, 3), 0.1, device="cuda")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = dmesh.make_mesh()
        assert mesh.device == torch.device("cuda", 0)
        image, overflow = dmesh.sharded_render(mesh, **kw)(*frame)
        want, _ = render_color(*frame, **kw)
        assert torch.equal(image, want) and not bool(overflow)
        loss, gv, gm, overflow = dmesh.sharded_train_step(mesh, **kw)(
            *frame, target)
    finally:
        dmesh.clear()
        dist.destroy_process_group()
    ref = render_and_grad(*frame[:7], target, **kw)
    assert not bool(overflow)
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    for got, key in ((gv, "grad_vertices"), (gm, "grad_materials")):
        w = ref[key]
        assert float(w.abs().max()) > 0
        assert float((got - w).abs().max()) <= 1e-6 * float(w.abs().max())


def test_sharded_programs_replay_eager_nccl_world_one(card, tmp_path):
    """An NCCL group of one rank: the sharded frame's and step's Programs
    (their collectives inside the graph) replay bitwise their eager
    bodies (.fn), two cameras and two targets in turn, one key each."""
    import torch.distributed as dist

    from ugrt_torch import bridge
    from ugrt_torch.dist import mesh as dmesh

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode="windowed")
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    frames = [_frame_tensors(scene, cfg, "cuda")]
    frames.append(list(frames[0]))
    frames[1][4] = bridge.camcoords_to_torch(INSIDE_BOX, cfg.fovy_deg, 1.0,
                                             "cuda")
    rng = np.random.default_rng(0)
    targets = [torch.from_numpy(rng.uniform(0.0, 0.3, (128, 128, 3)).astype(
        np.float32)).cuda() for _ in range(2)]
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = dmesh.make_mesh()
        render = dmesh.sharded_render(mesh, **kw)
        step = dmesh.sharded_train_step(mesh, **kw)
        images = []
        for frame in frames:
            got, want = render(*frame), render.fn(*frame)
            for g, w, key in zip(got, want, ("image", "overflow")):
                _bitwise(g, w, key)
            assert not bool(got[1])
            images.append(got[0])
        losses = []
        for target in targets:
            got = step(*frames[0], target)
            want = step.fn(*frames[0], target)
            for g, w, key in zip(got, want, ("loss", "grad_vertices",
                                             "grad_materials", "overflow")):
                _bitwise(g, w, key)
            assert float(got[2].abs().sum()) > 0
            losses.append(float(got[0]))
        assert render.cache_size() == step.cache_size() == 1
    finally:
        dmesh.clear()
        dist.destroy_process_group()
    assert not torch.equal(images[0], images[1])
    assert losses[0] != losses[1]


def test_second_sharded_job_captures_nothing(card, tmp_path):
    """Two cards, an NCCL group of two ranks (tests/torch_dist_worker.py,
    one process a card): a second train(use_mesh=True) job like the first
    replays the kept step Program's graph.  On every rank the count of
    program.captures after the second job equals the count after the
    first (one), both jobs ran one Program of one key, and the second
    job's losses and parameters equal the first's bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = procedural.cornell_box(subdiv=2)
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "inputs.npz", **{
        f"box/{k}": getattr(scene, k) for k in ("vertices", "materials",
                                                "faces", "mat_index")},
        **{"box/target": rng.uniform(0.0, 0.3, (128, 128, 3)).astype(
            np.float32)})
    job = dict(learning_rate=1e-2, steps=6)
    task = dict(name="train_jobs", key="jobs", inputs="box",
                cfg=dataclasses.asdict(SMALL), jobs=[job, job],
                camera=dataclasses.asdict(CAMERA),
                light=dataclasses.asdict(LIGHT))
    (tmp_path / "spec.json").write_text(json.dumps(dict(
        tasks=[task], backend="nccl", timeout_s=600)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "torch_dist_worker.py"),
         str(tmp_path), str(r), "2"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]
    for r in range(2):
        out = np.load(tmp_path / f"rank{r}.npz")
        assert [int(out[f"jobs/{i}/captures"]) for i in (0, 1)] == [1, 1]
        assert [int(out[f"jobs/{i}/keys"]) for i in (0, 1)] == [1, 1]
        assert bool(out["jobs/same"])
        for res in ("log", "vertices", "materials"):
            a, b = out[f"jobs/0/{res}"], out[f"jobs/1/{res}"]
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=res)
        assert len(out["jobs/0/log"]) == 6


def test_build_packets_on_card_equals_cpu(card):
    """build_packets on the card equals the CPU on 1M cells with hot cells
    and sentinels (tests/test_packets.py's mix at the flagship size)."""
    from ugrt_torch.trace import shadow as tshadow

    cfg = RenderConfig()
    rng = np.random.default_rng(7)
    n = 1024 * 1024
    cells = rng.integers(0, cfg.cell_sentinel, n).astype(np.int32)
    idx = rng.random(n) < 0.6
    cells[idx] = rng.choice(rng.integers(0, cfg.cell_sentinel, 4), idx.sum())
    cells[rng.random(n) < 0.05] = cfg.cell_sentinel
    c = torch.from_numpy(cells)
    ray_g, work_g = tshadow.build_packets(c.cuda(), cfg)
    ray_c, work_c = tshadow.build_packets(c, cfg)
    assert torch.equal(ray_g.cpu(), ray_c)
    for a, b in zip(work_g, work_c):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert not bool(work_c.overflow)


# ---------------------------------------------------------------------------
# Captured programs (core.program): one CUDA graph replay per frame and
# per step, bitwise the eager functions' (.fn) on the same inputs.

FRAME_KEYS = ("image", "color", "shadowed", "overflow")


def _bitwise(got, want, key):
    if want.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), key


@pytest.mark.parametrize("mode", ["windowed", "reference", "extent"])
def test_graphed_frame_equals_eager(card, mode):
    """render_frame_device at 128^2 against render_frame, three cameras
    in turn (a stale input buffer would show), every output bitwise."""
    from ugrt_torch import bridge
    from ugrt_torch.api.renderer import render_frame_device

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode=mode)
    t = bridge.scene_to_torch(scene, card)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, card)[None]
    lp = bridge.from_numpy(LIGHT.eye, card, np.float32)
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    shadowed = 0
    for camera in (CAMERA, INSIDE_BOX, CAMERA):
        cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, 1.0, card)
        args = (t["vertices"], t["faces"], t["mat_index"], t["materials"],
                cc, lcc, lp)
        got = render_frame_device(*args, **kw)
        want = render_frame_device.fn(*args, **kw)
        for key in FRAME_KEYS:
            _bitwise(got[key], want[key], key)
        for key in ("t", "face_id", "normal", "ray_dir"):
            _bitwise(got["primary"][key], want["primary"][key], key)
        shadowed += int(want["shadowed"].sum())
    assert shadowed > 100


def test_graphed_step_equals_eager(card):
    """render_and_grad's program against the eager step (.fn) on the
    rotated Cornell box at 64^2, two targets in turn: loss, color and
    both gradients bitwise (the kernels merge by atomicMin and OR, and
    the gathers' backward sums in fixed point)."""
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
    t = bridge.scene_to_torch(scene, card)
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, card)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, card)[None]
    lp = bridge.from_numpy(LIGHT.eye, card, np.float32)
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=1, use_spot=True)
    rng = np.random.default_rng(0)
    for _ in range(2):
        target = bridge.from_numpy(rng.uniform(0, 0.3, (64, 64, 3)), card,
                                   np.float32)
        args = (t["vertices"], t["materials"], t["faces"], t["mat_index"],
                cc, lcc, lp, target)
        got = render_and_grad(*args, **kw)
        want = render_and_grad.fn(*args, **kw)
        for key in ("loss", "color", "grad_vertices", "grad_materials",
                    "overflow"):
            _bitwise(got[key], want[key], key)
        assert float(want["grad_materials"].abs().sum()) > 0


def test_train_through_program_equals_eager(card, monkeypatch):
    """train() (its step replayed from one graph) against train() with
    the eager step, on the single triangle at 64^2, 5 steps: losses and
    materials within rtol 1e-6."""
    from ugrt_torch.api import train as tmod

    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8)
    scene = procedural.single_triangle()
    spec = CameraSpec(eye=(0.01, 0.02, 2.0), look_at=(0, 0, -1),
                      up=(0, 1, 0), near=0.1, far=100.0)
    light = CameraSpec(eye=(0.5, 1.5, 1.0), look_at=(0, 0, -3),
                       up=(0, 1, 0), near=0.1, far=100.0)
    target = np.full((64, 64, 3), 0.1, np.float32)
    tcfg = tmod.TrainConfig(learning_rate=5e-2, steps=5)
    runs = []
    for step in (tmod.render_and_grad, tmod.render_and_grad.fn):
        monkeypatch.setattr(tmod, "render_and_grad", step)
        runs.append(tmod.train(scene, [spec], light, light.eye, [target],
                               cfg, tcfg, verbose=False, device=card))
    (v_g, m_g, log_g), (v_e, m_e, log_e) = runs
    assert log_g[-1] < log_g[0]
    np.testing.assert_allclose(log_g, log_e, rtol=1e-6)
    for got, want in ((v_g, v_e), (m_g, m_e)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-6)


def test_program_refuses_host_read_at_capture(card):
    """No fallback: a body that reads a value on the host cannot be
    captured, and the call raises."""
    from ugrt_torch.core.program import Program

    def body(x):
        return x * x.sum().item()

    prog = Program(body, static=())
    with pytest.raises(RuntimeError):
        prog(torch.ones(4, device=card))
    assert prog.cache_size() == 0


def test_program_refuses_host_read_in_thread_local_mode(card):
    """The sharded programs' capture mode (thread_local, dist.mesh) still
    refuses a host read on the capturing thread, and the call raises."""
    from ugrt_torch.core.program import Program

    def body(x):
        return x * x.sum().item()

    prog = Program(body, static=(), capture_error_mode="thread_local")
    with pytest.raises(RuntimeError):
        prog(torch.ones(4, device=card))
    assert prog.cache_size() == 0


def test_bench_entry_on_card(card):
    """python -m ugrt_torch.bench --iters 3 at the flagship: exit 0, the
    last stdout line bench.py's JSON object, the parity gate within its
    16 shadow pixels, no overflow (the bench raises on one)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ugrt_torch.bench", "--iters", "3"],
        cwd=repo, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    assert line["metric"] == "primary_rays_per_s_fwd_bwd" and line["value"] > 0
    assert d["parity_shadow_px"] <= 16 and d["trace_backend"] == "cuda"
    assert d["step_ms_chained_events"] > 0 and d["light_grid_mode"] == (
        "windowed")


SEGMENT_CASES = ("material", "corner", "one row, shared", "one row, large",
                 "runs 31-257", "cutoff below", "cutoff above", "40 binades",
                 "inf", "nan", "empty", "1 column", "6 columns", "9 columns",
                 "96 columns")
FACE_CASES = ("step corner", "one face", "shared vertices",
              "degenerate faces", "misses to face 0", "runs 31-257",
              "random faces", "40 binades", "inf", "nan", "empty")


def _g1_bitwise(case, name):
    """The case's G1 sum (micro.gather_bwd.sums) twice through its
    wrapper: each launch counted, each bitwise the plain version."""
    from ugrt_torch.micro import gather_bwd

    fn, plain = gather_bwd.sums(case)
    want = plain(*case)
    before = fn.launches
    outs = [fn(*case), fn(*case)]
    assert fn.launches == before + 2
    for out in outs:
        assert out.device.type == "cuda" and out.shape == want.shape
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), (
            name, int((out.view(torch.int32) != want.view(torch.int32)).sum()))


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_sum_matches_plain_on_card(card, case):
    """G1 bitwise its plain version (NaN bits included) at the flagship
    step's two shapes (the material sum; the corner sum keyed by face) and
    on micro.gather_bwd's skewed cases, through the wrapper (twice: the
    same bits).  The cases reach each of the kernel's tables by their
    shapes (test_torch_gather's test_skewed_cases_cover_every_table)."""
    from ugrt_torch.micro import gather_bwd

    cases = (gather_bwd.flagship_cases(card)
             if case in ("material", "corner")
             else gather_bwd.skewed_cases(card))
    _g1_bitwise(cases[case], case)


@pytest.mark.parametrize("case", FACE_CASES)
def test_face_corner_sum_matches_plain_on_card(card, case):
    """G1's face-keyed sum bitwise face_corner_sum_plain (NaN bits
    included) on the flagship step's own corner sum (recorded from one
    eager windowed step) and on micro.gather_bwd's face cases, through
    the wrapper, twice."""
    from ugrt_torch.micro import gather_bwd

    if case == "step corner":
        args = gather_bwd.record_inputs()["corner"]
        assert len(args) == 4
    else:
        args = gather_bwd.face_cases(card)[case]
    _g1_bitwise(args, case)


def _near_power_of_two(rng, m):
    """[m + 1] f32 across 40 binades whose last m have sum |v| 2^-33
    below 2^19 (a few f64 ulps): sums of them in different orders round
    differently and land on either side."""
    v = (rng.uniform(0.5, 1.5, m + 1)
         * 2.0 ** rng.integers(-40, 1, m + 1)).astype(np.float32)
    v[-3:] = 0
    for k, undershoot in ((3, 1.0), (2, 2.0 ** -12), (1, 2.0 ** -33)):
        rest = math.fsum(np.abs(v[1:]).astype(np.float64))
        v[-k] = np.float32(2.0 ** 19 - rest - undershoot)
    return v


def test_segment_sum_ignores_alignment_on_card(card):
    """G1's scale pass sums |v| in one order whether or not the values
    are 16-byte aligned: a view that starts one element in gives the bits
    of its aligned copy, with sum |v| a few ulps below a power of two
    (where another order of that sum may pick another binade), and the
    bits of the plain version away from one."""
    from ugrt_torch.kernels import segment_sum as g1

    n = 100_003
    rng = np.random.default_rng(5)
    for trial in range(4):
        flat = torch.from_numpy(_near_power_of_two(rng, 3 * n)).to(card)
        idx = torch.from_numpy(rng.integers(0, 700, n).astype(
            np.int32)).to(card)
        unaligned = flat[1:].view(n, 3)
        assert unaligned.data_ptr() % 16
        aligned = unaligned.clone()
        assert torch.equal(
            g1.segment_sum(unaligned, idx, 700).view(torch.int32),
            g1.segment_sum(aligned, idx, 700).view(torch.int32)), trial
    values = torch.from_numpy(rng.normal(size=3 * n + 1).astype(
        np.float32)).to(card)[1:].view(n, 3)
    assert torch.equal(g1.segment_sum(values, idx, 700).view(torch.int32),
                       g1.segment_sum_plain(values, idx, 700).view(
                           torch.int32))


def test_step_backward_launches_g1_on_the_calling_thread(card,
                                                       monkeypatch):
    """render_and_grad's backward runs on the thread that calls it, not
    on autograd's worker thread, so a capture's G1 launches come from the
    capturing thread (core/program.py): the face-keyed corner sum and the
    material sum, each once, and no index_add_ kernel (indexFunc*)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from ugrt_torch import bridge
    from ugrt_torch.core import gather
    from ugrt_torch.diff.render_grad import render_and_grad

    threads = []

    def recorder(name):
        original = getattr(gather, name)

        def record(*args):
            threads.append((name, threading.get_ident()))
            return original(*args)
        return record

    for name in ("face_corner_sum", "segment_sum"):
        monkeypatch.setattr(gather, name, recorder(name))
    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8)
    t = bridge.scene_to_torch(scene, card)
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_and_grad.fn(
            t["vertices"], t["materials"], t["faces"], t["mat_index"], cc,
            cc[None],
            bridge.from_numpy(np.asarray(CAMERA.eye), card, np.float32),
            torch.zeros((64, 64, 3), device=card), cfg=cfg,
            capacity=cfg.pair_capacity(scene.num_faces), num_lights=1,
            use_spot=True)
        torch.cuda.synchronize()
    assert sorted(threads) == [("face_corner_sum", threading.get_ident()),
                               ("segment_sum", threading.get_ident())]
    names = {e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA"}
    assert any("face_accumulate_kernel" in n for n in names), names
    assert any("row_accumulate_kernel" in n for n in names), names
    assert not any("indexFunc" in n for n in names), names


def test_gather_rows_backward_launches_g1_on_card(card):
    """On CUDA tensors gather_rows's backward launches G1's kernels and no
    index_add_ kernel (indexFunc*), and equals the CPU's backward."""
    from torch.profiler import ProfilerActivity, profile

    from ugrt_torch.core.gather import gather_rows
    from ugrt_torch.kernels import segment_sum as g1

    rng = np.random.default_rng(3)
    table = torch.tensor(rng.normal(size=(300, 3)), dtype=torch.float32)
    idx = torch.from_numpy(rng.integers(0, 300, size=(64, 48, 3)))
    cot = torch.from_numpy(rng.normal(size=(64, 48, 3, 3)).astype(np.float32))
    grads = []
    for device in ("cpu", card):
        t = table.to(device).requires_grad_(True)
        out = gather_rows(t, idx.to(device))
        before = g1.segment_sum.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (g,) = torch.autograd.grad(out, t, cot.to(device))
            torch.cuda.synchronize()
        grads.append(g.cpu())
        names = {e.key for e in prof.key_averages()
                 if e.device_type.name == "CUDA"}
        if device == card:
            assert g1.segment_sum.launches == before + 1
            assert any("row_accumulate_kernel" in n for n in names), names
            assert not any("indexFunc" in n for n in names), names
    assert torch.equal(grads[0], grads[1])


def test_face_gathers_backward_launch_g1_on_card(card):
    """On CUDA tensors gather_face_corners's and gather_face_data's
    backward launch G1's face-keyed kernel and no index_add_ kernel, and
    equal the CPU's backward and the per-corner gather_rows's."""
    from torch.profiler import ProfilerActivity, profile

    from ugrt_torch.core.gather import (gather_face_corners,
                                        gather_face_data, gather_rows)
    from ugrt_torch.kernels import segment_sum as g1

    rng = np.random.default_rng(4)
    table = torch.tensor(rng.normal(size=(300, 3)), dtype=torch.float32)
    faces = torch.from_numpy(rng.integers(0, 300, (150, 3)).astype(np.int32))
    fid = torch.from_numpy(np.repeat(rng.integers(0, 150, 64 * 12), 4)
                           .astype(np.int32).reshape(64, 48))
    aux = torch.from_numpy(rng.normal(size=(150, 2)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(64, 48, 3, 3)).astype(np.float32))
    grads = []
    for kind in ("corners", "data", "rows"):
        for device in ("cpu", card):
            t = table.to(device).requires_grad_(True)
            f, i = faces.to(device), fid.to(device)
            if kind == "corners":
                out = gather_face_corners(t, f, i)
            elif kind == "data":
                out = gather_face_data(t, f, aux.to(device), i)[0]
            else:
                out = gather_rows(t, f[i.long()].long())
            assert torch.equal(out.cpu(), table[faces[fid.long()].long()])
            before = g1.face_corner_sum.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                (g,) = torch.autograd.grad(out, t, cot.to(device))
                torch.cuda.synchronize()
            grads.append(g.cpu())
            names = {e.key for e in prof.key_averages()
                     if e.device_type.name == "CUDA"}
            if device == card and kind != "rows":
                assert g1.face_corner_sum.launches == before + 1
                assert any("face_accumulate_kernel" in n for n in names), names
                assert not any("indexFunc" in n for n in names), names
    for g in grads[1:]:
        assert torch.equal(g.view(torch.int32), grads[0].view(torch.int32))


# B1 (kernels/shadow_bin) on the flagship frame: bench's camera and
# light over the 75k-face procedural cathedral at 1024^2, 128x128 grid.
FLAGSHIP_CAMERA = CameraSpec(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                             up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
FLAGSHIP_LIGHT = CameraSpec(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                            up=(0.0, 1.0, 0.0), near=0.1, far=100.0)
B1_MODES = ["reference", "extent", "windowed", "windowed-angles"]


@pytest.fixture(scope="module")
def flagship_frame():
    """(scene tensors, eye, light camcoords, primary, cfg) of the flagship
    frame on the card, traced once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from ugrt_torch import bridge
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.trace import primary as tprimary

    cfg = RenderConfig()
    dev = torch.device("cuda")
    scene = procedural.cathedral(num_faces_target=75000)
    t = bridge.scene_to_torch(scene, dev)
    cc = bridge.camcoords_to_torch(FLAGSHIP_CAMERA, cfg.fovy_deg, 1.0, dev)
    lcc = bridge.camcoords_to_torch(FLAGSHIP_LIGHT, cfg.fovy_deg, 1.0, dev)
    grid = gbuild.build_perspective_grid(
        t["vertices"], t["faces"], cc, cfg=cfg,
        capacity=cfg.pair_capacity(scene.num_faces))
    prim = tprimary.trace_primary(t["vertices"], t["faces"], cc, grid, cfg)
    return t, cc[0:3], lcc, {k: prim[k] for k in ("t", "ray_dir")}, cfg


def _b1_kwargs(mode, prim, eye, lcc, cfg):
    from ugrt_torch.kernels import shadow_bin as b1
    from ugrt_torch.trace import shadow as tshadow

    if mode == "reference":
        return {}
    if mode == "extent":
        x, y = tshadow.light_extents(prim, eye, lcc, cfg)
        return dict(x_max=x, y_max=y)
    bounds, angles = b1.window_angles(prim, eye, lcc)
    kw = dict(window=tshadow.apply_window_margin(*bounds))
    if mode == "windowed-angles":
        kw["angles"] = angles
    return kw


def _b1_equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        _bitwise(g, w, name)


@pytest.mark.parametrize("mode", B1_MODES)
def test_shadow_rays_match_plain_on_card(card, flagship_frame, mode):
    """B1 on the flagship frame's 1,048,576 rays: every key, the
    permutation, the rows and the block bounds bitwise its plain
    version (torch.sort's stable permutation is unique), and its
    unpermute of random flags bitwise the plain scatter."""
    from ugrt_torch.kernels import shadow_bin as b1

    _, eye, lcc, prim, cfg = flagship_frame
    kw = _b1_kwargs(mode, prim, eye, lcc, cfg)
    before = b1.shadow_rays.launches
    got = b1.shadow_rays(prim, eye, lcc, cfg, **kw)
    assert b1.shadow_rays.launches == before + 1
    want = b1.shadow_rays_plain(prim, eye, lcc, cfg, **kw)
    _b1_equal(got, want)
    n = prim["t"].numel()
    assert got.perm.shape == (n,) == (1 << 20,)
    assert int((got.scells < cfg.cell_sentinel).sum()) > n // 2
    # Drawn on the CPU: after the captures that earlier tests of the file
    # make fail on purpose, the card's default generator raised "Offset
    # increment outside graph capture" in a run of the whole file.
    flags = torch.randint(0, 2, (n // 128, 128), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(5)).to(card)
    _bitwise(b1.unpermute(flags, got.perm), b1.unpermute_plain(flags,
                                                               want.perm),
             "unpermute")


def test_window_angles_match_plain_on_card(card, flagship_frame):
    """B1's window launch: every ray's signed angles and the four bounds
    bitwise the plain chain's, NaN where it is."""
    from ugrt_torch.kernels import shadow_bin as b1

    _, eye, lcc, prim, _ = flagship_frame
    (bk, ak), (bp, ap) = (fn(prim, eye, lcc) for fn in (
        b1.window_angles, b1.window_angles_plain))
    for g, w in zip(ak, ap):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        _bitwise(g[ok], w[ok], "angles")
    _bitwise(torch.stack(bk), torch.stack(bp), "bounds")


@pytest.mark.parametrize("mode", B1_MODES)
def test_shadow_rays_edges_on_card(card, mode):
    """B1 on a ragged ray count (1000 x 999 rays, not a multiple of
    128) with NaN and inf t, and on a strip's rays (dist.mesh's columns
    of the Cornell frame): bitwise its plain version."""
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.kernels import shadow_bin as b1
    from ugrt_torch.trace import primary as tprimary

    scene = procedural.cornell_box(subdiv=2)
    v, _, f, _, cc, lcc, _ = _frame_tensors(scene, SMALL, card)
    grid = gbuild.build_perspective_grid(
        v, f, cc, cfg=SMALL, capacity=SMALL.pair_capacity(scene.num_faces))
    strip = tprimary.trace_primary(v, f, cc, grid, SMALL, bx0=5, n_bx=3)
    gen = torch.Generator().manual_seed(7)
    t = torch.rand((1000, 999), generator=gen) * 3
    t.view(-1)[::97] = float("nan")
    t.view(-1)[5::211] = float("inf")
    d = torch.nn.functional.normalize(
        torch.randn((1000, 999, 3), generator=gen), dim=-1)
    ragged = dict(t=t.to(card), ray_dir=d.to(card))
    for prim in (ragged, {k: strip[k].contiguous()
                          for k in ("t", "ray_dir")}):
        kw = _b1_kwargs(mode, prim, cc[0:3], lcc[0], SMALL)
        got = b1.shadow_rays(prim, cc[0:3], lcc[0], SMALL, **kw)
        _b1_equal(got, b1.shadow_rays_plain(prim, cc[0:3], lcc[0], SMALL,
                                            **kw))


@pytest.mark.parametrize("mode", ["reference", "windowed"])
def test_trace_shadow_kernel_equals_plain_on_card(card, flagship_frame,
                                                  mode):
    """trace_shadow on the flagship frame: backend="kernel" (B1 and K3)
    bitwise backend="plain" (their plain versions)."""
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.trace import shadow as tshadow

    t, eye, lcc, prim, cfg = flagship_frame
    cfg = dataclasses.replace(cfg, light_grid_mode=mode)
    kw = _b1_kwargs(mode, prim, eye, lcc, cfg)
    lgrid = gbuild.build_spherical_grid(
        t["vertices"], t["faces"], lcc, cfg=cfg,
        capacity=cfg.pair_capacity(t["faces"].shape[0]), **kw)
    got, want = (tshadow.trace_shadow(
        t["vertices"], t["faces"], lcc, lgrid, prim, eye, cfg,
        backend=backend, **kw) for backend in ("kernel", "plain"))
    assert int(want.sum()) > 1000
    _bitwise(got, want, "shadowed")


@pytest.mark.parametrize("mode", ["windowed", "reference"])
def test_replayed_frame_credits_b1_once_per_light(card, mode):
    """A replayed frame credits each of B1's wrappers once a light (the
    window's in windowed mode only), as K3's are credited."""
    from ugrt_torch import bridge
    from ugrt_torch.api.renderer import render_frame_device
    from ugrt_torch.kernels import shadow_bin as b1

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode=mode)
    v, m, f, mi, cc, _, lp = _frame_tensors(scene, cfg, card)
    lcc = torch.stack([bridge.camcoords_to_torch(s, cfg.fovy_deg, 1.0, card)
                       for s in (LIGHT, SECOND_LIGHT)])
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=2, use_spot=False)
    args = (v, f, mi, m, cc, lcc, lp)
    render_frame_device(*args, **kw)           # warm-up and capture
    wrappers = (b1.shadow_rays, b1.unpermute, b1.window_angles)
    before = [w.launches for w in wrappers]
    for _ in range(3):
        render_frame_device(*args, **kw)
    got = [w.launches - n for w, n in zip(wrappers, before)]
    assert got == [6, 6, 6 if mode == "windowed" else 0]
