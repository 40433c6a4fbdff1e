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
another order on each device (within 1e-5 * max|g|).
"""

import dataclasses

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
    (every item can stop early), at every chunk size: exactly equal to
    the plain version, twice in a row (bitwise repeatable)."""
    from ugrt_torch.kernels import shadow_sweep as k3
    from ugrt_torch.micro.k3_chunks import skewed_case

    args = skewed_case(card, 0, all_occluded)
    want = k3.shadow_sweep_plain(*args, cfg=SMALL)
    assert int(want.sum()) > 1000
    for chunk in (1, 2, 4, 8):
        before = k3.shadow_sweep.launches
        got = [k3.shadow_sweep(*args, cfg=SMALL, chunk=chunk)
               for _ in range(2)]
        assert k3.shadow_sweep.launches == before + 2
        assert torch.equal(got[0], want) and torch.equal(got[1], want)


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
