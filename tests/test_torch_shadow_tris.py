"""B2 (ugrt_torch/kernels/shadow_tris), the triangle side of the shadow
pass: K3's rows of the light grid's pairs and heavy list, and each ray
block's window ranges at both of K3's sites.

On the CPU: ``trace_shadow`` through B2's plain version (the route CPU
tensors and ``backend="plain"`` take) gives the flags of the torch chain
it replaced, run here as that chain ran inside ``trace_shadow`` (rows,
then per slab the key site's ranges and sweep, then the heavy side), in
every light-grid mode, with heavy lists, all faces heavy and four slabs;
the plain version's fields are those functions' outputs; CPU tensors
take the plain version and count no launch; wrong inputs raise.

On the card (marked ``cuda``, skipped without one): B2's three outputs
(the key rows, the heavy rows, every range) bitwise the plain version on
the reference, windowed and extent light grids, with a heavy list that
is empty, partly live and full, with one and four slabs, padding pairs
and a pair capacity that is not a multiple of 256, on the Cornell frame
and on the flagship frame; each replay of a frame, reflective frame and
step credits B2 once a light.  The file imports no JAX and nothing of
ugrt:

    python -m pytest --noconftest -m cuda tests/test_torch_shadow_tris.py

Tolerance: none (the outputs are bit for bit the plain version's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ugrt_torch import bridge
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.grid import build as gbuild
from ugrt_torch.kernels import shadow_bin as b1
from ugrt_torch.kernels import shadow_tris as b2
from ugrt_torch.kernels.shadow_sweep import shadow_sweep
from ugrt_torch.scene import procedural
from ugrt_torch.trace import heavy as theavy
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import shadow as tshadow
from ugrt_torch.trace import windows as tw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dataclasses.replace(RenderConfig(), screen_width=128,
                            screen_height=128, grid_x=16, grid_y=16)
SLABS = dataclasses.replace(RenderConfig(), screen_width=64,
                            screen_height=64, grid_x=8, grid_y=8,
                            num_slabs=4)
CAMERA = CameraSpec(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                    up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
LIGHT = CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                   up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
SECOND_LIGHT = CameraSpec(eye=(-0.6, 0.5, 0.9), look_at=(0.2, -1.0, 0.0),
                          up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
MODES = ["reference", "extent", "windowed"]
# name -> (config changes, heavy threshold or None for the config's):
# the Cornell box's 64 faces cover fewer than 256 cells each, so the
# default threshold leaves the heavy list empty; 4 makes some faces
# heavy; 1 makes every face heavy, and a capacity of 48 leaves the list
# full (16 heavy faces do not fit).
HEAVY = {
    "empty": ({}, None),
    "partly live": ({}, 4),
    "full": (dict(heavy_capacity=48), 1),
}


def _frame(cfg, mode, device, heavy="empty"):
    """(vertices, faces, light camcoords, light grid, B1's rays, cfg,
    primary rays, eye, the mode's window or extents) of the Cornell frame
    in light-grid ``mode`` with heavy list ``heavy``."""
    changes, threshold = HEAVY[heavy]
    cfg = dataclasses.replace(cfg, light_grid_mode=mode, **changes)
    if threshold is not None:
        cfg = dataclasses.replace(cfg, heavy_threshold=threshold)
    scene = procedural.cornell_box(subdiv=2)
    t = bridge.scene_to_torch(scene, device)
    v, f = t["vertices"], t["faces"]
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, device)
    lcc = bridge.camcoords_to_torch(LIGHT, cfg.fovy_deg, 1.0, device)
    cap = cfg.pair_capacity(scene.num_faces)
    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    prim = tprimary.trace_primary(v, f, cc, grid, cfg)
    prim = {k: prim[k].contiguous() for k in ("t", "ray_dir")}
    kw = {}
    if mode == "windowed":
        kw = dict(window=tshadow.light_window(prim, cc[0:3], lcc, cfg))
    elif mode == "extent":
        x, y = tshadow.light_extents(prim, cc[0:3], lcc, cfg)
        kw = dict(x_max=x, y_max=y)
    lgrid = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap,
                                        **kw)
    rays = b1.shadow_rays(prim, cc[0:3], lcc, cfg, **kw)
    return v, f, lcc, lgrid, rays, cfg, prim, cc[0:3], kw


def _parent_trace_shadow(vertices, faces, lcc, lgrid, prim, eye, cfg, kw):
    """trace_shadow as it ran before B2: the torch chain between B1 and
    K3, in its order (K3's plain version sweeps)."""
    H, W = prim["t"].shape
    rays = b1.shadow_rays_plain(prim, eye, lcc, cfg, **kw)
    rows = rays.rows
    NS, sentinel = cfg.num_slabs, cfg.cell_sentinel
    live = rays.last_real >= 0
    k1 = torch.clamp(rays.first_cell, 0, sentinel - 1).long() * NS
    k2 = torch.clamp(rays.last_real, 0, sentinel - 1).long() * NS
    tri_w = tw.pack_tri_windows_coeff(vertices, faces, lgrid, lcc[0:3],
                                      win=b2.SWIN)
    serial = "window" not in kw
    nb = rows.shape[0]
    flags = torch.zeros((nb, 128), dtype=torch.int32)
    for slab in range(NS):
        if slab:
            blk = rays.scells.reshape(nb, 128)
            rows[:, :, 4] = torch.where(blk < sentinel,
                                        (blk * NS + slab).float(), -1.0)
        lo = torch.where(live, lgrid.cell_offset[k1 + slab], 0)
        hi = torch.where(live, lgrid.cell_offset[k2 + slab]
                         + lgrid.cell_count[k2 + slab], 0)
        w_lo, w_hi = tw.window_span(lo, hi, b2.SWIN)
        flags |= shadow_sweep.plain(
            tri_w, rows, w_lo, w_hi, cfg=cfg, serial=serial,
            chunk=tshadow.SERIAL_CHUNK if serial else tshadow.SCHUNK)
    if lgrid.heavy_faces.shape[0] > 0:
        co = tw.spatial_reorder_heavy(theavy.heavy_coeffs(
            vertices, faces, lgrid.heavy_faces, lgrid.heavy_count, lcc[0:3],
            lgrid.heavy_ranges))
        hlo, hhi = tw.heavy_block_window_range(
            rays.first_cell, rays.last_real, cfg.grid_y,
            tw.heavy_window_rects(co, b2.HWIN))
        flags |= shadow_sweep.plain(
            tw.pack_heavy_coeff_windows(co, win=b2.HWIN), rows, hlo, hhi,
            cfg=cfg, box=True, chunk=tshadow.HCHUNK)
    return b1.unpermute_plain(flags, rays.perm).reshape(H, W)


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _equal(got, want):
    """Every field of two ShadowTris bit for bit: the names that differ."""
    return [name for name, g, w in zip(want._fields, got, want)
            if g.shape != w.shape or g.dtype != w.dtype
            or not torch.equal(_bits(g.cpu()), _bits(w.cpu()))]


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("mode,heavy,cfg", [
    ("reference", "empty", SMALL), ("reference", "partly live", SMALL),
    ("extent", "partly live", SMALL), ("windowed", "empty", SMALL),
    ("windowed", "full", SMALL), ("reference", "empty", SLABS)],
    ids=["reference", "reference-heavy", "extent-heavy", "windowed",
         "windowed-all-heavy", "four-slabs"])
def test_trace_shadow_equals_the_torch_chain(mode, heavy, cfg, backend):
    """trace_shadow through B2's plain route: the flags of the torch
    chain B2 replaced, bit for bit."""
    v, f, lcc, lgrid, _, cfg, prim, eye, kw = _frame(cfg, mode, "cpu",
                                                     heavy)
    got = tshadow.trace_shadow(v, f, lcc, lgrid, prim, eye, cfg, **kw,
                               backend=backend)
    want = _parent_trace_shadow(v, f, lcc, lgrid, prim, eye, cfg, kw)
    assert int(want.sum()) > 10
    if heavy != "empty":
        assert int(lgrid.heavy_count) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("heavy", sorted(HEAVY))
def test_plain_version_fields(heavy):
    """The plain version's rows and ranges are the trace.windows /
    trace.heavy functions' outputs, in K3's shapes: every slab's key
    ranges at once, a capacity padded to whole windows, and no heavy
    rows with empty ranges for a grid without a heavy list."""
    v, f, lcc, lgrid, rays, cfg, *_ = _frame(SMALL, "reference", "cpu",
                                             heavy)
    got = b2.shadow_tris_plain(v, f, lgrid, lcc, rays.first_cell,
                               rays.last_real, cfg)
    nb = rays.first_cell.shape[0]
    cap = lgrid.sorted_faces.shape[0]
    assert got.tri_w.shape == (-(-cap // 256), 256, 16)
    assert torch.equal(got.tri_w, tw.pack_tri_windows_coeff(
        v, f, lgrid, lcc[0:3], win=256))
    assert got.w_lo.shape == got.w_hi.shape == (1, nb)
    assert got.w_lo.dtype == got.hlo.dtype == torch.int32
    h = lgrid.heavy_faces.shape[0]
    assert got.tri_hw.shape == (-(-h // 128), 128, 16)
    assert got.hlo.shape == got.hhi.shape == (nb,)
    # Threshold 1 leaves no face in the pairs, so no key range.
    key_ranges = int((got.w_lo <= got.w_hi).sum())
    assert key_ranges == 0 if heavy == "full" else key_ranges > 0
    if heavy == "empty":
        assert int(lgrid.heavy_count) == 0 and (got.hlo > got.hhi).all()
    else:
        assert int((got.hlo <= got.hhi).sum()) > 0
    # Four slabs: no heavy list (multi-slab grids keep every face in the
    # pairs), one key range a slab.
    v, f, lcc, lgrid, rays, cfg, *_ = _frame(SLABS, "reference", "cpu")
    got = b2.shadow_tris_plain(v, f, lgrid, lcc, rays.first_cell,
                               rays.last_real, cfg)
    nb = rays.first_cell.shape[0]
    assert got.w_lo.shape == (4, nb) and got.tri_hw.shape == (0, 128, 16)
    assert (got.hlo == 0).all() and (got.hhi == -1).all()


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors B2 returns its plain version's result and launches
    nothing; wrong inputs raise."""
    v, f, lcc, lgrid, rays, cfg, *_ = _frame(SMALL, "windowed", "cpu",
                                             "partly live")
    args = (v, f, lgrid, lcc, rays.first_cell, rays.last_real, cfg)
    before = b2.shadow_tris.launches
    assert _equal(b2.shadow_tris(*args), b2.shadow_tris_plain(*args)) == []
    assert b2.shadow_tris.launches == before
    with pytest.raises(TypeError, match="faces"):
        b2.shadow_tris(v, f.long(), *args[2:])
    with pytest.raises(ValueError, match="cell_offset"):
        b2.shadow_tris(*args[:-1], dataclasses.replace(cfg, num_slabs=2))
    with pytest.raises(ValueError, match="last_real"):
        b2.shadow_tris(*args[:5], rays.last_real[:-1], cfg)


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("heavy", sorted(HEAVY))
@pytest.mark.parametrize("mode", MODES)
def test_shadow_tris_matches_plain_on_card(card, mode, heavy):
    """B2 on the Cornell frame: the key rows (padding pairs included),
    the heavy rows and every range bitwise its plain version, with a
    heavy list that is empty, partly live or full."""
    v, f, lcc, lgrid, rays, cfg, *_ = _frame(SMALL, mode, card, heavy)
    args = (v, f, lgrid, lcc, rays.first_cell, rays.last_real, cfg)
    before = b2.shadow_tris.launches
    got = b2.shadow_tris(*args)
    assert b2.shadow_tris.launches == before + 1
    want = b2.shadow_tris_plain(*args)
    assert _equal(got, want) == []
    assert int((lgrid.sorted_faces < 0).sum()) > 0        # padding pairs
    live = int(lgrid.heavy_count)
    if heavy == "empty":
        assert live == 0
    elif heavy == "full":
        assert live == lgrid.heavy_faces.shape[0] == 48
    else:
        assert 0 < live < lgrid.heavy_faces.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["four slabs", "ragged capacity"])
def test_shadow_tris_edges_on_card(card, case):
    """Four slabs (every slab's key ranges, no heavy list) and a pair
    capacity that is not a multiple of 256 (16,400 pairs: the last
    window's rows past it are padding) with a heavy list, bitwise the
    plain version."""
    if case == "four slabs":
        v, f, lcc, lgrid, rays, cfg, *_ = _frame(SLABS, "reference", card)
        assert lgrid.heavy_faces.shape[0] == 0
    else:
        cfg = dataclasses.replace(SMALL, tri_batch=100)
        v, f, lcc, lgrid, rays, cfg, *_ = _frame(cfg, "reference", card,
                                                 "partly live")
        assert lgrid.sorted_faces.shape[0] % 256
    args = (v, f, lgrid, lcc, rays.first_cell, rays.last_real, cfg)
    assert _equal(b2.shadow_tris(*args), b2.shadow_tris_plain(*args)) == []


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_shadow_tris_flagship_on_card(card, mode):
    """B2 on the flagship frame (the 75k-face cathedral at 1024^2, bench's
    camera and light, 590,592 pair slots, 2,048 heavy slots): bitwise its
    plain version in every light-grid mode."""
    from ugrt_torch.bench import CAMERA as FCAM
    from ugrt_torch.bench import LIGHT as FLIGHT

    cfg = dataclasses.replace(RenderConfig(), heavy_capacity=2048,
                              light_grid_mode=mode)
    scene = procedural.cathedral(num_faces_target=75000)
    t = bridge.scene_to_torch(scene, card)
    v, f = t["vertices"], t["faces"]
    cc = bridge.camcoords_to_torch(FCAM, cfg.fovy_deg, 1.0, card)
    lcc = bridge.camcoords_to_torch(FLIGHT, cfg.fovy_deg, 1.0, card)
    cap = cfg.pair_capacity(scene.num_faces)
    grid = gbuild.build_perspective_grid(v, f, cc, cfg=cfg, capacity=cap)
    prim = tprimary.trace_primary(v, f, cc, grid, cfg)
    prim = {k: prim[k].contiguous() for k in ("t", "ray_dir")}
    kw = {}
    if mode == "windowed":
        kw = dict(window=tshadow.light_window(prim, cc[0:3], lcc, cfg))
    elif mode == "extent":
        x, y = tshadow.light_extents(prim, cc[0:3], lcc, cfg)
        kw = dict(x_max=x, y_max=y)
    lgrid = gbuild.build_spherical_grid(v, f, lcc, cfg=cfg, capacity=cap,
                                        **kw)
    rays = b1.shadow_rays(prim, cc[0:3], lcc, cfg, **kw)
    args = (v, f, lgrid, lcc, rays.first_cell, rays.last_real, cfg)
    got, want = b2.shadow_tris(*args), b2.shadow_tris_plain(*args)
    assert _equal(got, want) == []
    assert got.tri_w.shape == (2307, 256, 16)
    assert got.tri_hw.shape == (16, 128, 16) and int(lgrid.heavy_count) > 0
    assert int((want.w_lo <= want.w_hi).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["frame", "reflective frame", "step"])
def test_replays_credit_b2_once_per_light(card, path):
    """A replay of the frame (two lights), the reflective frame and the
    step credits B2 once a light, as B1 and K3 are credited."""
    from ugrt_torch.api.renderer import (render_frame_device,
                                         render_frame_reflective)
    from ugrt_torch.diff.render_grad import render_and_grad

    scene = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(SMALL, light_grid_mode="windowed")
    t = bridge.scene_to_torch(scene, card)
    cc = bridge.camcoords_to_torch(CAMERA, cfg.fovy_deg, 1.0, card)
    lights = [LIGHT, SECOND_LIGHT] if path == "frame" else [LIGHT]
    lcc = torch.stack([bridge.camcoords_to_torch(s, cfg.fovy_deg, 1.0, card)
                       for s in lights])
    lp = bridge.from_numpy(LIGHT.eye, card, np.float32)
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
              num_lights=len(lights), use_spot=False)
    if path == "step":
        target = torch.zeros((cfg.screen_height, cfg.screen_width, 3),
                             device=card)
        program = render_and_grad

        def call():
            return render_and_grad(t["vertices"], t["materials"], t["faces"],
                                   t["mat_index"], cc, lcc, lp, target, **kw)
    else:
        program = (render_frame_device if path == "frame"
                   else render_frame_reflective)

        def call():
            return program(t["vertices"], t["faces"], t["mat_index"],
                           t["materials"], cc, lcc, lp, **kw)
    program.clear()
    try:
        call()                                  # warm-up and capture
        before = b2.shadow_tris.launches
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        assert b2.shadow_tris.launches - before == 3 * len(lights)
    finally:
        program.clear()
