"""ugrt_torch trace_shadow vs ugrt's trace_shadow, all light-grid modes.

Both packages get ugrt's primary (bridged as numpy), so the shadow pass
is compared on its own.  ugrt runs its XLA backend (bitwise equal to the
Pallas kernels' masks, tests/test_pallas.py); the port runs K3's plain
version on CPU tensors.  Each side derives its own light window /
extents and its own light grid.

Tolerance: none — the masks are exactly equal.  (ugrt's bench allows 16
px between its two backends on its 256^2 parity scene, bench.py:95-98;
no such slack is needed here.)
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.ref import oracle
from ugrt.trace import primary as tprim
from ugrt.trace import shadow as tshadow
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.kernels import _plain as kplain
from ugrt_torch.kernels import shadow_sweep as k3
from ugrt_torch.micro.k3_chunks import (occluder_profile, reference_case,
                                       skewed_case)
from ugrt_torch.trace import shadow as tshadow_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _cc(spec, cfg):
    return cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                   cfg.screen_width / cfg.screen_height)


def _shadow_both(scene, camera, light, cfg, mode, heavy_threshold=None):
    cc, lcc = _cc(camera, cfg), _cc(light, cfg)
    cap = cfg.pair_capacity(scene.num_faces) * (16 if heavy_threshold else 1)
    v, f = jnp.asarray(scene.vertices), jnp.asarray(scene.faces)
    grid = gbuild.build_perspective_grid(v, f, jnp.asarray(cc), cfg=cfg,
                                         capacity=cap)
    prim = tprim.trace_primary(v, f, jnp.asarray(cc), grid, cfg)
    eye_j, lcc_j = jnp.asarray(cc[:3]), jnp.asarray(lcc)
    sc = bridge.scene_to_torch(scene, "cpu")
    cfg_t = bridge.render_config(cfg)
    prim_t = {k: bridge.from_numpy(np.asarray(prim[k]), "cpu")
              for k in ("t", "ray_dir")}
    eye_t = bridge.from_numpy(cc[:3], "cpu")
    lcc_t = bridge.from_numpy(lcc, "cpu")

    kw_j, kw_t = {}, {}
    if mode == "extent":
        x, y = tshadow.light_extents(prim, eye_j, lcc_j, cfg)
        kw_j = dict(x_max=x, y_max=y)
        x, y = tshadow_t.light_extents(prim_t, eye_t, lcc_t, cfg_t)
        kw_t = dict(x_max=x, y_max=y)
    elif mode == "windowed":
        kw_j = dict(window=tshadow.light_window(prim, eye_j, lcc_j, cfg))
        kw_t = dict(window=tshadow_t.light_window(prim_t, eye_t, lcc_t,
                                                  cfg_t))
    hk = {} if heavy_threshold is None else dict(
        heavy_threshold=heavy_threshold)
    lg_j = gbuild.build_spherical_grid(v, f, lcc_j, cfg=cfg, capacity=cap,
                                       **hk, **kw_j)
    lg_t = tbuild.build_spherical_grid(sc["vertices"], sc["faces"], lcc_t,
                                       cfg=cfg_t, capacity=cap, **hk, **kw_t)
    sh_j, _ = tshadow.trace_shadow(v, f, lcc_j, lg_j, prim, eye_j, cfg,
                                   **kw_j)
    sh_t = tshadow_t.trace_shadow(sc["vertices"], sc["faces"], lcc_t, lg_t,
                                  prim_t, eye_t, cfg_t, **kw_t)
    return lg_j, prim, np.asarray(sh_j), bridge.to_numpy(sh_t)


@pytest.mark.parametrize("mode,heavy_threshold",
                         [("reference", None), ("reference", 4),
                          ("extent", None), ("windowed", None),
                          ("windowed", 4)])
def test_trace_shadow_matches_ugrt(small_cfg, cornell, generic_camera,
                                   generic_light, mode, heavy_threshold):
    lg, _, sh_j, sh_t = _shadow_both(cornell, generic_camera, generic_light,
                                     small_cfg, mode, heavy_threshold)
    if heavy_threshold:
        assert int(lg.heavy_count) > 0
    assert sh_t.sum() > 100
    np.testing.assert_array_equal(sh_j, sh_t)


def test_trace_shadow_all_heavy(small_cfg, cornell, generic_camera,
                                generic_light):
    """Threshold 1 moves every face to the heavy list, so all occlusion
    comes from the footprint-box sweep (K3 box=True)."""
    lg, _, sh_j, sh_t = _shadow_both(cornell, generic_camera, generic_light,
                                     small_cfg, "windowed", 1)
    assert int(lg.total_pairs) == 0 and sh_t.sum() > 100
    np.testing.assert_array_equal(sh_j, sh_t)


def test_trace_shadow_multi_slab(cornell, generic_camera, generic_light):
    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8,
                              num_slabs=4)
    _, _, sh_j, sh_t = _shadow_both(cornell, generic_camera, generic_light,
                                    cfg, "reference")
    assert sh_t.sum() > 10
    np.testing.assert_array_equal(sh_j, sh_t)


def test_trace_shadow_matches_oracle(small_cfg, cornell, generic_camera,
                                     generic_light):
    cfg = small_cfg
    _, prim, _, sh_t = _shadow_both(cornell, generic_camera, generic_light,
                                    cfg, "reference")
    lcc = _cc(generic_light, cfg)
    o_prim = {k: np.asarray(v) for k, v in prim.items()}
    sh_o = oracle.trace_shadow(
        cornell, lcc, oracle.build_spherical_grid(cornell, lcc, cfg), o_prim,
        _cc(generic_camera, cfg)[:3], cfg)
    np.testing.assert_array_equal(sh_o, sh_t)


def _window_pairs(w_lo, w_hi, nw):
    """Sorted (block, window) pairs of the clamped inclusive ranges."""
    return sorted((b, w) for b, (lo, hi) in enumerate(zip(w_lo.tolist(),
                                                          w_hi.tolist()))
                  for w in range(max(lo, 0), min(hi, nw - 1) + 1))


def _assert_chunks_cover(w_lo, w_hi, nw, chunk):
    """K3's work items cover each block's window range exactly once, in
    pieces of 1 to ``chunk`` windows."""
    item_end = kplain.chunk_item_end(w_lo, w_hi, nw, chunk)
    assert item_end.dtype == torch.int32
    blk, w0, w1 = kplain.chunk_windows(item_end, w_lo, w_hi, nw, chunk)
    n = w1 - w0 + 1
    assert bool(((n >= 1) & (n <= chunk)).all())
    got = sorted((b, w) for b, a, z in zip(blk.tolist(), w0.tolist(),
                                           w1.tolist())
                 for w in range(a, z + 1))
    assert got == _window_pairs(w_lo, w_hi, nw)


# K3's work list at chunk sizes 1, 2 and 4 (in place of the sizes
# trace_shadow picks per site), at its cell-key site
# (reference light grid, also against the oracle) and at its footprint
# box site (every face heavy): the chunked sweep's masks still equal
# ugrt's, and the recorded ranges are covered once.
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("site", ["key", "box"])
def test_trace_shadow_chunked(monkeypatch, small_cfg, cornell, generic_camera,
                              generic_light, size, site):
    calls = []

    def sweep(tri, rays, w_lo, w_hi, *, cfg, box=False, chunk=None,
              serial=False):
        # The reference grid's key site takes the serial walk, with items
        # of a block's whole range; the others the block walk.
        assert serial == (site == "key" and not box)
        assert chunk == (tshadow_t.HCHUNK if box else tshadow_t.SERIAL_CHUNK
                         if serial else tshadow_t.SCHUNK)
        calls.append((box, tri.shape[0], w_lo, w_hi))
        return k3.shadow_sweep(tri, rays, w_lo, w_hi, cfg=cfg, box=box,
                               chunk=size, serial=serial)

    monkeypatch.setattr(tshadow_t, "shadow_sweep", sweep)
    mode, threshold = ("reference", None) if site == "key" else (
        "windowed", 1)
    lg, prim, sh_j, sh_t = _shadow_both(cornell, generic_camera,
                                        generic_light, small_cfg, mode,
                                        threshold)
    assert sh_t.sum() > 100
    np.testing.assert_array_equal(sh_j, sh_t)
    # The site ran; at the key site some block walks two windows or more
    # (split at chunk 1; the skewed test splits at every chunk size).
    walked = [c for c in calls if c[0] == (site == "box")]
    assert walked
    if site == "key":
        assert any(int((hi - lo).max()) >= 1 for _, _, lo, hi in walked)
    for _, nw, w_lo, w_hi in calls:
        _assert_chunks_cover(w_lo, w_hi, nw, size)
    if site == "key":
        lcc = _cc(generic_light, small_cfg)
        sh_o = oracle.trace_shadow(
            cornell, lcc, oracle.build_spherical_grid(cornell, lcc,
                                                      small_cfg),
            {k: np.asarray(v) for k, v in prim.items()},
            _cc(generic_camera, small_cfg)[:3], small_cfg)
        np.testing.assert_array_equal(sh_o, sh_t)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_shadow_sweep_skewed(chunk):
    """One ray block whose sparse cells span all 300 windows, beside
    blocks with empty ranges and one whose range runs past the end: the
    chunked sweep equals every live block walking every window (the
    cell-key test rejects the rows of other cells), and in the
    all-occluded twin every ray with a cell is flagged."""
    cfg = bridge.render_config(RenderConfig())
    for occluded in (False, True):
        tri, rays, w_lo, w_hi = skewed_case("cpu", 0, occluded)
        nw = tri.shape[0]
        assert int((w_hi - w_lo).max()) >= 200 and bool((w_hi < w_lo).any())
        _assert_chunks_cover(w_lo, w_hi, nw, chunk)
        got = k3.shadow_sweep(tri, rays, w_lo, w_hi, cfg=cfg, chunk=chunk)
        live = rays[:, 0, 4] >= 0
        every = k3.shadow_sweep_plain(
            tri, rays, torch.zeros_like(w_lo),
            torch.where(live, nw - 1, -1).to(torch.int32), cfg=cfg,
            chunk=nw)
        assert torch.equal(got, every)
        real = rays[:, :, 4] >= 0
        if occluded:
            assert bool(got[real].all()) and not bool(got[~real].any())
        else:
            assert 0.2 < float(got[real].float().mean()) < 0.8


# ugrt's backend= argument (shadow.py:250-256) with the port's values:
# "plain" bitwise the default on CPU tensors at both of K3's sites (a
# heavy list, windowed; the default through the wrapper, "plain"
# past it), "kernel" on CPU tensors and an unknown name raise.
@pytest.mark.parametrize("backend", ["plain", "kernel", "unknown"])
def test_trace_shadow_backend(small_cfg, cornell, generic_camera,
                              generic_light, backend, monkeypatch):
    calls, wrapped = [], []
    plain, check = k3.shadow_sweep.plain, k3.shadow_sweep.check

    def counted(*args, **kwargs):
        calls.append(kwargs.get("box", False))
        return plain(*args, **kwargs)

    def checked(*args, **kwargs):
        wrapped.append(kwargs.get("box", False))
        return check(*args, **kwargs)

    monkeypatch.setattr(k3.shadow_sweep, "plain", counted)
    monkeypatch.setattr(k3.shadow_sweep, "check", checked)
    if backend != "plain":
        monkeypatch.setattr(tshadow_t, "trace_shadow", functools.partial(
            tshadow_t.trace_shadow, backend=backend))
        match = "CUDA tensors" if backend == "kernel" else "unknown"
        with pytest.raises(ValueError, match=match):
            _shadow_both(cornell, generic_camera, generic_light, small_cfg,
                         "windowed", 4)
        assert not calls and not wrapped
        return
    lg, _, sh_j, want = _shadow_both(cornell, generic_camera, generic_light,
                                     small_cfg, "windowed", 4)
    # The default: the wrapper, whose CPU route is the plain version.
    assert calls == wrapped and sorted(set(calls)) == [False, True]
    calls.clear()
    wrapped.clear()
    monkeypatch.setattr(tshadow_t, "trace_shadow", functools.partial(
        tshadow_t.trace_shadow, backend="plain"))
    _, _, _, got = _shadow_both(cornell, generic_camera, generic_light,
                                small_cfg, "windowed", 4)
    assert not wrapped and sorted(set(calls)) == [False, True]
    assert int(lg.heavy_count) > 0 and want.sum() > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sh_j, want)


@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_shadow_sweep_reference_like(chunk):
    """K3's reference-like case (a few cells of long ranges, most rays
    occluded at random rows of their range, some never, blocks that
    straddle two cells): the chunked sweep equals the sweep of one item a
    window and of one item a block, in either walk (``serial`` changes
    only the kernel's order of tests)."""
    cfg = bridge.render_config(RenderConfig())
    tri, rays, w_lo, w_hi = reference_case("cpu", 0)
    nw = tri.shape[0]
    _assert_chunks_cover(w_lo, w_hi, nw, chunk)
    live = rays[:, :, 4] >= 0
    straddle = live[:, 0] & live[:, -1] & (rays[:, 0, 4] != rays[:, -1, 4])
    assert bool(straddle.any()) and int((w_hi - w_lo).max()) >= 4
    want = k3.shadow_sweep_plain(tri, rays, w_lo, w_hi, cfg=cfg, chunk=1)
    for serial in (False, True):
        got = k3.shadow_sweep(tri, rays, w_lo, w_hi, cfg=cfg, chunk=chunk,
                              serial=serial)
        assert torch.equal(got, want)
    assert torch.equal(k3.shadow_sweep_plain(tri, rays, w_lo, w_hi, cfg=cfg,
                                             chunk=nw), want)
    occluded = int(want.sum())
    assert 0.6 * int(live.sum()) < occluded < int(live.sum())
    assert not bool(want[~live].any())


def test_occluder_profile_matches_a_walk():
    """``k3_chunks.occluder_profile`` on the reference-like case equals a
    walk of each block's range ray by ray: the shadowed and never
    occluded rays, the admitted tests, the tests up to each ray's first
    occluder, the tests the OR needs, its row and rank there, and how often a shadowed ray is
    occluded in the 32-row group that first occluded the ray before it in
    its warp."""
    cfg = bridge.render_config(RenderConfig())
    tri, rays, w_lo, w_hi = reference_case("cpu", 0)
    prof = occluder_profile(tri, rays, w_lo, w_hi, cfg)
    nw, win = tri.shape[0], tri.shape[1]
    shadowed = never = admitted = stop = needed = 0
    rows, ranks, same = [], [], [0, 0]
    for b in range(rays.shape[0]):
        lo, hi = max(int(w_lo[b]), 0), min(int(w_hi[b]), nw - 1)
        live = rays[b, :, 4] >= 0
        if hi < lo:
            never += int(live.sum())
            continue
        t = tri[lo:hi + 1].reshape(1, -1, 16)
        occ = k3.occludes(rays[b][None], t, cfg=cfg)[0]      # [128, rows]
        adm = t[0, :, 10][None] == rays[b, :, 4, None]
        first = torch.where(occ, torch.arange(occ.shape[1]),
                            occ.shape[1]).amin(dim=1)
        for i in range(128):
            if not live[i]:
                continue
            admitted += int(adm[i].sum())
            if first[i] == occ.shape[1]:
                never += 1
                stop += int(adm[i].sum())
                needed += int(adm[i].sum())
                continue
            f = int(first[i])
            shadowed += 1
            needed += 1
            rows.append(f)
            ranks.append(int(adm[i, :f].sum()))
            stop += ranks[-1] + 1
            if i % 32 and live[i - 1] and first[i - 1] < occ.shape[1]:
                g = int(first[i - 1]) // 32
                same[1] += 1
                same[0] += int(occ[i, 32 * g:32 * g + 32].any())
    assert (prof["shadowed"], prof["never_occluded"],
            prof["admitted_tests"], prof["stop_at_first_tests"],
            prof["needed_tests"]) == (shadowed, never, admitted, stop,
                                      needed)
    assert prof["same_group_as_previous_lane"] == same
    q = torch.tensor(rows, dtype=torch.float64)
    r = torch.tensor(ranks, dtype=torch.float64)
    for pct in (10, 50, 90):
        assert prof["first_occluder_walk_row"][pct] == round(
            float(torch.quantile(q, pct / 100)), 3)
        assert prof["first_occluder_admitted_rank"][pct] == round(
            float(torch.quantile(r, pct / 100)), 3)
