"""B1 (ugrt_torch/kernels/shadow_bin) against ugrt's shadow ray side.

ugrt sorts its shadow rays inside trace_shadow (ugrt/trace/shadow.py's
Pallas branch): the light cells of grid/binning.py, a stable
jax.lax.sort with the hit point as payload, the rows [NB, 128, 8], each
block's first and last real cell, and _unpermute.  ``_ugrt_rays`` runs
those same steps with ugrt's functions on ugrt's primary, and B1's plain
version (the one CPU tensors take) must give the same keys, permutation,
rows, block bounds and flags, bit for bit, in all three light-grid
modes: on a whole frame, on a ray count that is not a multiple of 128
with NaN and inf hit distances, and on a strip's columns (dist.mesh).
Each side gets the same window or extents (ugrt's, bridged).

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them to this plain version there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.core import camera as cam
from ugrt.core.vecmath import dot, normalize
from ugrt.grid import binning as binning_j
from ugrt.grid import build as gbuild
from ugrt.trace import primary as tprim
from ugrt.trace import shadow as tshadow
from ugrt_torch import bridge
from ugrt_torch.kernels import shadow_bin as b1
from ugrt_torch.trace import shadow as tshadow_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ["reference", "extent", "windowed"]
CASES = ["frame", "ragged", "strip"]


def _cc(spec, cfg):
    return cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                   cfg.screen_width / cfg.screen_height)


@functools.lru_cache(maxsize=None)
def _primary(cfg, scene_key, camera, light):
    from ugrt.scene import procedural
    scene = procedural.cornell_box(subdiv=2)
    cc, lcc = _cc(camera, cfg), _cc(light, cfg)
    v, f = jnp.asarray(scene.vertices), jnp.asarray(scene.faces)
    grid = gbuild.build_perspective_grid(
        v, f, jnp.asarray(cc), cfg=cfg,
        capacity=cfg.pair_capacity(scene.num_faces))
    prim = tprim.trace_primary(v, f, jnp.asarray(cc), grid, cfg)
    return ({k: np.asarray(prim[k]) for k in ("t", "ray_dir")},
            cc.astype(np.float32), lcc.astype(np.float32))


def _rays(small_cfg, camera, light, case):
    """(primary numpy arrays, camcoords, light camcoords) of the case."""
    prim, cc, lcc = _primary(small_cfg, "cornell", camera, light)
    if case == "ragged":
        prim = {k: np.ascontiguousarray(a[:99, :37]) for k, a in
                prim.items()}
        prim["t"].reshape(-1)[::13] = np.nan
        prim["t"].reshape(-1)[4::29] = np.inf
    elif case == "strip":           # tile columns [5, 8) of 8-wide tiles
        prim = {k: np.ascontiguousarray(a[:, 40:64]) for k, a in
                prim.items()}
    return prim, cc, lcc


def _mode_args(mode, prim, eye, lcc, cfg):
    """ugrt's window or extents of these rays (jnp), or {}."""
    pj = {k: jnp.asarray(a) for k, a in prim.items()}
    if mode == "extent":
        x, y = tshadow.light_extents(pj, jnp.asarray(eye), jnp.asarray(lcc),
                                     cfg)
        return dict(x_max=x, y_max=y)
    if mode == "windowed":
        return dict(window=tshadow.light_window(pj, jnp.asarray(eye),
                                                jnp.asarray(lcc), cfg))
    return {}


def _ugrt_rays(prim, eye, lcc, cfg, kw):
    """ugrt's trace_shadow steps before its sweep (Pallas branch):
    (cells sorted and padded, ray ids, rows [NB, 128, 8], first_cell,
    last_real), numpy."""
    n = prim["t"].size
    L = jnp.asarray(lcc[0:3])
    pts = (jnp.asarray(eye)[None] + jnp.asarray(prim["t"]).reshape(n)[:, None]
           * jnp.asarray(prim["ray_dir"]).reshape(n, 3))
    if "window" in kw:
        cells = binning_j.ray_light_cells_windowed(
            pts, jnp.asarray(lcc), cfg.grid_x, cfg.grid_y, kw["window"],
            xp=jnp)
    else:
        cells = binning_j.ray_light_cells(
            pts, jnp.asarray(lcc), cfg.grid_x, cfg.grid_y,
            kw.get("x_max", cfg.angular_extent),
            kw.get("y_max", cfg.angular_extent),
            cfg.quirks.y_forward_dot_typo, xp=jnp)
    sentinel = cfg.cell_sentinel
    ids = jnp.arange(n, dtype=jnp.int32)
    scells, sray, spx, spy, spz = jax.lax.sort(
        (cells.reshape(n), ids, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=1)
    n_pad = -(-n // 128) * 128
    nb = n_pad // 128
    scells = jnp.pad(scells, (0, n_pad - n), constant_values=sentinel)
    delta = jnp.stack([spx, spy, spz], axis=1) - L[None]
    dist_pt = jnp.pad(jnp.sqrt(dot(delta, delta)), (0, n_pad - n))
    dirs = jnp.pad(normalize(delta, xp=jnp), ((0, n_pad - n), (0, 0)))
    blk = scells.reshape(nb, 128)
    key = jnp.where(blk < sentinel, (blk * cfg.num_slabs).astype(jnp.float32),
                    -1.0)
    rows = jnp.concatenate(
        [dirs.reshape(nb, 128, 3), dist_pt.reshape(nb, 128, 1),
         key[..., None], (blk // cfg.grid_y).astype(jnp.float32)[..., None],
         (blk % cfg.grid_y).astype(jnp.float32)[..., None],
         jnp.zeros((nb, 128, 1), jnp.float32)], axis=2)
    last = jnp.max(jnp.where(blk < sentinel, blk, -1), axis=1)
    return tuple(np.asarray(a) for a in (scells, sray, rows, blk[:, 0],
                                         last))


def _port_args(prim, cc, lcc, kw):
    pt = {k: bridge.from_numpy(a, "cpu") for k, a in prim.items()}
    kt = {k: (tuple(bridge.from_numpy(np.asarray(x), "cpu") for x in v)
              if k == "window" else bridge.from_numpy(np.asarray(v), "cpu"))
          for k, v in kw.items()}
    return pt, bridge.from_numpy(cc[0:3], "cpu"), bridge.from_numpy(lcc,
                                                                    "cpu"), kt


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_shadow_rays_match_ugrt(small_cfg, generic_camera, generic_light,
                                mode, case):
    prim, cc, lcc = _rays(small_cfg, generic_camera, generic_light, case)
    kw = _mode_args(mode, prim, cc[0:3], lcc, small_cfg)
    want = _ugrt_rays(prim, cc[0:3], lcc, small_cfg, kw)
    pt, eye_t, lcc_t, kt = _port_args(prim, cc, lcc, kw)
    cfg_t = bridge.render_config(small_cfg)
    got = b1.shadow_rays_plain(pt, eye_t, lcc_t, cfg_t, **kt)
    n = prim["t"].size
    assert got.perm.dtype == torch.int32 and got.perm.shape == (n,)
    for name, g, w in zip(("scells", "perm", "rows", "first_cell",
                           "last_real"),
                          (got.scells, got.perm, got.rows, got.first_cell,
                           got.last_real), want):
        np.testing.assert_array_equal(_bits(bridge.to_numpy(g)), _bits(w),
                                      err_msg=name)
    live = int((want[0] < small_cfg.cell_sentinel).sum())
    assert live > n // 4
    if case == "ragged":
        assert n % 128 and np.isnan(got.rows.numpy()).any()
    if mode == "windowed":
        # The window launch's angles give the same rays.
        _, angles = b1.window_angles_plain(pt, eye_t, lcc_t)
        again = b1.shadow_rays_plain(pt, eye_t, lcc_t, cfg_t, **kt,
                                     angles=angles)
        for g, w in zip(again, got):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))


@pytest.mark.parametrize("case", CASES)
def test_unpermute_matches_ugrt(small_cfg, generic_camera, generic_light,
                                case):
    """The sorted blocks' flags back in pixel order: ugrt's _unpermute (a
    sort by ray id) and B1's plain scatter agree, pad slots dropped."""
    prim, cc, lcc = _rays(small_cfg, generic_camera, generic_light, case)
    pt, eye_t, lcc_t, _ = _port_args(prim, cc, lcc, {})
    rays = b1.shadow_rays_plain(pt, eye_t, lcc_t,
                                bridge.render_config(small_cfg))
    n = rays.perm.numel()
    flags = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, rays.rows.shape[:2], dtype=np.int32))
    want = np.asarray(tshadow._unpermute(
        jnp.asarray(flags.numpy().reshape(-1)[:n]),
        jnp.asarray(rays.perm.numpy())))
    got = b1.unpermute_plain(flags, rays.perm)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(b1.unpermute(flags, rays.perm), got)


def test_window_angles_bounds_are_ugrts_window(small_cfg, generic_camera,
                                               generic_light):
    """window_angles' bounds with the margin are ugrt's light_window,
    within 8 ulp as test_torch_grid's test_light_window_close holds it;
    its angles are binning.signed_xy_coords' of the hit points."""
    prim, cc, lcc = _rays(small_cfg, generic_camera, generic_light, "frame")
    pt, eye_t, lcc_t, _ = _port_args(prim, cc, lcc, {})
    bounds, (sx, sy) = b1.window_angles(pt, eye_t, lcc_t)
    got = np.asarray([float(x) for x in
                      tshadow_t.apply_window_margin(*bounds)], np.float32)
    want = np.asarray([float(x) for x in tshadow.light_window(
        {k: jnp.asarray(a) for k, a in prim.items()}, jnp.asarray(cc[0:3]),
        jnp.asarray(lcc), small_cfg)], np.float32)
    assert (np.abs(got - want) <= 8 * np.spacing(np.abs(want))).all()
    ok = ~torch.isnan(sx)
    assert float(bounds[0]) == float(sx[ok].min())
    assert float(bounds[1]) == float(sx[ok].max())
    assert float(bounds[2]) == float(sy[~torch.isnan(sy)].min())
    assert float(bounds[3]) == float(sy[~torch.isnan(sy)].max())


def test_cpu_tensors_take_the_plain_versions(small_cfg, generic_camera,
                                             generic_light):
    """On CPU tensors each B1 wrapper returns its plain version's result
    and launches nothing; wrong inputs raise."""
    prim, cc, lcc = _rays(small_cfg, generic_camera, generic_light, "ragged")
    kw = _mode_args("windowed", prim, cc[0:3], lcc, small_cfg)
    pt, eye_t, lcc_t, kt = _port_args(prim, cc, lcc, kw)
    cfg_t = bridge.render_config(small_cfg)
    wrappers = (b1.shadow_rays, b1.unpermute, b1.window_angles)
    before = [w.launches for w in wrappers]
    for g, w in zip(b1.shadow_rays(pt, eye_t, lcc_t, cfg_t, **kt),
                    b1.shadow_rays_plain(pt, eye_t, lcc_t, cfg_t, **kt)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    (bounds, _), (want, _) = (b1.window_angles(pt, eye_t, lcc_t),
                              b1.window_angles_plain(pt, eye_t, lcc_t))
    assert [float(x) for x in bounds] == [float(x) for x in want]
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="windowed"):
        b1.shadow_rays(pt, eye_t, lcc_t, cfg_t, angles=(pt["t"], pt["t"]))
    with pytest.raises(TypeError):
        b1.shadow_rays({"t": pt["t"].double(), "ray_dir": pt["ray_dir"]},
                       eye_t, lcc_t, cfg_t)
    with pytest.raises(ValueError, match="unsupported device"):
        b1.window_angles({k: x.to("meta") for k, x in pt.items()},
                         eye_t.to("meta"), lcc_t.to("meta"))
    with pytest.raises(ValueError, match="fewer flags"):
        b1.unpermute(torch.zeros((1, 128), dtype=torch.int32),
                     torch.arange(200, dtype=torch.int32))


@pytest.mark.parametrize("backend", [None, "plain"])
def test_shadow_pass_hands_the_window_angles_on(small_cfg, cornell,
                                                generic_camera,
                                                generic_light, backend,
                                                monkeypatch):
    """In windowed mode shadow_pass computes the rays' angles once (the
    window launch) and trace_shadow bins with them; the flags equal a
    trace that computes them anew.  ``backend`` picks B1's plain
    version as it picks K3's."""
    cfg = dataclasses.replace(bridge.render_config(small_cfg),
                              light_grid_mode="windowed")
    prim, cc, lcc = _primary(small_cfg, "cornell", generic_camera,
                             generic_light)
    sc = bridge.scene_to_torch(cornell, "cpu")
    pt = {k: bridge.from_numpy(a, "cpu") for k, a in prim.items()}
    cc_t, lcc_t = bridge.from_numpy(cc, "cpu"), bridge.from_numpy(lcc, "cpu")
    seen = []
    # The plain backend calls the wrapper's plain version; the default,
    # the wrapper.
    owner, name = ((b1.shadow_rays, "plain") if backend == "plain"
                   else (tshadow_t, "shadow_rays"))
    inner = getattr(owner, name)

    def spy(*args, **kwargs):
        seen.append(kwargs.get("angles") is not None)
        return inner(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    if backend is not None:
        monkeypatch.setattr(tshadow_t, "trace_shadow", functools.partial(
            tshadow_t.trace_shadow, backend=backend))
    cap = cfg.pair_capacity(cornell.num_faces)
    got, _, _ = tshadow_t.shadow_pass(sc["vertices"], sc["faces"], pt, cc_t,
                                      lcc_t[None], cfg, capacity=cap,
                                      num_lights=1)
    assert seen == [True]
    window = tshadow_t.light_window(pt, cc_t[0:3], lcc_t, cfg)
    lgrid = tshadow_t.gbuild.build_spherical_grid(
        sc["vertices"], sc["faces"], lcc_t, cfg=cfg, capacity=cap,
        window=window)
    want = tshadow_t.trace_shadow(sc["vertices"], sc["faces"], lcc_t, lgrid,
                                  pt, cc_t[0:3], cfg, window=window)
    assert seen == [True, False] and int(want.sum()) > 100
    assert torch.equal(got, want)
