"""ugrt_torch grid build vs ugrt.grid.build: every DeviceGrid field equal.

Tolerance for the grids: none.  Both packages bin in float32 in the same
operation order, so every field (pair list, keys, CSR, heavy list and
footprints, flags) must be exactly equal on these scenes.

The light window is a float made of arccos values.  The port takes
arccos in float64 and rounds once (ugrt_torch.core.vecmath.acos); XLA's
f32 acos differs from that by 1-2 ulp on 19% of uniform inputs in
[-1, 1] (measured on 4M samples), so a window bound can differ by a few
ulp.  Measured on this scene: the windows are equal; bounded here at
8 ulp.  The grid tests build both grids on ugrt's window.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.trace import primary as tprim
from ugrt.trace import shadow as tshadow
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.trace import shadow as tshadow_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INSIDE_BOX = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                            up=(0.02, 1.0, 0.013), near=0.1, far=100.0)


def _cc(spec, cfg):
    return cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                   cfg.screen_width / cfg.screen_height)


def assert_grids_equal(g_jax, g_torch):
    for name in gbuild.DeviceGrid._fields:
        a = np.asarray(getattr(g_jax, name))
        b = bridge.to_numpy(getattr(g_torch, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _both_perspective(scene, cc, cfg, cap, **kw):
    gj = gbuild.build_perspective_grid(
        jnp.asarray(scene.vertices), jnp.asarray(scene.faces),
        jnp.asarray(cc), cfg=cfg, capacity=cap, **kw)
    sc = bridge.scene_to_torch(scene, "cpu")
    gt = tbuild.build_perspective_grid(
        sc["vertices"], sc["faces"], bridge.from_numpy(cc, "cpu"),
        cfg=bridge.render_config(cfg), capacity=cap, **kw)
    return gj, gt


@pytest.mark.parametrize("camera", ["generic", "inside_box"])
def test_perspective_grid_equal(small_cfg, cornell, generic_camera, camera):
    cfg = small_cfg
    if camera == "generic":
        cc = _cc(generic_camera, cfg)
        cap = cfg.pair_capacity(cornell.num_faces)
        kw = {}
    else:
        cc = _cc(INSIDE_BOX, cfg)
        cap = cfg.pair_capacity(cornell.num_faces) * 16
        kw = dict(heavy_threshold=16)
    gj, gt = _both_perspective(cornell, cc, cfg, cap, **kw)
    if camera == "inside_box":
        assert int(gj.heavy_count) > 0
    assert not bool(gj.overflow)
    assert_grids_equal(gj, gt)


def test_perspective_grid_multi_slab(cornell, generic_camera):
    from ugrt.config import RenderConfig
    cfg = dataclasses.replace(RenderConfig(), screen_width=64,
                              screen_height=64, grid_x=8, grid_y=8,
                              num_slabs=4)
    cc = _cc(generic_camera, cfg)
    gj, gt = _both_perspective(cornell, cc, cfg,
                               cfg.pair_capacity(cornell.num_faces))
    assert_grids_equal(gj, gt)


def test_perspective_grid_overflow_flag(small_cfg, cornell, generic_camera):
    """A pair capacity too small for the scene: clamped lists and the
    overflow flag agree too."""
    cc = _cc(generic_camera, small_cfg)
    gj, gt = _both_perspective(cornell, cc, small_cfg, 256)
    assert bool(gj.overflow)
    assert_grids_equal(gj, gt)


@pytest.mark.parametrize("mode,heavy", [("reference", None),
                                        ("reference", 4),
                                        ("extent", None),
                                        ("windowed", None),
                                        ("windowed", 4)])
def test_spherical_grid_equal(small_cfg, cornell, generic_camera,
                              generic_light, mode, heavy):
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    lcc = _cc(generic_light, cfg)
    cap = cfg.pair_capacity(cornell.num_faces) * (16 if heavy else 1)
    v, f = jnp.asarray(cornell.vertices), jnp.asarray(cornell.faces)
    grid = gbuild.build_perspective_grid(v, f, jnp.asarray(cc), cfg=cfg,
                                         capacity=cap)
    prim = tprim.trace_primary(v, f, jnp.asarray(cc), grid, cfg)
    prim_t = {k: bridge.from_numpy(np.asarray(prim[k]), "cpu")
              for k in ("t", "ray_dir")}
    eye_j, eye_t = jnp.asarray(cc[:3]), bridge.from_numpy(cc[:3], "cpu")
    lcc_j, lcc_t = jnp.asarray(lcc), bridge.from_numpy(lcc, "cpu")

    kw_j, kw_t = {}, {}
    if mode == "extent":
        xj, yj = tshadow.light_extents(prim, eye_j, lcc_j, cfg)
        xt, yt = tshadow_t.light_extents(prim_t, eye_t, lcc_t,
                                         bridge.render_config(cfg))
        assert (float(xj), float(yj)) == (float(xt), float(yt))
        kw_j, kw_t = dict(x_max=xj, y_max=yj), dict(x_max=xt, y_max=yt)
    elif mode == "windowed":
        # The grids are compared on ugrt's window; the port's own window
        # is held to it in test_light_window_close.
        wj = tshadow.light_window(prim, eye_j, lcc_j, cfg)
        kw_j = dict(window=wj)
        kw_t = dict(window=tuple(bridge.from_numpy(np.asarray(x), "cpu")
                                 for x in wj))
    if heavy is not None:
        kw_j["heavy_threshold"] = kw_t["heavy_threshold"] = heavy

    gj = gbuild.build_spherical_grid(v, f, lcc_j, cfg=cfg, capacity=cap,
                                     **kw_j)
    sc = bridge.scene_to_torch(cornell, "cpu")
    gt = tbuild.build_spherical_grid(sc["vertices"], sc["faces"], lcc_t,
                                     cfg=bridge.render_config(cfg),
                                     capacity=cap, **kw_t)
    if heavy is not None:
        assert int(gj.heavy_count) > 0
    assert_grids_equal(gj, gt)


def test_light_window_close(small_cfg, cornell, generic_camera,
                            generic_light):
    """The port's light_window on ugrt's primary: within 8 ulp of ugrt's
    (measured equal, see the module docstring); light_extents exactly."""
    cfg = small_cfg
    cc = _cc(generic_camera, cfg)
    lcc = _cc(generic_light, cfg)
    v, f = jnp.asarray(cornell.vertices), jnp.asarray(cornell.faces)
    grid = gbuild.build_perspective_grid(
        v, f, jnp.asarray(cc), cfg=cfg,
        capacity=cfg.pair_capacity(cornell.num_faces))
    prim = tprim.trace_primary(v, f, jnp.asarray(cc), grid, cfg)
    prim_t = {k: bridge.from_numpy(np.asarray(prim[k]), "cpu")
              for k in ("t", "ray_dir")}
    wj = tshadow.light_window(prim, jnp.asarray(cc[:3]), jnp.asarray(lcc),
                              cfg)
    cfg_t = bridge.render_config(cfg)
    wt = tshadow_t.light_window(prim_t, bridge.from_numpy(cc[:3], "cpu"),
                                bridge.from_numpy(lcc, "cpu"), cfg_t)
    a = np.asarray([float(x) for x in wj], np.float32)
    b = np.asarray([float(x) for x in wt], np.float32)
    assert (np.abs(a - b) <= 8 * np.spacing(np.abs(a))).all(), (a, b)

    ej = tshadow.light_extents(prim, jnp.asarray(cc[:3]), jnp.asarray(lcc),
                               cfg)
    et = tshadow_t.light_extents(prim_t, bridge.from_numpy(cc[:3], "cpu"),
                                 bridge.from_numpy(lcc, "cpu"), cfg_t)
    assert [float(x) for x in ej] == [float(x) for x in et]
