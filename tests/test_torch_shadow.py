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

import jax.numpy as jnp
import numpy as np
import pytest

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.ref import oracle
from ugrt.trace import primary as tprim
from ugrt.trace import shadow as tshadow
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
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
    sc = bridge.scene_to_torch(scene)
    prim_t = {k: bridge.from_numpy(np.asarray(prim[k]))
              for k in ("t", "ray_dir")}
    eye_t, lcc_t = bridge.from_numpy(cc[:3]), bridge.from_numpy(lcc)

    kw_j, kw_t = {}, {}
    if mode == "extent":
        x, y = tshadow.light_extents(prim, eye_j, lcc_j, cfg)
        kw_j = dict(x_max=x, y_max=y)
        x, y = tshadow_t.light_extents(prim_t, eye_t, lcc_t, cfg)
        kw_t = dict(x_max=x, y_max=y)
    elif mode == "windowed":
        kw_j = dict(window=tshadow.light_window(prim, eye_j, lcc_j, cfg))
        kw_t = dict(window=tshadow_t.light_window(prim_t, eye_t, lcc_t, cfg))
    hk = {} if heavy_threshold is None else dict(
        heavy_threshold=heavy_threshold)
    lg_j = gbuild.build_spherical_grid(v, f, lcc_j, cfg=cfg, capacity=cap,
                                       **hk, **kw_j)
    lg_t = tbuild.build_spherical_grid(sc["vertices"], sc["faces"], lcc_t,
                                       cfg=cfg, capacity=cap, **hk, **kw_t)
    sh_j, _ = tshadow.trace_shadow(v, f, lcc_j, lg_j, prim, eye_j, cfg,
                                   **kw_j)
    sh_t = tshadow_t.trace_shadow(sc["vertices"], sc["faces"], lcc_t, lg_t,
                                  prim_t, eye_t, cfg, **kw_t)
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
