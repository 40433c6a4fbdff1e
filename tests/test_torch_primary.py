"""ugrt_torch trace_primary vs ugrt's trace_primary (and the oracle).

ugrt runs its XLA backend, which tests/test_pallas.py proves bitwise
equal to the Pallas kernels; the port runs K1/K2's plain versions on
CPU tensors.  Both get the same numpy scene and camera.

Tolerance: none — face_id, t and normal are bitwise equal.  The port
evaluates each f32 op once in ugrt's order (sqrt taken correctly
rounded, as ugrt's eager XLA and numpy give it), so no ulp slack is
needed on these scenes; the oracle check holds it to the reference's
semantics as well.
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
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.trace import primary as tprim_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INSIDE_BOX = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                            up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
NS4 = dataclasses.replace(RenderConfig(), screen_width=64, screen_height=64,
                          grid_x=8, grid_y=8, num_slabs=4)


def _both(scene, spec, cfg, cap, **kw):
    cc = cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                 cfg.screen_width / cfg.screen_height)
    v, f, ccj = (jnp.asarray(scene.vertices), jnp.asarray(scene.faces),
                 jnp.asarray(cc))
    gj = gbuild.build_perspective_grid(v, f, ccj, cfg=cfg, capacity=cap,
                                       **kw)
    rj = tprim.trace_primary(v, f, ccj, gj, cfg)
    sc = bridge.scene_to_torch(scene)
    cct = bridge.from_numpy(cc)
    gt = tbuild.build_perspective_grid(sc["vertices"], sc["faces"], cct,
                                       cfg=cfg, capacity=cap, **kw)
    rt = tprim_t.trace_primary(sc["vertices"], sc["faces"], cct, gt, cfg)
    return cc, gj, {k: np.asarray(v) for k, v in rj.items()}, \
        {k: bridge.to_numpy(v) for k, v in rt.items()}


def _assert_equal(ra, rb):
    for k in ("face_id", "t", "normal", "ray_dir"):
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.parametrize("case", ["small", "heavy_1024", "heavy_128",
                                  "num_slabs_4"])
def test_trace_primary_matches_ugrt(small_cfg, cornell, generic_camera,
                                    case):
    """small_cfg; the inside-the-box camera with a heavy list (both K2
    table densities, as tests/test_pallas.py:80-92); num_slabs=4."""
    cfg, spec, kw = small_cfg, generic_camera, {}
    cap = cfg.pair_capacity(cornell.num_faces)
    if case.startswith("heavy"):
        cfg = dataclasses.replace(cfg, heavy_capacity=int(case[6:]))
        spec, kw, cap = INSIDE_BOX, dict(heavy_threshold=16), cap * 16
    elif case == "num_slabs_4":
        cfg = NS4
    _, gj, rj, rt = _both(cornell, spec, cfg, cap, **kw)
    if case.startswith("heavy"):
        assert int(gj.heavy_count) > 0
    assert (rt["face_id"] >= 0).sum() > rt["face_id"].size // 2
    _assert_equal(rj, rt)


def test_trace_primary_matches_oracle(small_cfg, cornell, generic_camera):
    cfg = small_cfg
    cc, _, _, rt = _both(cornell, generic_camera, cfg,
                         cfg.pair_capacity(cornell.num_faces))
    ores = oracle.trace_primary(cornell, cc, oracle.build_grid(cornell, cc,
                                                               cfg), cfg)
    _assert_equal(ores, rt)


def test_miss_sentinels(small_cfg, cornell):
    """Camera looking away: |t| quirk hits behind the eye and exact miss
    sentinels t = -1, face = -2, normal = -1, as ugrt."""
    spec = cam.CameraSpec(eye=(0.013, 0.027, 30.0),
                          look_at=(0.011, 0.007, 60.0),
                          up=(0.01, 1, 0.02), near=0.1, far=100.0)
    _, _, rj, rt = _both(cornell, spec, small_cfg,
                         small_cfg.pair_capacity(cornell.num_faces))
    miss = rt["face_id"] == -2
    assert miss.any()
    assert (rt["t"][miss] == -1.0).all() and (rt["normal"][miss] == -1).all()
    _assert_equal(rj, rt)
