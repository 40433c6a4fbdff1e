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
import torch

from ugrt.config import RenderConfig
from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.ref import oracle
from ugrt.trace import primary as tprim
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.kernels import primary_sweep as k1
from ugrt_torch.trace import primary as tprim_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INSIDE_BOX = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                            up=(0.02, 1.0, 0.013), near=0.1, far=100.0)
NS4 = dataclasses.replace(RenderConfig(), screen_width=64, screen_height=64,
                          grid_x=8, grid_y=8, num_slabs=4)


def _inputs(scene, spec, cfg, cap, **kw):
    """(camcoords, ugrt's trace_primary arguments, the port's, the port's
    config): the scene, camera and each package's own grid."""
    cc = cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                 cfg.screen_width / cfg.screen_height)
    v, f, ccj = (jnp.asarray(scene.vertices), jnp.asarray(scene.faces),
                 jnp.asarray(cc))
    gj = gbuild.build_perspective_grid(v, f, ccj, cfg=cfg, capacity=cap,
                                       **kw)
    sc = bridge.scene_to_torch(scene, "cpu")
    cct = bridge.from_numpy(cc, "cpu")
    cfg_t = bridge.render_config(cfg)
    gt = tbuild.build_perspective_grid(sc["vertices"], sc["faces"], cct,
                                       cfg=cfg_t, capacity=cap, **kw)
    return cc, (v, f, ccj, gj), (sc["vertices"], sc["faces"], cct, gt), cfg_t


def _both(scene, spec, cfg, cap, **kw):
    cc, args_j, args_t, cfg_t = _inputs(scene, spec, cfg, cap, **kw)
    rj = tprim.trace_primary(*args_j, cfg)
    rt = tprim_t.trace_primary(*args_t, cfg_t)
    return cc, args_j[3], {k: np.asarray(v) for k, v in rj.items()}, \
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


# The whole primary trace with K1's work items at chunk sizes 1, 2 and 4
# in place of PCHUNK (small_cfg; num_slabs=4, one sweep per slab): still
# bitwise equal to ugrt.
@pytest.mark.parametrize("chunk", [1, 2, 4])
@pytest.mark.parametrize("case", ["small", "num_slabs_4"])
def test_trace_primary_chunked(monkeypatch, small_cfg, cornell,
                               generic_camera, case, chunk):
    calls, size = [], chunk

    def sweep(tri, rays, w_lo, w_hi, *, cfg, chunk=None):
        assert chunk == tprim_t.PCHUNK
        calls.append((w_lo, w_hi))
        return k1.primary_sweep(tri, rays, w_lo, w_hi, cfg=cfg, chunk=size)

    monkeypatch.setattr(tprim_t, "primary_sweep", sweep)
    cfg = small_cfg if case == "small" else NS4
    _, _, rj, rt = _both(cornell, generic_camera, cfg,
                         cfg.pair_capacity(cornell.num_faces))
    assert len(calls) == cfg.num_slabs
    assert any(int((hi - lo).max()) >= 1 for lo, hi in calls)
    assert (rt["face_id"] >= 0).sum() > rt["face_id"].size // 2
    _assert_equal(rj, rt)


# Strips of grid_x / n tile columns, as ugrt.dist.mesh and the port's
# dist.mesh give each rank (small_cfg; the heavy list; num_slabs=4).
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["small", "heavy_1024", "num_slabs_4"])
def test_trace_primary_strips(small_cfg, cornell, generic_camera, case, n):
    """Side by side the strips are bitwise the whole trace, and each strip
    is bitwise ugrt's trace_primary(bx0=, n_bx=) on face_id and t (K1's
    cell keys and K2's footprint gx offset by the strip's first column)."""
    cfg, spec, kw = small_cfg, generic_camera, {}
    cap = cfg.pair_capacity(cornell.num_faces)
    if case == "heavy_1024":
        cfg = dataclasses.replace(cfg, heavy_capacity=1024)
        spec, kw, cap = INSIDE_BOX, dict(heavy_threshold=16), cap * 16
    elif case == "num_slabs_4":
        cfg = NS4
    _, args_j, args_t, cfg_t = _inputs(cornell, spec, cfg, cap, **kw)
    full = tprim_t.trace_primary(*args_t, cfg_t)
    n_bx = cfg.grid_x // n
    strips = [tprim_t.trace_primary(*args_t, cfg_t, bx0=d * n_bx, n_bx=n_bx)
              for d in range(n)]
    for k in ("face_id", "t", "normal", "ray_dir"):
        assert torch.equal(torch.cat([s[k] for s in strips], dim=1),
                           full[k]), k
    for d in (0, n - 1):
        rj = tprim.trace_primary(*args_j, cfg, bx0=d * n_bx, n_bx=n_bx)
        for k in ("face_id", "t"):
            np.testing.assert_array_equal(strips[d][k].numpy(),
                                          np.asarray(rj[k]), err_msg=k)
    if case.startswith("heavy"):
        assert int(args_t[3].heavy_count) > 0
    assert (full["face_id"] >= 0).sum() > full["face_id"].numel() // 2


def test_trace_primary_refuses_bad_strips(small_cfg, cornell,
                                          generic_camera):
    """A strip outside the grid, or of an odd number of tiles (two 64-ray
    tiles make a 128-ray block), raises ValueError."""
    cfg = dataclasses.replace(small_cfg, screen_height=72, grid_y=9)
    _, _, args_t, cfg_t = _inputs(cornell, generic_camera, small_cfg,
                                  small_cfg.pair_capacity(cornell.num_faces))
    for bx0, n_bx in ((15, 2), (-1, 2), (0, 0)):
        with pytest.raises(ValueError, match="strip"):
            tprim_t.trace_primary(*args_t, cfg_t, bx0=bx0, n_bx=n_bx)
    _, _, args_t, cfg_t = _inputs(cornell, generic_camera, cfg,
                                  cfg.pair_capacity(cornell.num_faces))
    with pytest.raises(ValueError, match="even"):
        tprim_t.trace_primary(*args_t, cfg_t, bx0=3, n_bx=1)
    tprim_t.trace_primary(*args_t, cfg_t, bx0=3, n_bx=2)


# ugrt's backend= argument (primary.py:201-204) with the port's values:
# "plain" bitwise the default on CPU tensors (K1 and K2's plain versions:
# the heavy case), "kernel" on CPU tensors and an unknown name raise.
@pytest.mark.parametrize("backend", ["plain", "kernel", "unknown"])
def test_trace_primary_backend(small_cfg, cornell, backend):
    cfg = dataclasses.replace(small_cfg, heavy_capacity=1024)
    cap = cfg.pair_capacity(cornell.num_faces) * 16
    _, _, args_t, cfg_t = _inputs(cornell, INSIDE_BOX, cfg, cap,
                                  heavy_threshold=16)
    if backend != "plain":
        match = "CUDA tensors" if backend == "kernel" else "unknown"
        with pytest.raises(ValueError, match=match):
            tprim_t.trace_primary(*args_t, cfg_t, backend=backend)
        return
    assert int(args_t[3].heavy_count) > 0
    want = tprim_t.trace_primary(*args_t, cfg_t)
    got = tprim_t.trace_primary(*args_t, cfg_t, backend="plain")
    for k in ("face_id", "t", "normal", "ray_dir"):
        assert torch.equal(got[k].view(torch.int32)
                           if got[k].is_floating_point() else got[k],
                           want[k].view(torch.int32)
                           if want[k].is_floating_point() else want[k]), k
    assert (want["face_id"] >= 0).sum() > want["face_id"].numel() // 2
