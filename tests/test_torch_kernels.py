"""ugrt_torch sweep kernels' plain versions vs ugrt's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
tests/test_pallas.py runs them, on the same packed inputs as the port's
plain versions (CPU tensors take the plain path; the CUDA kernels are
held to the plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py).  The window packing itself is compared with
ugrt's.

Tolerance: none.  Both evaluate the same f32 operations in the same
order, so primary (t, face) must be bitwise equal and shadow flags
exact.  ugrt's schedules (make_windows / make_heavy_windows) are built
from the same per-block spans the port's window ranges come from.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.core import camera as cam
from ugrt.grid import build as gbuild
from ugrt.trace import heavy as theavy
from ugrt.trace import pallas_tracer as pt
from ugrt.trace import primary as tprim
from ugrt_torch import bridge
from ugrt_torch.grid import build as tbuild
from ugrt_torch.kernels import heavy_primary_sweep as k2
from ugrt_torch.kernels import primary_sweep as k1
from ugrt_torch.kernels import shadow_sweep as k3
from ugrt_torch.trace import heavy as theavy_t
from ugrt_torch.trace import primary as tprim_t
from ugrt_torch.trace import windows as tw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INSIDE_BOX = cam.CameraSpec(eye=(0.05, 0.03, 0.4), look_at=(0.1, 0.04, -1.0),
                            up=(0.02, 1.0, 0.013), near=0.1, far=100.0)


def _cc(spec, cfg):
    return cam.camcoords_from_spec(spec, cfg.fovy_deg,
                                   cfg.screen_width / cfg.screen_height)


def _np(t):
    return bridge.to_numpy(t)


def _primary_inputs(scene, spec, cfg, cap, **kw):
    """Port-side grid, K1 windows, [NB, 128, 8] rays and spans."""
    sc = bridge.scene_to_torch(scene)
    cc = bridge.from_numpy(_cc(spec, cfg))
    grid = tbuild.build_perspective_grid(sc["vertices"], sc["faces"], cc,
                                         cfg=cfg, capacity=cap, **kw)
    tri = tw.pack_tri_windows(sc["vertices"], sc["faces"], grid, cc[:3])
    from ugrt_torch.core.camera import primary_ray_dirs
    rays_t = tprim_t.tile_rays(
        primary_ray_dirs(cc, cfg.screen_width, cfg.screen_height), cfg)
    T = rays_t.shape[0]
    tiles = torch.arange(T)
    rows = torch.zeros((T, 64, 8))
    rows[:, :, 0:3] = rays_t
    rows[:, :, 3] = tiles.float()[:, None]
    rows[:, :, 4] = (tiles // cfg.grid_y).float()[:, None]
    rows[:, :, 5] = (tiles % cfg.grid_y).float()[:, None]
    rows = rows.reshape(T // 2, 128, 8)
    b = torch.arange(T // 2)
    lo = grid.cell_offset[2 * b]
    hi = grid.cell_offset[2 * b + 1] + grid.cell_count[2 * b + 1]
    return sc, cc, grid, tri, rows, lo, hi


def _pallas_rays(rows):
    """Port rows [NB, 128, 8] -> Pallas comp-major [NB + 1, 8, 128] with
    its guard block (zero dirs, key -1)."""
    guard = np.zeros((1, 128, 8), np.float32)
    guard[:, :, 3:6] = -1.0
    return jnp.asarray(np.concatenate([_np(rows), guard]).swapaxes(1, 2))


def test_primary_sweep_plain_matches_pallas(small_cfg, cornell,
                                            generic_camera):
    cfg = small_cfg
    _, _, _, tri, rows, lo, hi = _primary_inputs(
        cornell, generic_camera, cfg, cfg.pair_capacity(cornell.num_faces))
    nb, nw = rows.shape[0], tri.shape[0]
    w_lo, w_hi = tw.window_span(lo, hi, tw.WIN)
    t_p, f_p = k1.primary_sweep_plain(tri, rows, w_lo, w_hi, cfg=cfg)

    wi, wb, _, total = pt.make_windows(jnp.asarray(_np(lo)),
                                       jnp.asarray(_np(hi)), nb + nw, nw)
    t_j, f_j = pt.primary_sweep(jnp.asarray(_np(tri)), _pallas_rays(rows),
                                wi, wb, total, cfg=cfg, interpret=True,
                                guard=nb)
    assert (_np(t_p) < 3e38).sum() > 1000
    np.testing.assert_array_equal(np.asarray(f_j)[:nb], _np(f_p))
    np.testing.assert_array_equal(np.asarray(t_j)[:nb], _np(t_p))


@pytest.mark.parametrize("heavy_capacity", [1024, 128])
def test_heavy_primary_sweep_plain_matches_pallas(small_cfg, cornell,
                                                  heavy_capacity):
    """Both Pallas dispatch branches: capacity 1024 leaves the table
    mostly dead (looped kernel), 128 mostly live (unrolled kernel)."""
    cfg = dataclasses.replace(small_cfg, heavy_capacity=heavy_capacity)
    sc, cc, grid, _, rows, _, _ = _primary_inputs(
        cornell, INSIDE_BOX, cfg, cfg.pair_capacity(cornell.num_faces) * 16,
        heavy_threshold=16)
    assert int(grid.heavy_count) > 0
    co = theavy_t.heavy_coeffs(sc["vertices"], sc["faces"], grid.heavy_faces,
                               grid.heavy_count, cc[:3], grid.heavy_ranges)
    table = tw.pack_heavy_windows(co)
    t_p, f_p = k2.heavy_primary_sweep_plain(grid.heavy_count, table, rows,
                                            cfg=cfg)
    t_j, f_j = pt.heavy_primary_sweep(
        jnp.asarray(_np(grid.heavy_count)), jnp.asarray(_np(table)),
        jnp.asarray(_np(rows)), cfg=cfg, interpret=True)
    assert (_np(t_p) < 3e38).sum() > 100
    np.testing.assert_array_equal(np.asarray(f_j), _np(f_p))
    np.testing.assert_array_equal(np.asarray(t_j), _np(t_p))


def _shadow_inputs(scene, camera, light, cfg, cap, heavy_threshold):
    """ugrt primary + the port's sorted shadow rows for K3."""
    from ugrt_torch.core.vecmath import dot, normalize, sqrt
    from ugrt_torch.grid import binning

    cc, lcc = _cc(camera, cfg), _cc(light, cfg)
    v, f = jnp.asarray(scene.vertices), jnp.asarray(scene.faces)
    g = gbuild.build_perspective_grid(v, f, jnp.asarray(cc), cfg=cfg,
                                      capacity=cap)
    prim = tprim.trace_primary(v, f, jnp.asarray(cc), g, cfg)
    sc = bridge.scene_to_torch(scene)
    lcc_t = bridge.from_numpy(lcc)
    lgrid = tbuild.build_spherical_grid(sc["vertices"], sc["faces"], lcc_t,
                                        cfg=cfg, capacity=cap,
                                        heavy_threshold=heavy_threshold)
    n = cfg.screen_width * cfg.screen_height
    pts = (bridge.from_numpy(cc[:3])[None]
           + bridge.from_numpy(np.asarray(prim["t"])).reshape(n, 1)
           * bridge.from_numpy(np.asarray(prim["ray_dir"])).reshape(n, 3))
    cells = binning.ray_light_cells(pts, lcc_t, cfg.grid_x, cfg.grid_y,
                                    cfg.angular_extent, cfg.angular_extent,
                                    cfg.quirks.y_forward_dot_typo)
    scells, perm = torch.sort(cells, stable=True)
    delta = pts[perm] - lcc_t[None, :3]
    rows = torch.zeros((n, 8))
    rows[:, 0:3] = normalize(delta)
    rows[:, 3] = sqrt(dot(delta, delta))
    sentinel = cfg.cell_sentinel
    rows[:, 4] = torch.where(scells < sentinel, scells.float(), -1.0)
    rows[:, 5] = (scells // cfg.grid_y).float()
    rows[:, 6] = (scells % cfg.grid_y).float()
    blk = scells.reshape(-1, 128)
    first = blk[:, 0]
    last = torch.where(blk < sentinel, blk, -1).amax(dim=1)
    return sc, lcc_t, lgrid, rows.reshape(-1, 128, 8), first, last


# box=True runs with every face heavy (threshold 1): at threshold 4 no
# heavy face of this scene occludes anything.
@pytest.mark.parametrize("box,heavy_threshold", [(False, 4), (True, 1)])
def test_shadow_sweep_plain_matches_pallas(small_cfg, cornell,
                                           generic_camera, generic_light,
                                           box, heavy_threshold):
    cfg = small_cfg
    cap = cfg.pair_capacity(cornell.num_faces) * 16
    sc, lcc, lgrid, rows, first, last = _shadow_inputs(
        cornell, generic_camera, generic_light, cfg, cap, heavy_threshold)
    nb = rows.shape[0]
    sentinel = cfg.cell_sentinel
    if box:
        assert int(lgrid.heavy_count) > 0
        co = tw.spatial_reorder_heavy(theavy_t.heavy_coeffs(
            sc["vertices"], sc["faces"], lgrid.heavy_faces,
            lgrid.heavy_count, lcc[:3], lgrid.heavy_ranges))
        tri = tw.pack_heavy_coeff_windows(co, win=128)
        w_lo, w_hi = tw.heavy_block_window_range(
            first, last, cfg.grid_y, tw.heavy_window_rects(co, 128))
        wi, wb, _, _, total = pt.make_heavy_windows(
            jnp.asarray(_np(w_lo)), jnp.asarray(_np(w_hi)),
            nb * tri.shape[0], tri.shape[0])
    else:
        live = last >= 0
        k1_ = torch.clamp(first, 0, sentinel - 1).long()
        k2_ = torch.clamp(last, 0, sentinel - 1).long()
        lo = torch.where(live, lgrid.cell_offset[k1_], 0)
        hi = torch.where(live, lgrid.cell_offset[k2_] + lgrid.cell_count[k2_],
                         0)
        tri = tw.pack_tri_windows_coeff(sc["vertices"], sc["faces"], lgrid,
                                        lcc[:3], win=256)
        w_lo, w_hi = tw.window_span(lo, hi, 256)
        wi, wb, _, total = pt.make_windows(
            jnp.asarray(_np(lo)), jnp.asarray(_np(hi)),
            6 * nb + tri.shape[0] + 256, tri.shape[0], win=256)
    sh_p = k3.shadow_sweep_plain(tri, rows, w_lo, w_hi, cfg=cfg, box=box)
    guard = np.zeros((1, 128, 8), np.float32)
    guard[:, :, 4:7] = -1.0
    rays_j = jnp.asarray(np.concatenate([_np(rows), guard]).swapaxes(1, 2))
    sh_j = pt.shadow_sweep(jnp.asarray(_np(tri)), rays_j, wi, wb, total,
                           cfg=cfg, interpret=True, guard=nb, box=box)
    sh_j = np.asarray(sh_j)[:nb]
    if box:   # ugrt masks blocks with an empty heavy range (never run)
        sh_j = np.where((_np(w_hi) >= _np(w_lo))[:, None], sh_j, 0)
    assert _np(sh_p).sum() > 100
    np.testing.assert_array_equal(sh_j, _np(sh_p))


def test_window_packing_matches_ugrt(small_cfg, cornell, generic_camera,
                                     generic_light):
    """pack_tri_windows(_coeff), the heavy packings, the spatial reorder,
    the window rects and the per-block heavy ranges equal ugrt's."""
    cfg = small_cfg
    cap = cfg.pair_capacity(cornell.num_faces) * 16
    lcc = _cc(generic_light, cfg)
    v, f = jnp.asarray(cornell.vertices), jnp.asarray(cornell.faces)
    gj = gbuild.build_spherical_grid(v, f, jnp.asarray(lcc), cfg=cfg,
                                     capacity=cap, heavy_threshold=4)
    sc = bridge.scene_to_torch(cornell)
    lt = bridge.from_numpy(lcc)
    gt = tbuild.build_spherical_grid(sc["vertices"], sc["faces"], lt,
                                     cfg=cfg, capacity=cap, heavy_threshold=4)
    L_j, L_t = jnp.asarray(lcc[:3]), lt[:3]

    def eq(a, b):
        np.testing.assert_array_equal(np.asarray(a), _np(b))

    eq(pt.pack_tri_windows(v, f, gj, L_j),
       tw.pack_tri_windows(sc["vertices"], sc["faces"], gt, L_t))
    eq(pt.pack_tri_windows_coeff(v, f, gj, L_j, win=256),
       tw.pack_tri_windows_coeff(sc["vertices"], sc["faces"], gt, L_t,
                                 win=256))
    co_j = theavy.heavy_coeffs(v, f, gj.heavy_faces, gj.heavy_count, L_j,
                               gj.heavy_ranges)
    co_t = theavy_t.heavy_coeffs(sc["vertices"], sc["faces"], gt.heavy_faces,
                                 gt.heavy_count, L_t, gt.heavy_ranges)
    for a, b in zip(co_j, co_t):
        eq(a, b)
    eq(pt.pack_heavy_windows(co_j), tw.pack_heavy_windows(co_t))
    co_j, co_t = pt.spatial_reorder_heavy(co_j), tw.spatial_reorder_heavy(co_t)
    eq(pt.pack_heavy_coeff_windows(co_j), tw.pack_heavy_coeff_windows(co_t))
    rj, rt = pt.heavy_window_rects(co_j), tw.heavy_window_rects(co_t)
    for a, b in zip(rj, rt):
        eq(a, b)
    first = np.arange(0, 256, 3, dtype=np.int32)
    last = np.minimum(first + np.arange(first.size) % 40, 255).astype(
        np.int32)
    last[::7] = -1
    for a, b in zip(
            pt.heavy_block_window_range(jnp.asarray(first),
                                        jnp.asarray(last), cfg.grid_y, rj),
            tw.heavy_block_window_range(torch.from_numpy(first),
                                        torch.from_numpy(last), cfg.grid_y,
                                        rt)):
        eq(a, b)


def test_cpu_tensors_take_the_plain_path(small_cfg, cornell,
                                         generic_camera):
    """On CPU tensors each wrapper returns its plain version's result and
    launches no kernel (the counters stay put); a wrong dtype raises."""
    cfg = small_cfg
    _, _, _, tri, rows, lo, hi = _primary_inputs(
        cornell, generic_camera, cfg, cfg.pair_capacity(cornell.num_faces))
    w_lo, w_hi = tw.window_span(lo, hi, tw.WIN)
    before = (k1.primary_sweep.launches, k2.heavy_primary_sweep.launches,
              k3.shadow_sweep.launches)

    for a, b in zip(k1.primary_sweep(tri, rows, w_lo, w_hi, cfg=cfg),
                    k1.primary_sweep_plain(tri, rows, w_lo, w_hi, cfg=cfg)):
        assert torch.equal(a, b)
    count = torch.tensor(0, dtype=torch.int32)
    table = torch.zeros((16, 128))
    t, f = k2.heavy_primary_sweep(count, table, rows, cfg=cfg)
    assert (t == 3e38).all() and (f == 2**31 - 1).all()
    sh = k3.shadow_sweep(torch.zeros((1, 256, 16)), rows, w_lo * 0,
                         w_hi * 0 - 1, cfg=cfg)
    assert not sh.any()

    assert (k1.primary_sweep.launches, k2.heavy_primary_sweep.launches,
            k3.shadow_sweep.launches) == before
    # Neither CPU nor CUDA: the wrappers raise instead of falling back.
    meta = [x.to("meta") for x in (tri, rows, w_lo, w_hi)]
    with pytest.raises(ValueError, match="unsupported device"):
        k1.primary_sweep(*meta, cfg=cfg)
    with pytest.raises(TypeError):
        k1.primary_sweep(tri.double(), rows, w_lo, w_hi, cfg=cfg)
    with pytest.raises(ValueError):
        k3.shadow_sweep(tri, rows[:, :64], w_lo, w_hi, cfg=cfg)
