"""ugrt_torch's reflection bounce vs ugrt: the uniform grid, the DDA and
the reflective frame (CPU: every sweep runs its plain version).

Tolerances: the uniform grid's integer fields and overflow flag are
exactly equal.  The DDA is held to brute force as tests/test_reflect.py
holds ugrt's (>= 99.5% of face ids agree, t within rtol 1e-4 / atol
1e-4), and to ugrt's DDA on the same inputs (>= 99.9% of face ids equal,
t within rtol 1e-5 where they agree; ugrt's jitted loop may fuse
multiply-adds, the port does not).  The reflective frame's u8 image may
differ from ugrt's jitted frame on at most 0.1% of pixels
(README.md:108-113: knife-edge rays).  The DDA's edge case
(ugrt_torch/micro/dda_edge.py: a cell deeper than max_batches * B faces,
coincident triangles, zero direction components, rays outside the AABB,
inactive rays) keeps the bound against ugrt's DDA (>= 99.9% of face ids
equal, t within rtol 1e-5 where they agree) and both overflow.  The
kernel D1's wrapper on CPU tensors is its plain version, bitwise; the
plain version on a shuffled half of the rays gives those rays' results
of the whole run bitwise (what lets D1 run each ray on its own).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugrt.core import camera as cam
from ugrt.core.vecmath import cross, normalize
from ugrt.grid import build as gbuild_j
from ugrt.ref import oracle
from ugrt.scene import procedural
from ugrt.trace import reflect as treflect_j
from ugrt_torch import bridge
from ugrt_torch.grid import build as gbuild_t
from ugrt_torch.kernels import uniform_dda as kdda
from ugrt_torch.micro import dda_edge
from ugrt_torch.trace import reflect as treflect_t
from test_reflect import _brute_force
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _padded_aabb(scene):
    lo, hi = scene.aabb
    return lo - np.float32(1e-3), hi + np.float32(1e-3)


@pytest.mark.parametrize("scene,dims,capacity", [
    ("cornell", (8, 8, 8), 16384), ("cathedral", (16, 16, 16), 1 << 17),
    ("cathedral", (16, 16, 16), 4096)],
    ids=["cornell", "cathedral", "cathedral-overflow"])
def test_uniform_grid_matches_ugrt(scene, dims, capacity):
    sc = (procedural.cornell_box(subdiv=2) if scene == "cornell"
          else procedural.cathedral(num_faces_target=2000, seed=0))
    lo, hi = _padded_aabb(sc)
    want = gbuild_j.build_uniform_grid(
        jnp.asarray(sc.vertices), jnp.asarray(sc.faces), jnp.asarray(lo),
        jnp.asarray(hi), grid_dims=dims, capacity=capacity)
    got = gbuild_t.build_uniform_grid(_t(sc.vertices), _t(sc.faces), _t(lo),
                                      _t(hi), grid_dims=dims,
                                      capacity=capacity)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert bool(got.overflow) == (capacity == 4096)


def _reflection_rays(cfg, scene, camera):
    """The oracle's primary hits and their mirror rays (signed normals),
    as tests/test_reflect.py builds them."""
    cc = cam.camcoords_from_spec(camera, cfg.fovy_deg, 1.0)
    primary = oracle.trace_primary(scene, cc, oracle.build_grid(scene, cc,
                                                                cfg), cfg)
    n = cfg.screen_height * cfg.screen_width
    t = primary["t"].reshape(n)
    d = primary["ray_dir"].reshape(n, 3).astype(np.float32)
    fid = primary["face_id"].reshape(n)
    origins = (cc[:3][None] + t[:, None] * d).astype(np.float32)
    v = scene.vertices[scene.faces[np.maximum(fid, 0)]]
    nrm = normalize(cross(normalize(v[:, 1] - v[:, 0]),
                          normalize(v[:, 2] - v[:, 0])))
    nrm = nrm * np.where((d * nrm).sum(-1) > 0, -1.0, 1.0)[:, None]
    rdir = normalize(d - 2.0 * (d * nrm).sum(-1)[:, None] * nrm)
    return origins, rdir.astype(np.float32), fid >= 0, fid


def _dda_torch(cfg, scene, rays, dims, **kw):
    origins, rdir, hit, fid = rays
    lo, hi = _padded_aabb(scene)
    grid = gbuild_t.build_uniform_grid(_t(scene.vertices), _t(scene.faces),
                                       _t(lo), _t(hi), grid_dims=dims,
                                       capacity=16384)
    return treflect_t.trace_uniform_dda(
        _t(scene.vertices), _t(scene.faces), grid, _t(origins), _t(rdir),
        _t(hit), _t(fid), _t(lo), _t(hi), dims, bridge.render_config(cfg),
        **kw)


def test_dda_matches_brute_force(small_cfg, cornell, generic_camera):
    """tests/test_reflect.py:39-93 for the port."""
    rays = _reflection_rays(small_cfg, cornell, generic_camera)
    res = _dda_torch(small_cfg, cornell, rays, (8, 8, 8), max_batches=2)
    assert not bool(res["overflow"])
    origins, rdir, hit, fid = rays
    bt, bf = _brute_force(cornell, origins, rdir, hit, fid)
    t_d, f_d = res["t"].numpy(), res["face_id"].numpy()
    agree = f_d == bf
    assert agree.mean() > 0.995, f"only {agree.mean():.4f} agree"
    both = (bf >= 0) & agree
    np.testing.assert_allclose(t_d[both], bt[both], rtol=1e-4, atol=1e-4)
    assert (f_d[hit] >= 0).mean() > 0.4


@pytest.mark.parametrize("max_batches,batch", [(2, None), (8, 4), (2, 4)],
                         ids=["default", "batches-of-4", "overflow"])
def test_dda_matches_ugrt(small_cfg, cornell, generic_camera, max_batches,
                          batch):
    """The same rays through ugrt's trace_uniform_dda and the port's, with
    deep cells (batches of 4 faces: up to 4 batches a cell) and a cap
    that cells exceed (overflow)."""
    dims = (8, 8, 8)
    rays = _reflection_rays(small_cfg, cornell, generic_camera)
    origins, rdir, hit, fid = rays
    lo, hi = _padded_aabb(cornell)
    ug = gbuild_j.build_uniform_grid(
        jnp.asarray(cornell.vertices), jnp.asarray(cornell.faces),
        jnp.asarray(lo), jnp.asarray(hi), grid_dims=dims, capacity=16384)
    want = treflect_j.trace_uniform_dda(
        jnp.asarray(cornell.vertices), jnp.asarray(cornell.faces), ug,
        jnp.asarray(origins), jnp.asarray(rdir), jnp.asarray(hit),
        jnp.asarray(fid), jnp.asarray(lo), jnp.asarray(hi), dims, small_cfg,
        max_batches=max_batches, batch=batch)
    got = _dda_torch(small_cfg, cornell, rays, dims, max_batches=max_batches,
                     batch=batch)
    assert bool(got["overflow"]) == bool(want["overflow"]) == (
        max_batches * (batch or small_cfg.tri_batch) < 14)
    f_w, f_g = np.asarray(want["face_id"]), got["face_id"].numpy()
    same = f_g == f_w
    assert same.mean() >= 0.999, f"{(~same).sum()} face ids differ"
    assert (f_g >= 0).sum() > 5000
    np.testing.assert_allclose(got["t"].numpy()[same],
                               np.asarray(want["t"])[same], rtol=1e-5)
    assert 0 < got["steps"] <= sum(dims)


def test_reflective_frame_matches_ugrt(tiny_cfg, cornell, generic_camera,
                                       generic_light):
    from ugrt.api.renderer import render_frame_reflective as frame_j
    from ugrt_torch.api.renderer import render_frame_reflective as frame_t

    cfg = tiny_cfg
    cc = cam.camcoords_from_spec(generic_camera, cfg.fovy_deg, 1.0)
    lcc = cam.camcoords_from_spec(generic_light, cfg.fovy_deg, 1.0)[None]
    lp = np.asarray(generic_light.eye, np.float32)
    args = (cornell.vertices, cornell.faces, cornell.mat_index,
            cornell.materials, cc, lcc, lp)
    kw = dict(capacity=cfg.pair_capacity(cornell.num_faces), num_lights=1,
              use_spot=True, uniform_dims=(8, 8, 8))
    want = frame_j(*(jnp.asarray(a) for a in args), cfg=cfg, **kw)
    got = frame_t(*(_t(a) for a in args), cfg=bridge.render_config(cfg),
                  **kw)
    assert bool(got["overflow"]) == bool(want["overflow"]) is False
    img_g, img_w = got["image"].numpy(), np.asarray(want["image"])
    assert img_g.shape == img_w.shape == (64, 64, 3)
    assert (img_g != img_w).any(-1).sum() <= 0.001 * 64 * 64
    f_g = got["reflection"]["face_id"].numpy()
    f_w = np.asarray(want["reflection"]["face_id"])
    assert (f_g == f_w).mean() >= 0.999 and (f_g >= 0).sum() > 1000
    np.testing.assert_array_equal(got["shadowed"].numpy(),
                                  np.asarray(want["shadowed"]))
    ug = got["uniform_grid"]
    assert int(ug.total_pairs) == int(ug.cell_count.sum()) > 0


def test_reflective_frame_sees_its_mirror(tiny_cfg, cornell, generic_camera,
                                          generic_light):
    """Where a reflection ray hits, the mix adds kr * its color: with kr 0
    the frame is (1 - 0) * the plain frame's color, with kr 1 the
    reflection's color alone."""
    from ugrt_torch.api.renderer import render_frame, render_frame_reflective

    cfg = bridge.render_config(tiny_cfg)
    sc = bridge.scene(cornell)
    t = bridge.scene_to_torch(sc, "cpu")
    cc = bridge.camcoords_to_torch(bridge.camera_spec(generic_camera),
                                   cfg.fovy_deg, 1.0, "cpu")
    lcc = bridge.camcoords_to_torch(bridge.camera_spec(generic_light),
                                    cfg.fovy_deg, 1.0, "cpu")[None]
    lp = bridge.from_numpy(generic_light.eye, "cpu", np.float32)
    args = (t["vertices"], t["faces"], t["mat_index"], t["materials"], cc,
            lcc, lp)
    kw = dict(cfg=cfg, capacity=cfg.pair_capacity(sc.num_faces),
              num_lights=1, use_spot=False)
    plain = render_frame(*args, **kw)
    none = render_frame_reflective(*args, **kw, reflectivity=0.0,
                                   uniform_dims=(8, 8, 8))
    full = render_frame_reflective(*args, **kw, reflectivity=1.0,
                                   uniform_dims=(8, 8, 8))
    assert torch.equal(none["color"], plain["color"])
    hit = full["reflection"]["face_id"] >= 0
    assert hit.float().mean() > 0.3
    assert (full["color"][~hit] == 0).all() and full["color"][hit].sum() > 0


def test_dda_edge_case_matches_ugrt(small_cfg):
    """ugrt's trace_uniform_dda and the port's on the DDA's edge case: both
    overflow (one cell holds more than 2 batches of 4), face ids and t
    within the bounds above, and the axis-aligned rays that reach the
    coincident pair take its first face (CSR order) in both."""
    case = dda_edge.dda_edge_case(0)
    dims, kw = dda_edge.DIMS, dict(max_batches=dda_edge.MAX_BATCHES,
                                   batch=dda_edge.BATCH)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    ug = gbuild_j.build_uniform_grid(j["vertices"], j["faces"], j["lo"],
                                     j["hi"], grid_dims=dims,
                                     capacity=dda_edge.CAPACITY)
    want = treflect_j.trace_uniform_dda(
        j["vertices"], j["faces"], ug, j["origins"], j["dirs"], j["active"],
        j["exclude"], j["lo"], j["hi"], dims, small_cfg, **kw)
    t = {k: _t(v) for k, v in case.items()}
    grid = gbuild_t.build_uniform_grid(t["vertices"], t["faces"], t["lo"],
                                       t["hi"], grid_dims=dims,
                                       capacity=dda_edge.CAPACITY)
    got = treflect_t.trace_uniform_dda(
        t["vertices"], t["faces"], grid, t["origins"], t["dirs"],
        t["active"], t["exclude"], t["lo"], t["hi"], dims,
        bridge.render_config(small_cfg), **kw)
    assert bool(got["overflow"]) and bool(want["overflow"])
    f_w, f_g = np.asarray(want["face_id"]), got["face_id"].numpy()
    same = f_g == f_w
    assert same.mean() >= 0.999, f"{(~same).sum()} face ids differ"
    np.testing.assert_allclose(got["t"].numpy()[same],
                               np.asarray(want["t"])[same], rtol=1e-5)
    hits = f_g >= 0
    assert hits.sum() > 500 and (~case["active"] <= (f_g == -2)).all()
    first = case["faces"].shape[0] - 12      # the pair, then 10 wall faces
    down = np.all(case["dirs"][:, :2] == 0, axis=1)
    on_pair = down & ((f_w == first) | (f_w == first + 1))
    assert on_pair.sum() > 100 and (f_g[on_pair] == first).all()
    assert (f_w[on_pair] == first).all()


def _edge_kw(cfg):
    return dict(cfg=bridge.render_config(cfg),
                max_batches=dda_edge.MAX_BATCHES, eps=1e-4,
                batch=dda_edge.BATCH, skip_k=6)


def test_uniform_dda_on_cpu_is_its_plain_version(small_cfg):
    """The D1 wrapper on CPU tensors returns its plain version's result
    bit for bit and counts no launch; ``steps`` is a 0-d int32 tensor;
    wrong inputs and devices raise instead of falling back; the
    measurement aid runs only on a card; the kernel maps 8x4 pixel tiles
    only where they cover the rays."""
    args = dda_edge.dda_edge_inputs("cpu")
    kw = _edge_kw(small_cfg)
    before = kdda.uniform_dda.launches
    got = kdda.uniform_dda(*args, **kw)
    want = kdda.uniform_dda_plain(*args, **kw)
    assert kdda.uniform_dda.launches == before
    assert torch.equal(got["t"].view(torch.int32),
                       want["t"].view(torch.int32))
    for key in ("face_id", "overflow", "steps"):
        assert torch.equal(got[key], want[key]), key
    assert got["steps"].dtype == torch.int32 and got["steps"].dim() == 0
    assert 0 < int(got["steps"]) <= sum(dda_edge.DIMS)

    ftab, grid, origins, dirs, active, excl, lo, hi, dims = args
    with pytest.raises(ValueError, match="unsupported device"):
        kdda.uniform_dda(ftab.to("meta"), grid._replace(**{
            f: getattr(grid, f).to("meta") for f in grid._fields}),
            *(x.to("meta") for x in (origins, dirs, active, excl, lo, hi)),
            dims, **kw)
    with pytest.raises(TypeError):
        kdda.uniform_dda(ftab, grid, origins.double(), dirs, active, excl,
                         lo, hi, dims, **kw)
    with pytest.raises(ValueError):
        kdda.uniform_dda(ftab[:, :8].contiguous(), grid, origins, dirs,
                         active, excl, lo, hi, dims, **kw)
    with pytest.raises(ValueError, match="batch"):
        kdda.uniform_dda(*args, **dict(kw, batch=0))
    with pytest.raises(ValueError, match="CUDA kernel"):
        kdda.uniform_dda_stats(*args, **kw)
    # The kernel's 8x4 pixel tiles: only where they cover the rays.
    assert kdda._tile_width(1024 * 1024, 1024) == 1024
    assert kdda._tile_width(4096, None) == kdda._tile_width(4096, 12) == 0
    assert kdda._tile_width(64 * 60, 64) == 64
    assert kdda._tile_width(64 * 62, 64) == 0


def test_face_table_pads_ugrt_rows(small_cfg):
    """The port's face table is ugrt's [F, 9] (v0, e1, e2) rows
    (ugrt/trace/reflect.py:101-103) bit for bit in its first nine
    columns, then three zero columns (D1 reads a row as three 16-byte
    loads); the plain DDA gives the same result, bitwise, on the padded
    table and on its first nine columns."""
    case = dda_edge.dda_edge_case(0)
    fv = jnp.asarray(case["vertices"])[jnp.asarray(case["faces"])]
    want = np.asarray(jnp.concatenate(
        [fv[:, 0], fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]], axis=1))
    args = dda_edge.dda_edge_inputs("cpu")
    ftab = args[0]
    assert ftab.shape == (case["faces"].shape[0], kdda.FACE_COLS) == (
        want.shape[0], 12)
    np.testing.assert_array_equal(ftab[:, :9].numpy().view(np.int32),
                                  want.view(np.int32))
    assert not ftab[:, 9:].any()
    kw = _edge_kw(small_cfg)
    padded = kdda.uniform_dda_plain(*args, **kw)
    nine = kdda.uniform_dda_plain(ftab[:, :9].contiguous(), *args[1:], **kw)
    for key in ("t", "face_id", "overflow", "steps"):
        assert torch.equal(padded[key], nine[key]), key
    assert int((padded["face_id"] >= 0).sum()) > 500


def test_dda_rays_are_independent(small_cfg):
    """A ray's (t, face) depends on that ray alone: the plain version on
    a shuffled half of the edge case's rays gives those rays' results of
    the whole run, bit for bit, though it compacts other sets at other
    steps.  D1 runs each ray in its own thread on this contract."""
    args = dda_edge.dda_edge_inputs("cpu", seed=1)
    kw = _edge_kw(small_cfg)
    full = kdda.uniform_dda_plain(*args, **kw)
    ftab, grid, origins, dirs, active, excl, lo, hi, dims = args
    pick = torch.from_numpy(np.random.default_rng(1).permutation(
        origins.shape[0])[:origins.shape[0] // 2])
    half = kdda.uniform_dda_plain(
        ftab, grid, *(x[pick].contiguous() for x in (origins, dirs, active,
                                                      excl)),
        lo, hi, dims, **kw)
    assert torch.equal(half["t"].view(torch.int32),
                       full["t"][pick].view(torch.int32))
    assert torch.equal(half["face_id"], full["face_id"][pick])
    assert int((half["face_id"] >= 0).sum()) > 200
