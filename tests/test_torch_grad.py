"""ugrt_torch's differentiable step (render_color, render_and_grad,
refine_primary, face_shade_meta) against ugrt's, and the port's own
finite-difference checks, on tests/test_grad.py's scenes (the tilted
single triangle and the rotated Cornell box) at tiny_cfg (64², 8x8 grid).

Tolerances, with their reasons:
- color: |diff| <= 4e-6 (color <= 1): ugrt's jitted forward contracts
  multiply-adds into FMAs (ROADMAP Queue 3), the port rounds every op.
- loss: rtol 1e-5, atol 1e-7 (the ROADMAP's contract).
- gradients: |diff| <= 1e-5 * max|g|, elementwise: f32 sums in another
  order (ugrt's sort/prefix-sum VJPs against autograd's index
  accumulation), the port's f64 sqrt and ugrt's FMA-contracted forward.
- Cornell grad_vertices: the box's floor and ceiling normals have an
  exactly zero x component, on the kink of the |normal| quirk.  ugrt's
  jitted step contracts the cross product into FMAs and leaves a residue
  of either sign there, so its vertex gradient depends on XLA's fusion
  (off by up to half of max|g| from ugrt's own op-by-op gradient).  The
  port follows ugrt op by op (vecmath.absolute: d|x|/dx = +1 at 0, as
  JAX's abs), so it is held to that everywhere and to the jitted step on
  the vertices of no kink face.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from test_grad import _cornell_setup, _interior_mask, _setup

from ugrt.api import renderer as rapi
from ugrt.core import camera as cam
from ugrt.diff import render_grad as rg_j
from ugrt.shade import shaders as sh_j
from ugrt.trace import refine as refine_j
from ugrt_torch import bridge
from ugrt_torch.diff import render_grad as rg_t
from ugrt_torch.shade import shaders as sh_t
from ugrt_torch.trace import refine as refine_t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

COLOR_ATOL = 4e-6
GRAD_REL = 1e-5
SETUPS = {"tri": _setup, "cornell": _cornell_setup}
# num_lights=2 adds a light beside each scene's own.
SECOND_LIGHT = {
    "tri": cam.CameraSpec(eye=(-0.6, 1.2, 0.8), look_at=(0.0, 0.0, -3.0),
                          up=(0.0, 1.0, 0.0), near=0.1, far=100.0),
    "cornell": cam.CameraSpec(eye=(0.35, 0.8, -0.1), look_at=(0.0, -1.0, 0.0),
                              up=(0.0, 0.0, 1.0), near=0.1, far=100.0)}


def _t(a, dtype=None):
    return bridge.from_numpy(np.asarray(a), "cpu", dtype)


class Case:
    """One scene's inputs for ugrt (jnp) and the port (CPU tensors)."""

    def __init__(self, cfg, scene, num_lights=1, use_spot=False):
        sc, cc, lcc, lp = SETUPS[scene](cfg)
        if num_lights == 2:
            lcc = jnp.concatenate([lcc, jnp.asarray(cam.camcoords_from_spec(
                SECOND_LIGHT[scene], cfg.fovy_deg,
                cfg.screen_width / cfg.screen_height))[None]])
        self.cfg, self.sc, self.nl, self.spot = cfg, sc, num_lights, use_spot
        self.cap = cfg.pair_capacity(sc.num_faces)
        self.target = np.random.default_rng(0).uniform(
            0.0, 0.3, (cfg.screen_height, cfg.screen_width, 3)).astype(
                np.float32)
        self.j = dict(vertices=jnp.asarray(sc.vertices),
                      materials=jnp.asarray(sc.materials),
                      faces=jnp.asarray(sc.faces),
                      mat_index=jnp.asarray(sc.mat_index), camcoords=cc,
                      light_camcoords=lcc, light_position=lp)
        self.t = dict(vertices=_t(sc.vertices, np.float32),
                      materials=_t(sc.materials, np.float32),
                      faces=_t(sc.faces, np.int32),
                      mat_index=_t(sc.mat_index, np.int32), camcoords=_t(cc),
                      light_camcoords=_t(lcc), light_position=_t(lp))
        self.kw = dict(cfg=cfg, capacity=self.cap, num_lights=num_lights,
                       use_spot=use_spot)
        self.cfg_t = bridge.render_config(cfg)
        self.kw_t = dict(self.kw, cfg=self.cfg_t)

    def color_t(self, vertices=None, materials=None, capacity=None):
        a = dict(self.t)
        a["vertices"] = a["vertices"] if vertices is None else vertices
        a["materials"] = a["materials"] if materials is None else materials
        kw = dict(self.kw_t, capacity=capacity or self.cap)
        return rg_t.render_color(**a, **kw)

    def step_t(self, materials=None, capacity=None):
        a = dict(self.t)
        a["materials"] = a["materials"] if materials is None else materials
        kw = dict(self.kw_t, capacity=capacity or self.cap)
        return rg_t.render_and_grad(**a, target=_t(self.target), **kw)

    def step_j(self):
        return rg_j.render_and_grad(**self.j, target=jnp.asarray(self.target),
                                    **self.kw)


def _kink_vertices(sc):
    """Vertices of faces whose normal has a component within 1e-6 of 0
    (the |normal| kink; see the module docstring)."""
    v = sc.vertices[sc.faces].astype(np.float64)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    kink = (np.abs(n) < 1e-6).any(axis=1)
    out = np.zeros(sc.vertices.shape[0], bool)
    out[np.unique(sc.faces[kink])] = True
    return out


def _close_grads(got, want, rows=slice(None)):
    got, want = np.asarray(got), np.asarray(want)
    tol = GRAD_REL * np.abs(want).max()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=tol)


def test_face_shade_meta_matches_ugrt(cornell):
    mi = cornell.mat_index.copy()
    mi[::5] = cornell.materials.shape[0]          # out of range: invalid
    want = sh_j.face_shade_meta(jnp.asarray(mi), cornell.materials.shape[0],
                                jnp)
    got = sh_t.face_shade_meta(_t(mi), cornell.materials.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1] == 0).sum() == len(mi[::5])


def test_refine_primary_matches_ugrt(tiny_cfg):
    """Forward bit for bit, and the VJP of random cotangents on t, normal,
    u and v within GRAD_REL of ugrt's, kink faces included."""
    case = Case(tiny_cfg, "cornell", use_spot=True)
    out = rapi.render_frame_device(**{k: case.j[k] for k in (
        "vertices", "faces", "mat_index", "materials", "camcoords",
        "light_camcoords", "light_position")}, **case.kw)
    raw = out["primary"]
    meta_j = sh_j.face_shade_meta(case.j["mat_index"], 3, jnp)
    rng = np.random.default_rng(1)
    H, W = raw["face_id"].shape
    w = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("t", (H, W)), ("normal", (H, W, 3)), ("u", (H, W)), ("v", (H, W)))}

    def loss_j(v):
        r = refine_j.refine_primary(v, case.j["faces"], case.j["camcoords"],
                                    raw, case.cfg, face_aux=meta_j)
        return sum(jnp.sum(r[k] * w[k]) for k in w), r

    (_, r_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        case.j["vertices"])
    v = case.t["vertices"].clone().requires_grad_(True)
    raw_t = {k: _t(raw[k]) for k in ("face_id", "ray_dir")}
    r_t = refine_t.refine_primary(
        v, case.t["faces"], case.t["camcoords"], raw_t, case.cfg_t,
        face_aux=sh_t.face_shade_meta(case.t["mat_index"], 3))
    sum(torch.sum(r_t[k] * _t(w[k])) for k in w).backward()
    hit = np.asarray(raw["face_id"]) >= 0
    for k in ("t", "normal", "aux"):
        np.testing.assert_array_equal(r_t[k].detach().numpy(),
                                      np.asarray(r_j[k]), err_msg=k)
    for k in ("u", "v"):
        np.testing.assert_array_equal(r_t[k].detach().numpy()[hit],
                                      np.asarray(r_j[k])[hit], err_msg=k)
    assert (np.asarray(r_j["t"])[~hit] == -1).all()
    _close_grads(v.grad.numpy(), g_j)


@pytest.mark.parametrize("scene,use_spot,num_lights", [
    ("tri", False, 1), ("tri", True, 2), ("cornell", False, 2)])
def test_render_and_grad_matches_ugrt(tiny_cfg, scene, use_spot,
                                      num_lights):
    case = Case(tiny_cfg, scene, num_lights, use_spot)
    want = case.step_j()
    got = case.step_t()
    np.testing.assert_allclose(got["color"].numpy(), np.asarray(want["color"]),
                               rtol=0, atol=COLOR_ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    assert float(got["loss"]) > 0
    assert bool(got["overflow"]) == bool(want["overflow"]) is False
    _close_grads(got["grad_materials"].numpy(), want["grad_materials"])
    off_kink = ~_kink_vertices(case.sc)
    assert off_kink.sum() >= 3
    _close_grads(got["grad_vertices"].numpy(), want["grad_vertices"],
                 off_kink)
    # render_color returns the step's color, shadows and all.
    color, overflow = case.color_t()
    assert torch.equal(color, got["color"]) and not bool(overflow)


def test_cornell_vertex_grad_matches_ugrt_op_by_op(tiny_cfg):
    """All vertices, kink faces included, against ugrt's step evaluated
    op by op: its trace and shadows (render_frame_device, jitted; no
    gradient flows through them) and then ugrt's refine, spotlight,
    add_shadows_f32 and MSE under jax.value_and_grad without jit."""
    case = Case(tiny_cfg, "cornell", use_spot=True)
    j = case.j
    out = rapi.render_frame_device(**{k: j[k] for k in (
        "vertices", "faces", "mat_index", "materials", "camcoords",
        "light_camcoords", "light_position")}, **case.kw)
    raw, shadowed = out["primary"], out["shadowed"]
    target = jnp.asarray(case.target)

    def loss(v, m):
        refined = refine_j.refine_primary(
            v, j["faces"], j["camcoords"], raw, case.cfg,
            face_aux=sh_j.face_shade_meta(j["mat_index"], m.shape[0], jnp))
        color = sh_j.spotlight(refined, j["light_camcoords"][0],
                               j["light_position"], j["camcoords"][0:3],
                               j["mat_index"], m, case.cfg, xp=jnp)
        color = sh_j.add_shadows_f32(color, shadowed, xp=jnp)
        return jnp.mean((color - target) ** 2)

    loss_j, (gv, gm) = jax.value_and_grad(loss, argnums=(0, 1))(
        j["vertices"], j["materials"])
    got = case.step_t()
    kink = _kink_vertices(case.sc)
    assert kink.any()
    np.testing.assert_allclose(float(got["loss"]), float(loss_j), rtol=1e-5,
                               atol=1e-7)
    _close_grads(got["grad_vertices"].numpy(), gv)
    _close_grads(got["grad_materials"].numpy(), gm)
    # The jitted step agrees off the kink and there only.
    jitted = np.asarray(case.step_j()["grad_vertices"])
    _close_grads(got["grad_vertices"].numpy(), jitted, ~kink)
    assert np.abs(jitted - gv)[kink].max() > 100 * GRAD_REL * np.abs(gv).max()


# --- the port's own finite-difference checks (test_grad.py's, on the
# port: FD in float64 sums of its float32 render) -----------------------

def _sum(x, mask=None):
    return float((x.double() if mask is None else x.double() * mask).sum())


def test_material_gradient_matches_fd(tiny_cfg):
    case = Case(tiny_cfg, "tri")
    m = case.t["materials"].clone().requires_grad_(True)
    case.color_t(materials=m)[0].sum().backward()
    eps = 1e-3
    for slot in range(6):
        mp, mm = m.detach().clone(), m.detach().clone()
        mp[0, slot] += eps
        mm[0, slot] -= eps
        fd = (_sum(case.color_t(materials=mp)[0])
              - _sum(case.color_t(materials=mm)[0])) / (2 * eps)
        assert abs(fd - float(m.grad[0, slot])) < 1e-2 * max(1.0, abs(fd))


def test_vertex_gradient_matches_fd(tiny_cfg):
    case = Case(tiny_cfg, "tri")
    base = case.color_t()[0]
    interior = ndimage.binary_erosion(base.sum(-1).numpy() > 0, iterations=3)
    mask = _t(interior[..., None].astype(np.float32))
    v = case.t["vertices"].clone().requires_grad_(True)
    (case.color_t(vertices=v)[0] * mask).sum().backward()
    eps = 1e-3
    for vi in range(3):
        for axis in range(3):
            vp, vm = v.detach().clone(), v.detach().clone()
            vp[vi, axis] += eps
            vm[vi, axis] -= eps
            fd = (_sum(case.color_t(vertices=vp)[0], mask)
                  - _sum(case.color_t(vertices=vm)[0], mask)) / (2 * eps)
            ad = float(v.grad[vi, axis])
            assert abs(fd - ad) < max(2e-2 * abs(fd), 0.5), (vi, axis, fd, ad)


def test_cornell_material_gradient_matches_fd(tiny_cfg):
    case = Case(tiny_cfg, "cornell")
    m = case.t["materials"].clone().requires_grad_(True)
    case.color_t(materials=m)[0].sum().backward()
    g = m.grad.numpy()
    assert (np.abs(g).sum(axis=1) > 0).sum() >= 2
    eps = 1e-3
    for mi in range(min(3, g.shape[0])):
        for slot in (3, 4):
            mp, mm = m.detach().clone(), m.detach().clone()
            mp[mi, slot] += eps
            mm[mi, slot] -= eps
            fd = (_sum(case.color_t(materials=mp)[0])
                  - _sum(case.color_t(materials=mm)[0])) / (2 * eps)
            assert abs(fd - g[mi, slot]) < 5e-2 * max(1.0, abs(fd))


def test_cornell_vertex_gradient_matches_fd(tiny_cfg):
    """The largest-|grad| coordinates where FD is converged (stable over
    a 4x change of eps), interior pixels of every winning face only."""
    case = Case(tiny_cfg, "cornell")
    from ugrt_torch.grid import build as gbuild
    from ugrt_torch.trace import primary as tprimary
    grid = gbuild.build_perspective_grid(
        case.t["vertices"], case.t["faces"], case.t["camcoords"],
        cfg=case.cfg_t, capacity=case.cap)
    raw = tprimary.trace_primary(case.t["vertices"], case.t["faces"],
                                 case.t["camcoords"], grid, case.cfg_t)
    mask = _t(_interior_mask(raw["face_id"].numpy())[..., None].astype(
        np.float32))
    v = case.t["vertices"].clone().requires_grad_(True)
    (case.color_t(vertices=v)[0] * mask).sum().backward()
    g = v.grad.numpy()
    assert np.abs(g).max() > 0

    def fd_at(vi, axis, eps):
        vp, vm = v.detach().clone(), v.detach().clone()
        vp[vi, axis] += eps
        vm[vi, axis] -= eps
        return (_sum(case.color_t(vertices=vp)[0], mask)
                - _sum(case.color_t(vertices=vm)[0], mask)) / (2 * eps)

    checked = 0
    for lin in np.argsort(-np.abs(g).ravel())[:8]:
        vi, axis = divmod(int(lin), 3)
        fd1, fd2 = fd_at(vi, axis, 1e-3), fd_at(vi, axis, 2.5e-4)
        if abs(fd1 - fd2) > 5e-2 * max(abs(fd1), 1.0):
            continue            # a winner flips inside eps: FD measures a jump
        assert abs(fd1 - g[vi, axis]) < max(5e-2 * abs(fd1), 0.5)
        checked += 1
    assert checked >= 3


def test_shadowed_pixel_gradient_matches_fd(tiny_cfg):
    """Material gradients of shadowed pixels carry the 1/3 of the f32
    darkening; the mask itself is piecewise constant (no gradient)."""
    case = Case(tiny_cfg, "cornell")
    from ugrt_torch.api.renderer import render_frame
    out = render_frame(case.t["vertices"], case.t["faces"],
                       case.t["mat_index"], case.t["materials"],
                       case.t["camcoords"], case.t["light_camcoords"],
                       case.t["light_position"], **case.kw_t)
    shmask = out["shadowed"].numpy() == 1
    assert shmask.sum() > 0
    wm = _t(shmask[..., None].astype(np.float32))
    m = case.t["materials"].clone().requires_grad_(True)
    (case.color_t(materials=m)[0] * wm).sum().backward()
    g = m.grad.numpy()
    assert np.abs(g).max() > 0
    eps = 1e-3
    for lin in np.argsort(-np.abs(g).ravel())[:3]:
        mi, slot = divmod(int(lin), 6)
        mp, mm = m.detach().clone(), m.detach().clone()
        mp[mi, slot] += eps
        mm[mi, slot] -= eps
        fd = (_sum(case.color_t(materials=mp)[0], wm)
              - _sum(case.color_t(materials=mm)[0], wm)) / (2 * eps)
        assert abs(fd - g[mi, slot]) < 5e-2 * max(1.0, abs(fd))


def test_grad_zero_when_miss(tiny_cfg):
    case = Case(tiny_cfg, "tri")
    miss = _t((case.color_t()[0].sum(-1).numpy() == 0)[..., None].astype(
        np.float32))
    assert miss.sum() > 0
    v = case.t["vertices"].clone().requires_grad_(True)
    (case.color_t(vertices=v)[0] * miss).sum().backward()
    assert float(v.grad.abs().max()) == 0.0


def test_step_decreases_loss(tiny_cfg):
    """Loss decreases along -grad_materials toward a target rendered
    with half the materials."""
    case = Case(tiny_cfg, "tri")
    case.target = case.color_t(
        materials=case.t["materials"] * 0.5)[0].detach().numpy()
    out = case.step_t()
    assert float(out["loss"]) > 0 and out["grad_materials"].abs().sum() > 0
    out2 = case.step_t(materials=case.t["materials"]
                       - 0.5 * out["grad_materials"])
    assert float(out2["loss"]) < float(out["loss"])


def test_overflow_flag_reaches_caller(tiny_cfg):
    case = Case(tiny_cfg, "cornell")
    assert bool(case.step_t(capacity=128)["overflow"])
    assert not bool(case.step_t()["overflow"])


def test_step_needs_no_grad_mode_and_leaves_inputs_alone(tiny_cfg):
    """render_and_grad works under torch.no_grad and neither needs nor
    changes requires_grad on the caller's tensors."""
    case = Case(tiny_cfg, "tri")
    with torch.no_grad():
        out = case.step_t()
    assert out["grad_vertices"].shape == case.t["vertices"].shape
    assert out["grad_materials"].abs().sum() > 0
    assert not case.t["vertices"].requires_grad
    assert out["color"].grad_fn is None and out["loss"].grad_fn is None


@pytest.mark.parametrize("rows,width", [(5, 6), (300, 3)])
def test_gather_rows_backward_is_exact_in_any_order(rows, width):
    """gather_rows's backward (the fixed-point segment sum) is within its
    bound of the f64 sum, and bitwise the same for the pixels in another
    order; the forward is plain indexing."""
    from ugrt_torch.core.gather import gather_rows

    rng = np.random.default_rng(rows)
    table = torch.tensor(rng.normal(size=(rows, width)), dtype=torch.float32,
                         requires_grad=True)
    idx = rng.integers(0, rows, size=(64, 48))
    idx[0, 0] = rows - 1
    cot = rng.normal(size=(64, 48, width)).astype(np.float32)
    # Cotangents across 20 binades, the largest one alone.
    cot *= np.float32(2.0) ** rng.integers(-20, 0, size=(64, 48, 1))
    cot[3, 4] = 1e3
    out = gather_rows(table, torch.from_numpy(idx))
    assert torch.equal(out, table[torch.from_numpy(idx)])
    (got,) = torch.autograd.grad(out, table, torch.from_numpy(cot))
    want = np.zeros((rows, width))
    np.add.at(want, idx.ravel(), cot.reshape(-1, width).astype(np.float64))
    bound = idx.size * 2.0 ** -62 * np.abs(cot).astype(np.float64).sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -24, atol=bound)
    perm = rng.permutation(idx.size)
    out2 = gather_rows(table, torch.from_numpy(idx.ravel()[perm]))
    (got2,) = torch.autograd.grad(out2, table, torch.from_numpy(
        cot.reshape(-1, width)[perm]))
    assert torch.equal(got, got2)
