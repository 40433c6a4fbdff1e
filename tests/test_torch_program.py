"""ugrt_torch's captured programs (core.program): the frame
``render_frame_device``, the reflective frame ``render_frame_reflective``,
the step ``render_and_grad`` and the sharded frame and step
(``dist.mesh.sharded_render``, ``sharded_train_step``) on the CPU.

Two kinds of test:
- The capture-safety guard.  A CUDA graph records stream work only: a
  host read (``item``, ``bool(t)``, a boolean mask, ``nonzero``, a
  ``repeat_interleave`` without ``output_size``) or a tensor made from
  host values (``torch.tensor``) inside a captured body stops the
  capture on the card.  The bodies run here under a recording
  ``TorchFunctionMode`` and a ``TorchDispatchMode`` (which also sees the
  backward's ops), and any such call fails the test with its line.  The
  CPU branches of the sweeps and of the reflection DDA D1 are exempt:
  their plain versions stand in for one kernel launch each.  The sharded
  bodies run on a gloo process group of one rank, so that their
  collectives run too (with no group they return at once).
- ``Program`` on the CPU: the same input binding and output cloning as
  on the card, with an eager call in place of the replay; the frames
  and steps bitwise equal to the eager functions', and held to ugrt's
  jitted ones.

Tolerance: none for frames and the step against eager (the program runs
the same function on copies of the inputs).  Against ugrt, the step
keeps tests/test_torch_grad.py's bounds, and the reflective frame
tests/test_torch_reflect.py's (at most 0.1% of u8 pixels differ, >=
99.9% of reflection face ids equal, the shadow mask exact).
"""

import dataclasses
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_grad import COLOR_ATOL, Case, _close_grads, _kink_vertices

from ugrt.api.renderer import Renderer as RendererJax
from ugrt.core import camera as cam
from ugrt_torch import bridge
from ugrt_torch.api import renderer as rapi
from ugrt_torch.core.program import Program
from ugrt_torch.diff import render_grad as rg_t
from ugrt_torch.dist import mesh as dmesh
from ugrt_torch.scene import model, procedural
from ugrt_torch.trace import primary as tprimary
from ugrt_torch.trace import reflect as treflect
from ugrt_torch.trace import shadow as tshadow
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FRAME_STATIC = ("cfg", "capacity", "num_lights", "use_spot")
REFLECT_DIMS = (8, 8, 8)
LIGHT = cam.CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                       up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
SECOND_LIGHT = cam.CameraSpec(eye=(-0.6, 0.5, 0.9), look_at=(0.2, -1.0, 0.0),
                              up=(0, 0, 1), near=0.1, far=100.0)
OTHER_CAMERA = cam.CameraSpec(eye=(0.3, -0.1, 2.2), look_at=(0.0, 0.05, 0.0),
                              up=(0.0, 1.0, 0.02), near=0.1, far=100.0)

# Tensors made from host values: on the card each is a copy from
# pageable host memory, which a capture refuses.
HOST_FACTORIES = (torch.tensor, torch.as_tensor, torch.asarray,
                  torch.from_numpy)
# Tensor methods and ops that read device data on the host.
HOST_METHODS = {"item", "tolist", "__bool__", "__int__", "__float__",
                "__index__", "numpy", "cpu"}
HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select"}
MASK_OPS = {"index", "index_put", "_index_put_impl"}   # nonzero inside
GUARD_FRAMES = {"record", "__torch_function__", "__torch_dispatch__"}


class HostReadGuard:
    """Records every host read and host-made tensor of the code run
    inside ``with guard:``, by the port's file and line; ``exempt(fn)``
    wraps ``fn`` so that nothing is recorded while it runs."""

    def __init__(self):
        self.found = []
        self.paused = 0
        guard = self

        class Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", "")
                if func in HOST_FACTORIES:
                    guard.record(f"torch.{name}")
                elif name == "new_tensor":
                    guard.record("Tensor.new_tensor")
                elif name in HOST_METHODS:
                    guard.record(f"Tensor.{name}")
                elif name == "__getitem__" and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in _index_items(args[1])):
                    guard.record("boolean mask __getitem__")
                elif (name == "repeat_interleave"
                      and kwargs.get("output_size") is None):
                    guard.record("repeat_interleave without output_size")
                return func(*args, **kwargs)

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.overloadpacket.__name__
                if name in HOST_OPS:
                    guard.record(f"aten.{name}")
                elif name in MASK_OPS and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in args[1]):
                    guard.record(f"aten.{name} with a boolean mask")
                elif (name == "repeat_interleave"
                      and kwargs.get("output_size") is None):
                    guard.record("aten.repeat_interleave without "
                                 "output_size")
                return func(*args, **kwargs)

        self.modes = (Functions(), Ops())

    def record(self, what):
        if self.paused:
            return
        frames = [f for f in traceback.extract_stack()
                  if ("ugrt_torch" in f.filename
                      or "test_torch_program" in f.filename)
                  and f.name not in GUARD_FRAMES]
        where = f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"
        self.found.append(f"{what} at {where}")

    def exempt(self, fn):
        def call(*args, **kwargs):
            self.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.paused -= 1
        return call

    def __enter__(self):
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)


def _index_items(index):
    return index if isinstance(index, tuple) else (index,)


@pytest.fixture
def guard(monkeypatch):
    """A HostReadGuard with the three sweeps and the DDA D1 exempt where
    the trace calls them."""
    g = HostReadGuard()
    for mod, name in ((tprimary, "primary_sweep"),
                      (tprimary, "heavy_primary_sweep"),
                      (tshadow, "shadow_sweep"),
                      (treflect, "uniform_dda")):
        monkeypatch.setattr(mod, name, g.exempt(getattr(mod, name)))
    return g


def _frame_args(cfg, scene, camera, lights):
    """render_frame's tensor arguments on the CPU (lights as the
    Renderer stacks them: a zero row when there are none)."""
    t = bridge.scene_to_torch(scene, "cpu")
    aspect = cfg.screen_width / cfg.screen_height
    cc = bridge.camcoords_to_torch(camera, cfg.fovy_deg, aspect, "cpu")
    lccs = (torch.stack([bridge.camcoords_to_torch(s, cfg.fovy_deg, aspect,
                                                   "cpu") for s in lights])
            if lights else torch.zeros((1, 64), dtype=torch.float32))
    return dict(vertices=t["vertices"], faces=t["faces"],
                mat_index=t["mat_index"], materials=t["materials"],
                camcoords=cc, light_camcoords=lccs,
                light_position=bridge.from_numpy((0.13, 0.87, 0.52), "cpu",
                                                 np.float32))


def _frame_kw(cfg, scene, lights, use_spot):
    return dict(cfg=cfg, capacity=cfg.pair_capacity(scene.num_faces),
                num_lights=len(lights), use_spot=use_spot)


def _frame_leaves(out):
    """The frame's results that chip_smoke compares: image, color,
    shadowed, primary t and face_id, overflow."""
    return dict(image=out["image"], color=out["color"],
                shadowed=out["shadowed"], t=out["primary"]["t"],
                face_id=out["primary"]["face_id"], overflow=out["overflow"])


def _assert_bitwise(got, want):
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.is_floating_point():
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), key
        else:
            assert torch.equal(g, w), key


# ---------------------------------------------------------------------------
# The capture-safety guard


def test_guard_sees_every_kind_of_host_read(guard):
    """The guard itself: each kind of host read, also in a backward, and
    nothing in the exempt call."""
    x = torch.arange(6.0, requires_grad=True)
    mask = x > 2

    class ReadsInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            return g * g.masked_select(g > 0).sum()

    with guard:
        x.sum().item()
        _ = x.detach()[mask]
        torch.nonzero(mask)
        torch.repeat_interleave(torch.tensor([1, 2]))
        torch.as_tensor(1.0)
        x.new_tensor([1.0, 2.0])
        int(torch.ones((), dtype=torch.int64))
        torch.autograd.grad(ReadsInBackward.apply(x).sum(), x)
    found = "\n".join(guard.found)
    for what in ("Tensor.item", "aten._local_scalar_dense",
                 "boolean mask __getitem__", "aten.index with a boolean mask",
                 "aten.nonzero",
                 "repeat_interleave without output_size", "torch.tensor",
                 "torch.as_tensor", "Tensor.new_tensor", "Tensor.__int__",
                 "aten.masked_select"):
        assert what in found, what
    n = len(guard.found)
    with guard:
        guard.exempt(lambda: x.sum().item())()
        torch.repeat_interleave(torch.ones(2, dtype=torch.int64),
                                output_size=2)
    assert len(guard.found) == n


@pytest.mark.parametrize("use_spot", [False, True], ids=["lambert", "spot"])
@pytest.mark.parametrize("num_lights", [0, 1, 2])
@pytest.mark.parametrize("mode", ["windowed", "reference", "extent"])
def test_frame_is_capture_safe(guard, tiny_cfg, mode, num_lights, use_spot):
    """render_frame reads nothing on the host and makes no tensor from
    host values, in every light-grid mode, with 0, 1 and 2 lights."""
    cfg = bridge.render_config(dataclasses.replace(tiny_cfg,
                                                   light_grid_mode=mode))
    scene = procedural.cornell_box(subdiv=2)
    lights = [bridge.camera_spec(s) for s in (
        cam.CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                       up=(0.0, 0.0, 1.0), near=0.1, far=100.0),
        SECOND_LIGHT)][:num_lights]
    args = _frame_args(cfg, scene, bridge.camera_spec(OTHER_CAMERA), lights)
    with guard:
        out = rapi.render_frame(**args, **_frame_kw(cfg, scene, lights,
                                                     use_spot))
    assert guard.found == []
    assert out["image"].shape == (64, 64, 3)


@pytest.mark.parametrize("use_spot", [False, True], ids=["lambert", "spot"])
@pytest.mark.parametrize("mode", ["windowed", "reference"])
def test_reflective_frame_is_capture_safe(guard, tiny_cfg, mode, use_spot):
    """render_frame_reflective's eager body (the plain frame, the uniform
    grid, the reflection rays and their shading) reads nothing on the
    host and makes no tensor from host values."""
    cfg = bridge.render_config(dataclasses.replace(tiny_cfg,
                                                   light_grid_mode=mode))
    scene = procedural.cornell_box(subdiv=2)
    lights = [bridge.camera_spec(LIGHT)]
    args = _frame_args(cfg, scene, bridge.camera_spec(OTHER_CAMERA), lights)
    with guard:
        out = rapi.render_frame_reflective.fn(
            **args, **_frame_kw(cfg, scene, lights, use_spot),
            uniform_dims=REFLECT_DIMS)
    assert guard.found == []
    assert int((out["reflection"]["face_id"] >= 0).sum()) > 1000


@pytest.mark.parametrize("scene,use_spot,num_lights", [
    ("tri", True, 1), ("cornell", False, 2)])
def test_step_is_capture_safe(guard, tiny_cfg, scene, use_spot, num_lights):
    """render_and_grad's body, forward and backward, reads nothing on
    the host and makes no tensor from host values."""
    case = Case(tiny_cfg, scene, num_lights, use_spot)
    with guard:
        out = rg_t.render_and_grad.fn(
            **case.t, target=torch.from_numpy(case.target), **case.kw_t)
    assert guard.found == []
    assert float(out["loss"]) > 0


@pytest.fixture
def gloo_mesh(tmp_path):
    """This process as a gloo process group of one rank (a FileStore
    under tmp_path) and its Mesh; the group is destroyed at teardown."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield dmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _sharded_args(cfg, target=True):
    """The sharded bodies' tensor arguments: the Cornell box from
    OTHER_CAMERA with LIGHT, and a seeded target."""
    scene = procedural.cornell_box(subdiv=2)
    a = _frame_args(cfg, scene, bridge.camera_spec(OTHER_CAMERA),
                    [bridge.camera_spec(LIGHT)])
    if target:
        a["target"] = torch.from_numpy(np.random.default_rng(0).uniform(
            0.0, 0.3, (cfg.screen_height, cfg.screen_width, 3)).astype(
                np.float32))
    return a, _frame_kw(cfg, scene, [LIGHT], True)


@pytest.mark.parametrize("mode", ["windowed", "reference", "extent"])
def test_sharded_render_is_capture_safe(guard, gloo_mesh, tiny_cfg, mode):
    """sharded_render's body (the strip, the window or extents reduced
    over the group, the gather, the overflow vote) reads nothing on the
    host and makes no tensor from host values."""
    cfg = bridge.render_config(dataclasses.replace(tiny_cfg,
                                                   light_grid_mode=mode))
    args, kw = _sharded_args(cfg, target=False)
    render = dmesh.sharded_render(gloo_mesh, **kw)
    assert isinstance(render, Program)
    assert render.capture_error_mode == "thread_local"
    with guard:
        image, overflow = render.fn(**args)
    assert guard.found == []
    assert image.shape == (64, 64, 3) and not bool(overflow)


@pytest.mark.parametrize("mode", ["windowed", "reference", "extent"])
def test_sharded_step_is_capture_safe(guard, gloo_mesh, tiny_cfg, mode):
    """sharded_train_step's body, forward, backward and the reductions of
    loss, gradients and overflow, reads nothing on the host and makes no
    tensor from host values."""
    cfg = bridge.render_config(dataclasses.replace(tiny_cfg,
                                                   light_grid_mode=mode))
    args, kw = _sharded_args(cfg)
    step = dmesh.sharded_train_step(gloo_mesh, **kw)
    assert isinstance(step, Program)
    assert step.capture_error_mode == "thread_local"
    with guard:
        loss, grad_v, grad_m, overflow = step.fn(**args)
    assert guard.found == []
    assert float(loss) > 0 and not bool(overflow)
    assert float(grad_m.abs().sum()) > 0


def test_guard_sees_a_host_tensor_in_a_sharded_body(guard, gloo_mesh,
                                                    tiny_cfg, monkeypatch):
    """A torch.tensor planted beside the sharded step's collectives is
    caught, and those collectives ran on the group."""
    import torch.distributed as dist

    calls = []
    reduce = dist.all_reduce

    def planted(tensor, *a, **k):
        calls.append(tensor.shape)
        torch.tensor(1.0)
        return reduce(tensor, *a, **k)

    monkeypatch.setattr(dist, "all_reduce", planted)
    cfg = bridge.render_config(dataclasses.replace(
        tiny_cfg, light_grid_mode="windowed"))
    args, kw = _sharded_args(cfg)
    with guard:
        dmesh.sharded_train_step(gloo_mesh, **kw).fn(**args)
    # The window's four bounds, loss, both gradients, overflow.
    assert len(calls) == 8
    assert len(guard.found) == 8
    assert all(f.startswith("torch.tensor at ") for f in guard.found)


# ---------------------------------------------------------------------------
# Program on the CPU


def test_program_binds_inputs_and_clones_outputs():
    """A toy body that returns its input and a view of it: each call's
    result is its own, the inputs are copied into the buffers (the
    caller's tensors are never handed to the body), and the static
    values and shapes key the cache."""
    seen = []

    def body(x, y, *, k: int):
        seen.append(x)
        return dict(same=x, scaled=[y * k, x[:1]])

    prog = Program(body, static=("k",))
    a, b = torch.arange(3.0), torch.ones(2)
    first = prog(a, b, k=2)
    second = prog(a + 10, b, k=2)
    assert seen[0] is not a and seen[0].data_ptr() == seen[1].data_ptr()
    assert torch.equal(first["same"], a)
    assert torch.equal(first["scaled"][1], a[:1])
    assert torch.equal(second["same"], a + 10)
    assert prog.cache_size() == 1
    prog(a, b, k=3)
    prog(torch.arange(4.0), b, k=3)
    assert prog.cache_size() == 3
    assert prog.fn is body and prog.__name__ == "body"
    with pytest.raises(TypeError, match="neither static nor a tensor"):
        prog(a, 1.0, k=2)
    with pytest.raises(ValueError, match="unsupported device"):
        prog(a.to("meta"), b.to("meta"), k=2)
    prog.clear()
    assert prog.cache_size() == 0


def test_render_frame_device_equals_eager(small_cfg, cornell, generic_camera,
                                         generic_light):
    """Two cameras in turn through render_frame_device, each bitwise the
    eager frame's; the first call's result is unchanged by the second."""
    cfg = bridge.render_config(dataclasses.replace(
        small_cfg, light_grid_mode="windowed"))
    scene = bridge.scene(cornell)
    lights = [bridge.camera_spec(generic_light)]
    kw = _frame_kw(cfg, scene, lights, True)
    cams = [bridge.camera_spec(c) for c in (generic_camera, OTHER_CAMERA)]
    args = [_frame_args(cfg, scene, c, lights) for c in cams]
    want = [_frame_leaves(rapi.render_frame_device.fn(**a, **kw))
            for a in args]
    first = _frame_leaves(rapi.render_frame_device(**args[0], **kw))
    kept = {k: v.clone() for k, v in first.items()}
    second = _frame_leaves(rapi.render_frame_device(**args[1], **kw))
    _assert_bitwise(first, want[0])
    _assert_bitwise(first, kept)
    _assert_bitwise(second, want[1])
    assert not torch.equal(want[0]["image"], want[1]["image"])
    assert int(want[0]["shadowed"].sum()) > 100


def _reflective_leaves(out):
    """The reflective frame's results that chip_smoke holds bitwise."""
    refl = out["reflection"]
    return dict(image=out["image"], color=out["color"],
                shadowed=out["shadowed"], t=refl["t"],
                face_id=refl["face_id"], steps=refl["steps"],
                overflow=out["overflow"])


def test_render_frame_reflective_equals_eager(tiny_cfg, cornell,
                                              generic_camera, generic_light):
    """render_frame_reflective is a Program: two cameras in turn, each
    bitwise its eager body's (``.fn``); the first call's result is
    unchanged by the second, the uniform grid comes back too, and each
    static key (Lambert, spot) is one recording."""
    prog = rapi.render_frame_reflective
    assert isinstance(prog, Program)
    prog.clear()
    cfg = bridge.render_config(dataclasses.replace(
        tiny_cfg, light_grid_mode="reference"))
    scene = bridge.scene(cornell)
    lights = [bridge.camera_spec(generic_light)]
    cams = [bridge.camera_spec(c) for c in (generic_camera, OTHER_CAMERA)]
    args = [_frame_args(cfg, scene, c, lights) for c in cams]
    for use_spot in (False, True):
        kw = dict(_frame_kw(cfg, scene, lights, use_spot),
                  uniform_dims=REFLECT_DIMS)
        want = [prog.fn(**a, **kw) for a in args]
        first = prog(**args[0], **kw)
        kept = {k: v.clone() for k, v in _reflective_leaves(first).items()}
        second = prog(**args[1], **kw)
        _assert_bitwise(_reflective_leaves(first),
                        _reflective_leaves(want[0]))
        _assert_bitwise(_reflective_leaves(first), kept)
        _assert_bitwise(_reflective_leaves(second),
                        _reflective_leaves(want[1]))
        for field in first["uniform_grid"]._fields:
            assert torch.equal(getattr(first["uniform_grid"], field),
                               getattr(want[0]["uniform_grid"], field))
        assert not torch.equal(want[0]["image"], want[1]["image"])
        assert int((want[0]["reflection"]["face_id"] >= 0).sum()) > 1000
    assert prog.cache_size() == 2


def test_reflective_program_matches_ugrt(tiny_cfg, cornell, generic_camera,
                                         generic_light):
    """The reflective Program on the CPU against ugrt's jitted
    render_frame_reflective in windowed mode, Lambert: the bounds of
    tests/test_torch_reflect.py."""
    from ugrt.api.renderer import render_frame_reflective as frame_j

    cfg = dataclasses.replace(tiny_cfg, light_grid_mode="windowed")
    cc = cam.camcoords_from_spec(generic_camera, cfg.fovy_deg, 1.0)
    lcc = cam.camcoords_from_spec(generic_light, cfg.fovy_deg, 1.0)[None]
    lp = np.asarray(generic_light.eye, np.float32)
    arrays = (cornell.vertices, cornell.faces, cornell.mat_index,
              cornell.materials, cc, lcc, lp)
    kw = dict(capacity=cfg.pair_capacity(cornell.num_faces), num_lights=1,
              use_spot=False, uniform_dims=REFLECT_DIMS)
    want = frame_j(*(np.asarray(a) for a in arrays), cfg=cfg, **kw)
    got = rapi.render_frame_reflective(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        cfg=bridge.render_config(cfg), **kw)
    assert bool(got["overflow"]) == bool(want["overflow"]) is False
    img_g, img_w = got["image"].numpy(), np.asarray(want["image"])
    assert img_g.shape == img_w.shape == (64, 64, 3)
    assert (img_g != img_w).any(-1).sum() <= 0.001 * 64 * 64
    f_g = got["reflection"]["face_id"].numpy()
    f_w = np.asarray(want["reflection"]["face_id"])
    assert (f_g == f_w).mean() >= 0.999 and (f_g >= 0).sum() > 1000
    np.testing.assert_array_equal(got["shadowed"].numpy(),
                                  np.asarray(want["shadowed"]))


def test_renderer_one_program_per_static_key(monkeypatch, tiny_cfg,
                                            cornell, generic_camera,
                                            generic_light):
    """Renderer.render goes through render_frame_device: frames 1-3 give
    two keys (Lambert, then the spotlight); new vertices
    (update_vertices, as the CLI animates) and a new scene shape each
    give the eager frame; the new shape adds a key."""
    prog = Program(rapi.render_frame, static=FRAME_STATIC)
    monkeypatch.setattr(rapi, "render_frame_device", prog)
    cfg = bridge.render_config(tiny_cfg)
    cam_t = bridge.camera_spec(generic_camera)
    light_t = bridge.camera_spec(generic_light)
    lp = generic_light.eye

    def eager(r, use_spot):
        a = _frame_args(cfg, bridge.scene(cornell), cam_t, [light_t])
        a.update(vertices=r.vertices, faces=r.faces, mat_index=r.mat_index,
                 materials=r.materials, light_position=bridge.from_numpy(
                     lp, "cpu", np.float32))
        return _frame_leaves(rapi.render_frame(
            **a, cfg=cfg, capacity=r.capacity, num_lights=1,
            use_spot=use_spot))

    r = rapi.Renderer(bridge.scene(cornell), cfg, device="cpu")
    for i in range(3):
        out = _frame_leaves(r.render(cam_t, [light_t], lp))
        _assert_bitwise(out, eager(r, use_spot=i >= 1))
    assert prog.cache_size() == 2

    verts = np.asarray(cornell.vertices, np.float32)
    half = verts.shape[0] // 2
    r.update_vertices(model.rotate_subrange(verts, verts[half:], half, 0.1))
    moved = _frame_leaves(r.render(cam_t, [light_t], lp))
    _assert_bitwise(moved, eager(r, use_spot=True))
    assert not torch.equal(moved["image"], out["image"])
    assert prog.cache_size() == 2

    tri = procedural.single_triangle()
    r2 = rapi.Renderer(tri, cfg, device="cpu")
    got = _frame_leaves(r2.render(cam_t, [light_t], lp, use_spot=True))
    a = _frame_args(cfg, tri, cam_t, [light_t])
    a["light_position"] = bridge.from_numpy(lp, "cpu", np.float32)
    _assert_bitwise(got, _frame_leaves(rapi.render_frame(
        **a, **_frame_kw(cfg, tri, [light_t], True))))
    assert prog.cache_size() == 3


def test_renderer_refuses_cuda_without_cuda(monkeypatch, cornell, tiny_cfg):
    """No fallback: a CUDA device where CUDA is not available raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rapi.Renderer(bridge.scene(cornell), bridge.render_config(tiny_cfg),
                      device="cuda")


def test_renderer_program_matches_ugrt(monkeypatch, tiny_cfg, cornell,
                                       generic_camera, generic_light):
    """Frames 1-2 (Lambert, then the spotlight) of the port's Renderer,
    through its programs, byte-equal to ugrt's jitted Renderer."""
    prog = Program(rapi.render_frame, static=FRAME_STATIC)
    monkeypatch.setattr(rapi, "render_frame_device", prog)
    cfg = dataclasses.replace(tiny_cfg, light_grid_mode="windowed")
    lp = generic_light.eye
    rj = RendererJax(cornell, cfg)
    rt = rapi.Renderer(bridge.scene(cornell), bridge.render_config(cfg),
                       device="cpu")
    for _ in range(2):
        oj = rj.render(generic_camera, [generic_light], lp)
        ot = rt.render(bridge.camera_spec(generic_camera),
                       [bridge.camera_spec(generic_light)], lp)
        np.testing.assert_array_equal(ot["shadowed"].numpy(),
                                      np.asarray(oj["shadowed"]))
        np.testing.assert_array_equal(ot["image"].numpy(),
                                      np.asarray(oj["image"]))
        assert bool(ot["overflow"]) == bool(oj["overflow"]) is False
    assert prog.cache_size() == 2


def test_step_program_matches_eager_and_ugrt(tiny_cfg):
    """render_and_grad is a Program: two inputs in turn, each bitwise the
    eager step's (render_and_grad.fn), and the first within
    tests/test_torch_grad.py's bounds of ugrt's jitted step."""
    assert isinstance(rg_t.render_and_grad, Program)
    case = Case(tiny_cfg, "tri", 1, True)
    keys = ("loss", "color", "grad_vertices", "grad_materials", "overflow")
    targets = [torch.from_numpy(case.target), torch.zeros_like(
        torch.from_numpy(case.target))]
    got = [rg_t.render_and_grad(**case.t, target=t, **case.kw_t)
           for t in targets]
    for out, t in zip(got, targets):
        want = rg_t.render_and_grad.fn(**case.t, target=t, **case.kw_t)
        _assert_bitwise({k: out[k] for k in keys},
                        {k: want[k] for k in keys})
    assert float(got[0]["loss"]) != float(got[1]["loss"])

    want = case.step_j()
    np.testing.assert_allclose(got[0]["color"].numpy(),
                               np.asarray(want["color"]), rtol=0,
                               atol=COLOR_ATOL)
    np.testing.assert_allclose(float(got[0]["loss"]), float(want["loss"]),
                               rtol=1e-5, atol=1e-7)
    _close_grads(got[0]["grad_materials"].numpy(), want["grad_materials"])
    _close_grads(got[0]["grad_vertices"].numpy(), want["grad_vertices"],
                 ~_kink_vertices(case.sc))
