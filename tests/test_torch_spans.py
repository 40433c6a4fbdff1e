"""ugrt_torch's span and counter recorder (``api.profiler``) and the
spans of the frame and step paths.

On the CPU: spans nest and carry their parent, request id and self time;
off, ``span`` returns the shared no-op and nothing is recorded; a
``torch.profiler`` session shows the span names as ``record_function``
events, with the recorder on and off, and ``trace_to``'s Chrome trace
holds them; a ``Program`` takes no extra key with the recorder off and
one traced key with it on; a replayed graph's spans are copied under
their replay; a tiny frame, reflective frame and step give the same bits
with the recorder on and off; ``train()``'s steps are the roots of their
spans.

On the card (marked ``cuda``, skipped without one): a traced frame's
stage spans read positive device ms inside ``program.replay``'s device
interval.  The file imports no JAX and nothing of ugrt:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py

Tolerance: none (the recorder adds no work to the body's arithmetic).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ugrt_torch import bridge
from ugrt_torch.api import profiler
from ugrt_torch.api import renderer as rapi
from ugrt_torch.api import train as tapi
from ugrt_torch.config import RenderConfig
from ugrt_torch.core.host_camera import CameraSpec
from ugrt_torch.core.program import Program
from ugrt_torch.diff import render_grad
from ugrt_torch.scene import procedural
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dataclasses.replace(RenderConfig(), screen_width=64,
                           screen_height=64, grid_x=8, grid_y=8)
CAMERA = CameraSpec(eye=(0.3, -0.1, 2.2), look_at=(0.0, 0.05, 0.0),
                    up=(0.0, 1.0, 0.02), near=0.1, far=100.0)
LIGHT = CameraSpec(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                   up=(0.0, 0.0, 1.0), near=0.1, far=100.0)
STAGES = ("grid.perspective", "trace.primary", "grid.spherical",
          "trace.shadow")


def _busy(seconds):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_and_carry_parent_id_and_self_time():
    with profiler.tracing("cpu") as rec:
        for _ in range(2):
            with profiler.span("client.upload"):
                _busy(1e-3)
            with profiler.span("call", request=True) as call:
                with profiler.span("bind"):
                    _busy(2e-3)
                with profiler.span("work", device=True):
                    with profiler.span("inner", request=True):
                        _busy(1e-3)
                profiler.count("calls")
                profiler.count("items", 3)
                _busy(1e-3)
            assert isinstance(call, profiler.Span)
    spans = _by_name(rec)
    assert [s.rid for s in spans["call"]] == [0, 1]
    # The client's span before a request's root shares its id.
    assert [s.rid for s in spans["client.upload"]] == [0, 1]
    for call in spans["call"]:
        assert call.parent is None
    for name, parent in (("bind", "call"), ("work", "call"),
                         ("inner", "work")):
        for s in spans[name]:
            assert s.parent.name == parent
            assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1
            assert s.rid == s.parent.rid
    # A request span that is not a root ends no request.
    assert len({s.rid for s in rec.spans}) == 2
    # On the CPU a device span's interval is its host interval.
    for s in spans["work"]:
        assert (s.d0, s.d1) == (s.t0, s.t1)
    assert all(s.d0 is None for s in spans["bind"])
    totals = rec.totals()
    call = totals["call"]
    cover = sum(s.t1 - s.t0 for n in ("bind", "work") for s in spans[n])
    assert call.calls == 2 and call.self_ns == call.host_ns - cover
    assert call.self_ns >= 2 * 1e6 * 0.9
    assert totals["work"].device_calls == 2
    assert totals["work"].device_ns == totals["work"].host_ns
    assert totals["bind"].device_calls == 0
    assert rec.counts == {"calls": 2, "items": 6}
    report = rec.report()
    for name in ("client.upload", "call", "bind", "work", "inner", "items"):
        assert name in report


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not profiler.recording()
    assert profiler.span("a") is profiler.NOOP
    assert profiler.span("b", device=True, request=True) is profiler.NOOP
    with profiler.span("a") as s:
        profiler.count("a")
    assert s is None

    calls = []

    @profiler.spanned("wrapped", device=True)
    def f(x, *, y):
        """f's docstring"""
        calls.append((x, y))
        return x + y

    assert f(1, y=2) == 3 and f.__doc__ == "f's docstring"
    with profiler.tracing("cpu") as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    with profiler.tracing("cpu") as rec:
        assert f(2, y=3) == 5
    assert [s.name for s in rec.spans] == ["wrapped"]
    assert calls == [(1, 2), (2, 3)]
    assert profiler.span("a") is profiler.NOOP
    with pytest.raises(RuntimeError, match="already on"):
        with profiler.tracing("cpu"):
            with profiler.tracing("cpu"):
                pass


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_profiler_session_shows_span_names(on):
    from torch.profiler import ProfilerActivity, profile

    @profiler.spanned("spans_test.decorated")
    def g():
        return torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with (profiler.tracing("cpu") if on else _nothing()):
            with profiler.span("spans_test.outer", request=True):
                with profiler.span("spans_test.device", device=True):
                    g()
    names = {e.name for e in prof.events()}
    assert {"spans_test.outer", "spans_test.device",
            "spans_test.decorated"} <= names


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_program_takes_a_traced_key_only_with_the_recorder_on():
    program = Program(lambda x, *, k: dict(y=x * k), static=("k",))
    x = torch.arange(4.0)
    assert torch.equal(program(x, k=2)["y"], x * 2)
    program(x + 1, k=2)
    assert program.cache_size() == 1
    with profiler.tracing("cpu") as rec:
        for i in range(3):
            assert torch.equal(program(x + i, k=2)["y"], (x + i) * 2)
    assert program.cache_size() == 2
    program(x, k=2)
    assert program.cache_size() == 2
    spans = _by_name(rec)
    assert [s.rid for s in spans["program.call"]] == [0, 1, 2]
    for s in spans["program.replay"]:
        assert s.parent.name == "program.call" and s.d0 is not None
    for s in spans["program.launch"]:
        assert s.parent.name == "program.replay"
    assert rec.counts == {"program.replays": 3}
    with profiler.tracing("cpu"):
        program(x, k=3)
    assert program.cache_size() == 3


def test_replayed_spans_copy_the_template_under_their_replay():
    """A captured graph's spans (made here by hand: the capture itself
    runs on the card) are copied under each replay's program.replay span,
    parents kept, in that replay's request; counts are added per
    replay."""
    with profiler.tracing("cpu") as rec:
        with profiler.capturing() as template:
            with profiler.span("host.only"):
                with profiler.span("outer", device=True):
                    with profiler.span("inner", device=True):
                        pass
                    profiler.count("inside", 2)
        assert [s.name for s in template.spans] == ["inner", "outer"]
        assert rec.spans == []
        for _ in range(2):
            with profiler.span("program.call", request=True):
                with profiler.span("program.replay", device=True) as r:
                    pass
                copies = profiler.replayed(template, r)
            profiler.read_replay(copies)
            inner, outer = copies
            assert outer.parent is r and inner.parent is outer
            assert inner.rid == outer.rid == r.rid
            assert inner.t0 is None and inner.d0 is None
    assert rec.counts == {"inside": 4}
    assert rec.totals()["inner"].calls == 2
    assert rec.totals()["inner"].host_ns == 0
    assert profiler.replayed(template, None) == []


def test_trace_to_writes_a_chrome_trace_with_the_spans(tmp_path):
    with profiler.trace_to(str(tmp_path / "trace")):
        with profiler.span("spans_test.traced"):
            torch.ones(64).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert files and "spans_test.traced" in files[0].read_text()


def _scene_args(device="cpu"):
    sc = procedural.cornell_box(subdiv=2)
    t = bridge.scene_to_torch(sc, device)
    aspect = TINY.screen_width / TINY.screen_height
    cc = bridge.camcoords_to_torch(CAMERA, TINY.fovy_deg, aspect, device)
    lcc = bridge.camcoords_to_torch(LIGHT, TINY.fovy_deg, aspect,
                                    device)[None]
    lp = bridge.from_numpy(LIGHT.eye, device, np.float32)
    return sc, dict(t, camcoords=cc, light_camcoords=lcc, light_position=lp)


def _bitwise(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _bitwise(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _bitwise(x, y)


@pytest.mark.parametrize("what", ["frame", "reflective", "step"])
def test_outputs_are_bitwise_equal_with_the_recorder_on_and_off(what):
    sc, a = _scene_args()
    kw = dict(cfg=TINY, capacity=TINY.pair_capacity(sc.num_faces),
              num_lights=1, use_spot=True)
    if what == "frame":
        program, args = rapi.render_frame_device, a
    elif what == "reflective":
        program, args = rapi.render_frame_reflective, a
        kw = dict(kw, uniform_dims=(8, 8, 8), uniform_capacity=1 << 16)
    else:
        program = render_grad.render_and_grad
        args = dict(a, target=torch.from_numpy(
            np.random.default_rng(0).uniform(0.0, 0.3, (64, 64, 3)).astype(
                np.float32)))
    program.clear()
    try:
        off = program(**args, **kw)
        with profiler.tracing("cpu") as rec:
            on = program(**args, **kw)
        assert program.cache_size() == 2
    finally:
        program.clear()
    _bitwise(off, on)
    names = set(_by_name(rec))
    assert {"program.call", "program.replay", "program.launch"} <= names
    assert set(STAGES) <= names
    assert ("frame.bounce" in names) == (what == "reflective")
    assert ("step.backward" in names) == (what == "step")


def test_renderer_frame_spans_share_one_request():
    sc = procedural.cornell_box(subdiv=2)
    r = rapi.Renderer(sc, TINY, device="cpu")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cpu") as rec:
            for _ in range(2):
                r.update_vertices(sc.vertices)
                r.render(CAMERA, [LIGHT], LIGHT.eye, use_spot=True)
    finally:
        rapi.render_frame_device.clear()
    spans = _by_name(rec)
    assert len({s.rid for s in rec.spans}) == 2
    for rid in (0, 1):
        names = [s.name for s in rec.spans if s.rid == rid]
        assert names.count("renderer.upload") == 1
        assert names.count("bridge.camera") == 2    # camera and light
        assert names.count("program.call") == 1
        assert set(STAGES) <= set(names)
    for name in STAGES:
        for s in spans[name]:
            chain = []
            while s.parent is not None:
                s = s.parent
                chain.append(s.name)
            assert chain[-2:] == ["program.replay", "program.call"]


def test_train_steps_are_the_roots_of_their_spans():
    sc, a = _scene_args()
    target = np.zeros((64, 64, 3), np.float32)
    render_grad.render_and_grad.clear()
    try:
        with profiler.tracing("cpu") as rec:
            tapi.train(sc, [CAMERA], LIGHT, LIGHT.eye, [target], TINY,
                       tapi.TrainConfig(learning_rate=1e-3, steps=3),
                       verbose=False, device="cpu")
    finally:
        render_grad.render_and_grad.clear()
    spans = _by_name(rec)
    steps = spans["train.step"]
    assert len(steps) == 3 and all(s.parent is None for s in steps)
    for name in ("program.call", "train.adam"):
        assert [s.parent for s in spans[name]] == steps
    for s in spans["step.backward"]:
        assert s.rid == s.parent.rid
    totals = rec.totals()
    assert totals["train.adam"].device_calls == 3
    assert totals["train.step"].self_ns > 0


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_traced_frame_stages_fall_inside_the_replay_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    sc = procedural.cornell_box(subdiv=2)
    r = rapi.Renderer(sc, TINY, device="cuda")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cuda"):           # captures the traced key
            r.render(CAMERA, [LIGHT], LIGHT.eye, use_spot=True)
        with profiler.tracing("cuda") as rec:
            for _ in range(3):
                out = r.render(CAMERA, [LIGHT], LIGHT.eye, use_spot=True)
                out["image"].cpu()
        assert rapi.render_frame_device.cache_size() == 1
    finally:
        rapi.render_frame_device.clear()
    spans = _by_name(rec)
    replays = spans["program.replay"]
    assert len(replays) == 3
    for name in STAGES:
        assert len(spans[name]) == 3
        for s in spans[name]:
            assert s.t0 is None            # ran inside the graph
            assert s.d1 > s.d0
            p = s.parent
            assert p.name == "program.replay"
            assert p.d0 <= s.d0 and s.d1 <= p.d1
            assert s.rid == p.rid
    for p in replays:
        assert p.parent.name == "program.call"
        assert p.d1 - p.d0 > 0
    assert rec.counts.get("program.unread_replays", 0) == 0


@pytest.mark.parametrize("mode", ["reference", "windowed"])
def test_shadow_rays_span_nests_in_trace_shadow(mode):
    """B1's span ``shadow.rays`` opens once a light and frame, inside
    ``trace.shadow`` and in the frame's request."""
    sc = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(TINY, light_grid_mode=mode)
    r = rapi.Renderer(sc, cfg, device="cpu")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cpu") as rec:
            for _ in range(2):
                r.render(CAMERA, [LIGHT, CAMERA], LIGHT.eye)
    finally:
        rapi.render_frame_device.clear()
    spans = _by_name(rec)["shadow.rays"]
    assert len(spans) == 4
    for s in spans:
        assert s.parent.name == "trace.shadow" and s.rid == s.parent.rid
        assert s.t1 >= s.t0


@pytest.mark.parametrize("mode", ["reference", "windowed"])
def test_shadow_tris_span_nests_in_trace_shadow(mode):
    """B2's span ``shadow.tris`` opens once a light and frame, inside
    ``trace.shadow`` after ``shadow.rays``, in the frame's request."""
    sc = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(TINY, light_grid_mode=mode)
    r = rapi.Renderer(sc, cfg, device="cpu")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cpu") as rec:
            for _ in range(2):
                r.render(CAMERA, [LIGHT, CAMERA], LIGHT.eye)
    finally:
        rapi.render_frame_device.clear()
    by_name = _by_name(rec)
    spans, rays = by_name["shadow.tris"], by_name["shadow.rays"]
    assert len(spans) == len(rays) == 4
    for s, b in zip(spans, rays):
        assert s.parent.name == "trace.shadow" and s.rid == s.parent.rid
        assert s.parent is b.parent and s.t0 >= b.t1 and s.t1 >= s.t0


@pytest.mark.cuda
def test_replays_credit_b1_counters_and_time_its_span_on_the_card():
    """On the card, each replay of a traced frame credits B1's counters
    ``kernel.shadow_rays`` and ``kernel.unpermute`` (and
    ``kernel.window_angles`` in windowed mode) once a light, and times
    ``shadow.rays`` inside ``trace.shadow``; ``report()`` lists both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    sc = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(TINY, light_grid_mode="windowed")
    r = rapi.Renderer(sc, cfg, device="cuda")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cuda"):           # captures the traced key
            r.render(CAMERA, [LIGHT], LIGHT.eye, use_spot=True)
        with profiler.tracing("cuda") as rec:
            for _ in range(3):
                r.render(CAMERA, [LIGHT], LIGHT.eye, use_spot=True)
    finally:
        rapi.render_frame_device.clear()
    for name in ("kernel.shadow_rays", "kernel.unpermute",
                 "kernel.window_angles"):
        assert rec.counts[name] == 3, name
    spans = _by_name(rec)["shadow.rays"]
    assert len(spans) == 3
    for s in spans:
        assert s.t0 is None and s.d1 > s.d0      # ran inside the graph
        p = s.parent
        assert p.name == "trace.shadow" and p.d0 <= s.d0 and s.d1 <= p.d1
    report = rec.report()
    assert "shadow.rays" in report and "kernel.shadow_rays" in report


@pytest.mark.cuda
def test_replays_credit_b2_counter_and_time_its_span_on_the_card():
    """On the card, each replay of a traced frame credits B2's counter
    ``kernel.shadow_tris`` once a light and times ``shadow.tris`` inside
    ``trace.shadow``; ``report()`` lists both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    sc = procedural.cornell_box(subdiv=2)
    cfg = dataclasses.replace(TINY, light_grid_mode="reference")
    r = rapi.Renderer(sc, cfg, device="cuda")
    rapi.render_frame_device.clear()
    try:
        with profiler.tracing("cuda"):           # captures the traced key
            r.render(CAMERA, [LIGHT, CAMERA], LIGHT.eye, use_spot=True)
        with profiler.tracing("cuda") as rec:
            for _ in range(3):
                r.render(CAMERA, [LIGHT, CAMERA], LIGHT.eye, use_spot=True)
    finally:
        rapi.render_frame_device.clear()
    assert rec.counts["kernel.shadow_tris"] == 6
    spans = _by_name(rec)["shadow.tris"]
    assert len(spans) == 6
    for s in spans:
        assert s.t0 is None and s.d1 > s.d0      # ran inside the graph
        p = s.parent
        assert p.name == "trace.shadow" and p.d0 <= s.d0 and s.d1 <= p.d1
    report = rec.report()
    assert "shadow.tris" in report and "kernel.shadow_tris" in report
