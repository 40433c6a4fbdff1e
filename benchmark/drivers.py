"""The drivers of the two traffic kinds: set-up, the measured window, and
what the correctness check and the per-layer readers need.

``FramesDriver`` ("frames") is the program's dynamic-scene loop as
``ugrt_torch/api/cli.py`` runs it: per frame ``Renderer.update_vertices``
and ``Renderer.render`` (or, for a configuration with ``"frame":
"reflective"``, ``render_frame_reflective`` as ``cli --reflect`` calls
it), then the u8 image read to the host and the overflow flag read.
One client, one frame in flight.

``TrainDriver`` ("train") is one call of ``ugrt_torch.api.train.train``
a window: a training job from the scene's own parameters over the
cell's views and targets (``use_mesh`` on every rank of a sharded
cell), at the configuration's learning rate, saving a checkpoint every
``checkpoint_every`` steps where the traffic asks for it.  Its number of
steps is fixed in set-up from the step rate of a warm-up job of the
traffic's ``rate_steps``, so that the call lasts about ``--seconds``.
A post-step hook on the call's optimizer (the program's own
``make_optimizer``, wrapped) copies what the check compares: Adam's
first moments after step 1 and the parameters after step 3.

How a frame or step is called (lights, shading, aspect, the bounce) is
``frame_call``'s.  Only the program's entry points, its scene and camera
types and its captured programs (for the per-layer stage times) are used
here.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import statistics
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark import frame_call
from benchmark import traffic as btraffic

CHECKED_STEPS = 3


class WindowResult(NamedTuple):
    attempted: int
    failed: int
    window_s: float
    latencies_s: list         # per frame ("frames")
    error: str | None


def program_config(config: dict):
    """The program's ``RenderConfig`` of a configuration file."""
    from ugrt_torch.config import QuirkConfig, RenderConfig
    r = dict(config["render"])
    r["quirks"] = QuirkConfig(**r.get("quirks", {}))
    return RenderConfig(**r)


def spec(view):
    """The program's ``CameraSpec`` of a view (a traffic ``View`` or a
    configuration's camera object)."""
    from ugrt_torch.core.host_camera import CameraSpec
    view = frame_call.view_of(view)
    return CameraSpec(eye=view.eye, look_at=view.look_at, up=view.up,
                      near=view.near, far=view.far)


def program_scene(sc):
    from ugrt_torch.scene.model import Scene
    return Scene(sc.vertices, sc.faces, sc.mat_index, sc.materials)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quiet_heap():
    """Collect, then freeze what set-up left, so that the window's
    collections walk only what the window makes (no multi-ms pass over
    the program's objects in the middle of a frame)."""
    gc.collect()
    gc.freeze()


class _Driver:
    def __init__(self, cell, seed: int, device, mesh=None):
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.device = torch.device(device)
        self.mesh = mesh
        self.cfg = program_config(cell.config)
        self.traffic = btraffic.generate(cell.traffic, cell.config, seed,
                                         self.device)
        self.scene = program_scene(self.traffic.scene)
        self.capacity = self.cfg.pair_capacity(self.scene.num_faces)
        self.fc = frame_call.of(cell.config)
        self.reflective = self.fc.reflective
        self.light_specs = [spec(v) for v in self.fc.lights]
        self.light_position = self.fc.light_position
        self.views = [spec(v) for v in self.traffic.views]


class FramesDriver(_Driver):
    """The dynamic-scene frame loop (module docstring)."""

    WARM_FRAMES = 4

    def __init__(self, cell, seed, device, mesh=None):
        super().__init__(cell, seed, device, mesh)
        from ugrt_torch.api.renderer import Renderer
        self.renderer = Renderer(self.scene, self.cfg, device=self.device)
        self.frame_no = 0          # the CLI's frame counter
        rng = np.random.default_rng(btraffic.seed_sequence(seed, 4))
        self.sample_first = int(rng.integers(len(self.views)))

    def inputs(self, k: int):
        """Frame k's vertices and camera (the traffic cycles through
        both)."""
        vf = self.traffic.vertex_frames
        return vf[k % len(vf)], self.views[k % len(self.views)]

    def frame(self, k: int):
        """One frame as the CLI makes it; returns the program's output
        dict (the image still on the device)."""
        from ugrt_torch import bridge
        verts, view = self.inputs(k)
        r = self.renderer
        r.update_vertices(verts)
        if not self.reflective:
            return r.render(view, self.light_specs, self.light_position)
        from ugrt_torch.api.renderer import render_frame_reflective
        cfg, fc = self.cfg, self.fc
        cc = bridge.camcoords_to_torch(view, cfg.fovy_deg, fc.aspect,
                                       r.device)
        lcc = torch.stack([bridge.camcoords_to_torch(
            s, cfg.fovy_deg, fc.aspect, r.device) for s in self.light_specs])
        out = render_frame_reflective(
            r.vertices, r.faces, r.mat_index, r.materials, cc, lcc,
            bridge.from_numpy(self.light_position, r.device, np.float32),
            **fc.kwargs(cfg, r.capacity, use_spot=self.frame_no >= 1))
        self.frame_no += 1
        return out

    def setup(self, seconds=None):
        """Renders the CLI's first frames (Lambert, then spot): every
        program key that the window uses is captured here."""
        for k in range(self.WARM_FRAMES):
            out = self.frame(k)
            out["image"].cpu()
        sync(self.device)

    def window(self, seconds: float) -> WindowResult:
        quiet_heap()
        lat, kept = [], {}
        failed = 0
        error = None
        t0 = time.perf_counter()
        k = 0
        while True:
            ts = time.perf_counter()
            try:
                out = self.frame(k)
                image = out["image"].cpu().numpy()
                overflow = bool(out["overflow"])
            except RuntimeError as e:     # a frame that raises fails
                failed += 1
                error = f"frame {k}: {e}"
                out, image, overflow = None, None, True
            te = time.perf_counter()
            lat.append(te - ts)
            if overflow and out is not None:
                failed += 1
                error = f"frame {k}: capacity overflow"
            if out is not None and k == self.sample_first:
                kept[k] = (out, image)
            last = (k, out, image)
            k += 1
            if te - t0 >= seconds:
                break
        if last[1] is not None:
            kept[last[0]] = last[1:]
        self.kept = kept
        sync(self.device)
        return WindowResult(k, failed, te - t0, lat, error)

    def free(self):
        from ugrt_torch.api.renderer import (render_frame_device,
                                             render_frame_reflective)
        render_frame_device.clear()
        render_frame_reflective.clear()
        self.renderer = None

    def check(self, lowp=None) -> dict:
        """The numbers that decide ``correct`` (``check.frames``)."""
        from benchmark import check
        return check.frames(self, lowp=lowp)


class TrainDriver(_Driver):
    """One ``train()`` call a window (module docstring)."""

    WARM_STEPS = 2

    def __init__(self, cell, seed, device, mesh=None):
        super().__init__(cell, seed, device, mesh)
        if self.fc.num_lights != 1:
            raise ValueError("train() renders with one light; the "
                             f"configuration has {self.fc.num_lights}")
        self.targets = self.traffic.targets
        self.lr = cell.config["train"]["learning_rate"]
        self.checkpoint_every = cell.traffic.get("checkpoint_every")
        self.rate_steps = int(cell.traffic["rate_steps"])
        self.steps = None
        self.record = {}

    def train(self, steps: int):
        from ugrt_torch.api.train import TrainConfig, train
        folder = (tempfile.mkdtemp(prefix="bench-ckpt-")
                  if self.checkpoint_every else None)
        tcfg = TrainConfig(learning_rate=self.lr, steps=steps,
                           checkpoint_dir=folder,
                           checkpoint_every=self.checkpoint_every or 50,
                           use_mesh=self.mesh is not None)
        try:
            return train(self.scene, self.views, self.light_specs[0],
                         self.light_position, self.targets, self.cfg, tcfg,
                         verbose=False,
                         device=self.device if self.mesh is None
                         else self.device.type)
        finally:
            if folder and os.path.isdir(folder):
                shutil.rmtree(folder, ignore_errors=True)

    @contextlib.contextmanager
    def recording(self):
        """Wrap the program's optimizer factory so that the
        ``train()`` call inside the context copies its Adam's first
        moments after step 1 and its parameters after step 3 into
        ``self.record``."""
        from ugrt_torch.api import train as ptrain
        make = ptrain.make_optimizer
        record = self.record
        record.clear()

        def hook(opt, args, kwargs):
            record["steps"] = record.get("steps", 0) + 1
            n = record["steps"]
            if n == 1:
                record["first_moment"] = [
                    opt.state[p]["exp_avg"].clone() if p in opt.state
                    and "exp_avg" in opt.state[p] else torch.zeros_like(p)
                    for p in opt.param_groups[0]["params"]]
            if n == CHECKED_STEPS:
                record["params"] = [p.detach().clone()
                                    for p in opt.param_groups[0]["params"]]

        def recorded(params, learning_rate):
            opt = make(params, learning_rate)
            if "hooked" not in record:
                record["hooked"] = True
                opt.register_step_post_hook(hook)
            return opt

        ptrain.make_optimizer = recorded
        try:
            yield
        finally:
            ptrain.make_optimizer = make

    def setup(self, seconds: float):
        """Captures the step's program and fixes the window's number of
        steps from the step rate of a second, timed job (a whole call:
        a sharded ``train()`` records its step's program anew each
        call)."""
        self.train(self.WARM_STEPS)
        sync(self.device)
        t0 = time.perf_counter()
        self.train(self.rate_steps)
        sync(self.device)
        step_s = self.agree_max(time.perf_counter() - t0) / self.rate_steps
        self.steps = max(CHECKED_STEPS + 1, int(round(seconds / step_s)))

    def agree_max(self, x: float) -> float:
        """The largest ``x`` over the ranks (every rank must run the same
        calls); ``x`` on one card."""
        if self.mesh is None:
            return x
        import torch.distributed as dist
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return float(t[0])

    def window(self, seconds: float) -> WindowResult:
        error = None
        failed = 0
        self.losses = []
        quiet_heap()
        with self.recording():
            t0 = time.perf_counter()
            try:
                _, _, self.losses = self.train(self.steps)
            except RuntimeError as e:   # overflow: the call raises
                failed, error = self.steps, str(e)
            sync(self.device)
            te = time.perf_counter()
        return WindowResult(self.steps, failed, te - t0, [], error)

    def free(self):
        from ugrt_torch.diff.render_grad import render_and_grad
        render_and_grad.clear()

    def check(self, lowp=None) -> dict:
        """The numbers that decide ``correct`` (``check.train``)."""
        from benchmark import check
        return check.train(self, lowp=lowp)


DRIVERS = {"frames": FramesDriver, "train": TrainDriver}


def make(cell, seed, device, mesh=None):
    return DRIVERS[cell.traffic["kind"]](cell, seed, device, mesh)


def p95(values) -> float:
    """The 95th percentile of ``values`` (statistics.quantiles' default
    exclusive method, 20 parts; the one value of a window of one)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[18]

