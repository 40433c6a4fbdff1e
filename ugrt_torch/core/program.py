"""Captured programs: the port's counterpart of ``jax.jit`` over a
statically shaped function of tensors.

ugrt runs its entry points (the frame ``render_frame_device``, the step
``render_and_grad``) as one compiled XLA program per static key.  On the
card the same property is a CUDA graph: ``Program(fn, static=names)``
records ``fn`` once per key and replays the recording on every later
call, so a frame or a step costs one graph launch instead of a thousand
or more eager kernel launches from Python.

The key is the values of the ``static`` arguments (hashable, as
``jax.jit``'s static arguments) and every other argument's shape, dtype
and device; every argument that is not static must be a tensor.  Per key
the program holds static input buffers.  Per call it copies each tensor
argument into its buffer, replays the graph, and returns the output
pytree cloned: the graph writes its outputs to the same memory on every
replay, and a caller that keeps one call's result while it makes the
next must see what eager calls give it.

On the card, the first call of a key runs ``fn`` eagerly on a side
stream (which builds and loads the kernel libraries and initialises
autograd, as PyTorch requires before it captures a backward) and then
captures it.  A capture or replay that fails raises: nothing falls back
to eager.  On the CPU the same input binding and output cloning run, and
the "replay" is an eager call of ``fn`` on the buffers.  ``Program.fn``
is the eager function (the counterpart of ``jax.disable_jit``).

Capture error mode.  ``capture_error_mode`` is ``torch.cuda.graph``'s:
"global" (the default) refuses a call that could sync, made from any
thread while the capture runs; "thread_local" refuses it only on the
capturing thread.  A body with collectives takes "thread_local"
(``dist.mesh``): NCCL's watchdog thread queries its events during the
capture.  A host read in the body itself raises in either mode.

A backward in a body runs on the capturing thread
(``torch.autograd.set_multithreading_enabled(False)``, as
``render_and_grad`` and ``dist.mesh`` do), not on autograd's worker
thread.  torch.profiler over a replayed step has crashed the process
(PERF.md §7).

Kernel launch counts.  A replay runs the kernels that the capture
recorded without running their Python wrappers, so every hand kernel
(``kernels._build.KERNELS``) is credited with each replay's launches:
the launches its wrapper counted while the capture recorded them, which
launched nothing.

Spans (``api.profiler``).  A call is the span ``program.call`` (binding,
key, input copies, replay, output clones); the replay is the device span
``program.replay`` (events just before and after ``graph.replay()``,
outside the graph) around the host span ``program.launch``; a capture
is ``program.capture`` and counts in ``program.captures``, a replay in
``program.replays``.  While the recorder is on, a call takes a key of
its own (its key plus "traced"), captured with the body's device spans
as event nodes in the graph; each replay records a copy of them, read
at the key's next call.  With the recorder off nothing of this is in the
graph.
"""

from __future__ import annotations

import functools
import inspect
import time
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from ugrt_torch.api import profiler
from ugrt_torch.kernels._build import KERNELS


class Program:
    """``fn`` as one captured CUDA graph per (static values, input shapes)
    key; see the module docstring."""

    def __init__(self, fn: Callable, static: Sequence[str],
                 capture_error_mode: str = "global"):
        self.fn = fn
        self.static = tuple(static)
        self.capture_error_mode = capture_error_mode
        self._signature = inspect.signature(fn)
        self._cache: dict = {}
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        with profiler.span("program.call", request=True):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        bound = self._signature.bind(*args, **kwargs)
        bound.apply_defaults()
        statics = {n: bound.arguments[n] for n in self.static}
        tensors = {n: v for n, v in bound.arguments.items()
                   if n not in self.static}
        for name, value in tensors.items():
            if not isinstance(value, torch.Tensor):
                raise TypeError(f"{self.__name__}: argument {name!r} is "
                                f"neither static nor a tensor "
                                f"({type(value).__name__})")
        key = (tuple(statics.items()),
               tuple((n, t.shape, t.dtype, t.device)
                     for n, t in tensors.items()))
        if profiler.recording():
            key += ("traced",)
        entry = self._cache.get(key)
        if entry is None:
            entry = _Capture(self.fn, statics, tensors,
                             self.capture_error_mode)
            self._cache[key] = entry
        return entry(tensors)

    def cache_size(self) -> int:
        """The number of keys recorded so far."""
        return len(self._cache)

    def clear(self) -> None:
        """Drop every recording (and the device memory it holds)."""
        self._cache.clear()

    def capture_seconds(self) -> list:
        """Each key's warm-up and capture seconds, in recording order."""
        return [e.capture_s for e in self._cache.values()]


class _Capture:
    """One key of a Program: its input buffers and, on the card, its
    graph and the graph's outputs."""

    def __init__(self, fn, statics, example, error_mode):
        self.fn = fn
        self.statics = statics
        self.error_mode = error_mode
        self.graph = None
        self.template = None      # the traced key's spans (api.profiler)
        self.last = []            # their copies of the last replay
        self.capture_s = 0.0
        device = next(iter(example.values())).device
        with torch.no_grad():
            self.inputs = {n: t.clone(memory_format=torch.contiguous_format)
                           for n, t in example.items()}
        if device.type == "cuda":
            self._capture(device)
        elif device.type != "cpu":
            raise ValueError(f"Program: unsupported device {device}")

    def _run(self):
        return self.fn(**self.inputs, **self.statics)

    def _capture(self, device):
        with profiler.span("program.capture"):
            t0 = time.perf_counter()
            with torch.cuda.device(device):
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self._run()
                torch.cuda.current_stream(device).wait_stream(side)
                before = {k: k.launches for k in KERNELS.values()}
                self.graph = torch.cuda.CUDAGraph()
                with profiler.capturing() as template, torch.cuda.graph(
                        self.graph, capture_error_mode=self.error_mode):
                    self.outputs = self._run()
                self.template = template
                # The wrappers counted launches that they only recorded: each
                # replay makes them.
                self.credit = []
                for k in KERNELS.values():
                    n = k.launches - before.get(k, 0)
                    if n:
                        self.credit.append((k, n))
                        k.launches -= n
                torch.cuda.synchronize(device)
            self.capture_s = time.perf_counter() - t0
        profiler.count("program.captures")

    def __call__(self, tensors):
        with torch.no_grad():
            for name, t in tensors.items():
                self.inputs[name].copy_(t)
        profiler.count("program.replays")
        if self.graph is None:
            with profiler.span("program.replay", device=True), \
                    profiler.span("program.launch"):
                out = self._run()
        else:
            profiler.read_replay(self.last)
            with profiler.span("program.replay", device=True) as replay:
                with profiler.span("program.launch"):
                    self.graph.replay()
            self.last = profiler.replayed(self.template, replay)
            out = self.outputs
            for k, n in self.credit:
                k.launches += n
        return pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)
