"""Frozen copy of ``ugrt_torch/micro/_timing.py`` (lines 1-109), the
chained and fenced timing that the port's bench uses; it imports
nothing of ``ugrt_torch``.  The original docstring follows.

Timing for the benches (the port's copy of what scripts/_timing.py
gives bench.py and scripts/bench_reflective.py).

``chain_ms`` is ``chain_timeit``: a warm-up call, then ``n`` calls in
which call k's input ``args[arg_index]`` carries a zero-valued data
dependency on call k-1's output (its first tensor, ``_dep``, unless the
caller gives ``dep``), so the calls queue on
the device as one chain, and one synchronize at the end is the only
fence.  ``fenced_ms`` is ``timeit``: a synchronize after every call.

Each returns the host-clock ms per call (what bench.py reports) and,
for CUDA tensors, the CUDA-event ms over the same window: a chain that
the host cannot keep ahead of shows as host ms above event ms.  On the
CPU the same functions run and the event time is None.  The warm-up
call is outside the window: a ``core.program.Program`` records its
graph there.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree


class Timing(NamedTuple):
    """ms per call on the host clock, and by CUDA events (None on the
    CPU), over the same calls."""

    host_ms: float
    event_ms: float | None


def first_leaf(out) -> torch.Tensor:
    """The first tensor of an output pytree (tuple, dict, NamedTuple)."""
    return next(x for x in pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor))


def _dep(arr, leaf):
    """arr + 0 * (the first element of leaf): a zero-valued data
    dependency linking one call's output to the next call's input."""
    return arr + leaf.reshape(-1)[0].to(arr.dtype) * 0


class Window:
    """Host clock and, on the card, CUDA events around the timed calls
    (``with Window(device) as w: ...``, then ``w.timing(calls)``); the
    window starts and ends in a synchronize."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self.sync()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
        self.sync()
        self.host_s = time.perf_counter() - self.t0
        return False

    def timing(self, n: int) -> Timing:
        event = self.start.elapsed_time(self.end) / n if self.cuda else None
        return Timing(self.host_s * 1e3 / n, event)


def fenced_ms(fn, *args, n: int = 5, **kw):
    """(Timing, last output): ``n`` calls of fn(*args, **kw), each
    followed by a synchronize, after one warm-up call."""
    device = first_leaf(args).device
    out = fn(*args, **kw)
    with Window(device) as w:
        for _ in range(n):
            out = fn(*args, **kw)
            w.sync()
    return w.timing(n), out


def chain_ms(fn, *args, n: int = 20, arg_index: int = 0, dep=None, **kw):
    """(Timing, last output): steady-state ms per call of ``n`` dependent
    calls of fn, fenced once (scripts/_timing.py: chain_timeit).  Call
    k's ``args[arg_index]`` is ``dep(that arg, call k-1's output)``;
    the default adds 0 * the output's first element (``_dep``), so the
    argument must be a float or int tensor."""
    if dep is None:
        def dep(arg, out):
            return _dep(arg, first_leaf(out))
    device = first_leaf(args).device
    out = fn(*args, **kw)              # warm-up (a Program records here)
    args = list(args)
    with Window(device) as w:
        for _ in range(n):
            args[arg_index] = dep(args[arg_index], out)
            out = fn(*args, **kw)
    return w.timing(n), out
