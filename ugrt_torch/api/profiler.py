"""The port's spans and counters, and ``trace_to``.

The one recorder of the program's own tracing.  The frame and step paths
open named spans where their work happens (``renderer.upload``,
``bridge.camera``, ``program.call``, ``program.replay``, the stages
``grid.perspective``, ``trace.primary``, ``trace.shadow``, ...; the
table is in PERF.md §3) and add to named counters (``count``).

* ``span(name, device=False, request=False)``: a context manager.  While
  the recorder is on (inside ``tracing()``) it records its name, host
  start and end (``time.perf_counter_ns()``), its parent span and the
  request id that the spans of one frame or step share.  A ``request``
  span (``program.call``, ``train.step``) that closes with no parent
  ends its request: the spans opened before it since the last such
  close (a client's vertex upload and camera matrices) share its id.
  ``spanned(name, ...)`` is its decorator form.
* Off, ``span`` costs a flag check and returns the shared ``NOOP``: no
  allocation, no event, no sync.  Whenever a ``torch.profiler`` session
  is active, on or off, a span also opens a ``record_function`` range of
  its name, so that a profiled run's host timeline names program code.
* ``device=True``: on the card, with the recorder on, the span also
  records a CUDA timing event at open and at close.  One anchor maps the
  events onto the host clock: an event recorded right after the
  ``synchronize()`` with which ``tracing()`` starts, paired with its
  ``perf_counter_ns``.  The events are read lazily (at the next call of
  a captured program, or when ``tracing()`` ends), never by a sync in
  the path.  On the CPU, where work is synchronous, a device span's
  interval is its host interval.
* Inside a CUDA graph capture (``core.program``), device spans record
  their events as graph nodes (``Event(external=True)``) into the
  capture's template, and host spans record nothing: the body's Python
  does not run on a replay.  Each replay of the graph adds one copy of
  the template's spans under that replay's ``program.replay`` span,
  whose events are read before the graph's next replay overwrites
  them.  A ``Program`` called with the recorder on captures a key of its
  own for this (its key plus "traced"); off, it replays the graph it
  always did.
* ``tracing(device=None)`` yields the ``Recording``: per-name totals with
  self time (duration minus the child spans' cover), the counters, and
  ``report()``.  One thread records; sessions do not nest.
* ``trace_to(logdir)``: a ``torch.profiler`` context that writes a
  Chrome trace (``*.pt.trace.json``) into ``logdir``; the spans appear
  on it as ``record_function`` ranges.

This module imports only ``torch``, so ``core/`` and ``bridge`` may
import it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch
from torch._C._autograd import _profiler_enabled

_on = False            # inside tracing()
_rec = None            # the session's Recording
_stack: list = []      # the open spans, innermost last
_template = None       # the Template of a graph being captured


class _Noop:
    """The span of an off recorder with no profiler session."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Span:
    """One recorded span.  ``t0``/``t1``: host ns (None for a span that
    ran inside a replayed graph); ``d0``/``d1``: its device interval in
    host-clock ns, once read (None for a host span, or where the events
    could not be read)."""

    __slots__ = ("name", "parent", "rid", "t0", "t1", "events", "d0", "d1")

    def __init__(self, name, parent, rid):
        self.name = name
        self.parent = parent
        self.rid = rid
        self.t0 = self.t1 = self.d0 = self.d1 = None
        self.events = None


def span(name: str, device: bool = False, request: bool = False):
    """A context manager over the block (module docstring); ``with ... as
    s`` gives the ``Span`` while the recorder is on."""
    if _on:
        return _Open(name, device, request)
    if _profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return NOOP


def spanned(name: str, device: bool = False):
    """``span`` as a decorator: each call of the function is a span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on and not _profiler_enabled():
                return fn(*args, **kwargs)
            with span(name, device):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on (inside
    a capture: once per replay of the graph)."""
    if _on:
        counts = _template.counts if _template is not None else _rec.counts
        counts[name] = counts.get(name, 0) + n


def recording() -> bool:
    """Whether the recorder is on."""
    return _on


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "device", "request", "span", "range")

    def __init__(self, name, device, request):
        self.name, self.device, self.request = name, device, request
        self.span = self.range = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        if _template is not None and not self.device:
            return None       # a host span inside a capture: not replayed
        s = Span(self.name, _stack[-1] if _stack else None, _rec.rid)
        if self.device and _rec.cuda:
            external = _template is not None
            s.events = (torch.cuda.Event(enable_timing=True,
                                         external=external),
                        torch.cuda.Event(enable_timing=True,
                                         external=external))
            s.events[0].record()
        _stack.append(s)
        self.span = s
        s.t0 = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        if s is not None:
            s.t1 = time.perf_counter_ns()
            if s.events is not None:
                s.events[1].record()
            if _stack and _stack[-1] is s:
                _stack.pop()
            if _template is not None:
                _template.spans.append(s)
            else:
                if self.device and s.events is None:
                    s.d0, s.d1 = s.t0, s.t1
                _rec.spans.append(s)
                if self.request and s.parent is None:
                    _rec.rid += 1
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Template:
    """What a capture recorded: its device spans (parents within the
    template, None at the top) and counts, copied into the recording
    on each replay (``replayed``)."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}


@contextlib.contextmanager
def capturing():
    """Around a graph capture: yields the ``Template`` that the body's
    spans and counts go to, or None when the recorder is off."""
    global _template, _stack
    if not _on:
        yield None
        return
    saved, template = _stack, Template()
    _stack, _template = [], template
    try:
        yield template
    finally:
        _stack, _template = saved, None


def replayed(template, replay: Span) -> list:
    """One replay of a captured graph: a copy of each of ``template``'s
    spans, under the ``program.replay`` span ``replay`` and in its
    request, is recorded (its events read later by ``read_replay``);
    the template's counts are added.  Returns the copies."""
    if not _on or template is None or replay is None:
        return []
    copies = {}
    for t in template.spans:
        copies[id(t)] = Span(t.name, None, replay.rid)
        copies[id(t)].events = t.events
    out = []
    for t in template.spans:
        s = copies[id(t)]
        s.parent = copies.get(id(t.parent), replay)
        out.append(s)
    _rec.spans.extend(out)
    for name, n in template.counts.items():
        _rec.counts[name] = _rec.counts.get(name, 0) + n
    return out


def read_replay(copies: list) -> None:
    """Read the device intervals of a replay's spans (``replayed``) before
    the same graph replays again.  If the card has not reached the last
    of them yet (the caller never waited on that replay's outputs), they
    are dropped, counted as ``program.unread_replays``: nothing here
    waits on the card.  The reading is the span ``profiler.read``, the
    recorder's own cost inside ``program.call``."""
    pending = [s for s in copies if s.events is not None and s.d0 is None]
    if not pending or not _on:
        return
    with span("profiler.read"):
        if pending[-1].events[1].query():   # the last one the graph records
            for s in pending:
                _rec.read(s)
        else:
            for s in pending:
                s.events = None
            count("program.unread_replays")


class Totals(NamedTuple):
    """Per-name totals of a recording, ns: host time over the calls that
    ran on the host, self time (host time minus the child spans'
    cover), device time over the calls with a device interval."""

    calls: int
    host_ns: int
    self_ns: int
    device_calls: int
    device_ns: int


class Recording:
    """The spans and counters of one ``tracing()`` session."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans: list = []
        self.counts: dict = {}
        self.rid = 0
        self.anchor = None
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.anchor = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            self.anchor.record(torch.cuda.current_stream(self.device))
            t1 = time.perf_counter_ns()
            self.anchor_ns = (t0 + t1) // 2
            self.anchor.synchronize()

    def read(self, s: Span) -> None:
        """Span ``s``'s device interval from its events (complete)."""
        e0, e1 = s.events
        s.d0 = self.anchor_ns + int(self.anchor.elapsed_time(e0) * 1e6)
        s.d1 = s.d0 + int(e0.elapsed_time(e1) * 1e6)
        s.events = None

    def finish(self) -> None:
        """Read every device interval still unread (the session's last
        replays and eager device spans), waiting for the card here, once,
        at the session's end."""
        for s in self.spans:
            if s.events is not None and s.d0 is None:
                s.events[1].synchronize()
                self.read(s)

    def totals(self) -> dict:
        """name -> ``Totals``, in the order the names first closed."""
        cover: dict = {}
        for s in self.spans:
            if s.parent is not None and s.t0 is not None:
                cover.setdefault(id(s.parent), []).append((s.t0, s.t1))
        acc: dict = {}
        for s in self.spans:
            calls, host, own, dcalls, dev = acc.get(s.name, (0, 0, 0, 0, 0))
            calls += 1
            if s.t0 is not None:
                host += s.t1 - s.t0
                own += s.t1 - s.t0 - _union(cover.get(id(s), ()))
            if s.d0 is not None:
                dcalls += 1
                dev += s.d1 - s.d0
            acc[s.name] = (calls, host, own, dcalls, dev)
        return {k: Totals(*v) for k, v in acc.items()}

    def report(self) -> str:
        """Per span name: calls, host ms per call, self ms per call and
        device ms per call where it has device intervals; then the
        counters."""
        lines = [f"{'span':20s} {'calls':>6s} {'host ms':>9s} "
                 f"{'self ms':>9s} {'device ms':>9s}"]
        for name, t in self.totals().items():
            host = (f"{t.host_ns / t.calls / 1e6:9.3f}" if t.host_ns
                    else f"{'-':>9s}")
            own = (f"{t.self_ns / t.calls / 1e6:9.3f}" if t.host_ns
                   else f"{'-':>9s}")
            dev = (f"{t.device_ns / t.device_calls / 1e6:9.3f}"
                   if t.device_calls else f"{'-':>9s}")
            lines.append(f"{name:20s} {t.calls:6d} {host} {own} {dev}")
        for name, n in sorted(self.counts.items()):
            lines.append(f"{name:20s} {n:6d}")
        return "\n".join(lines)


def _union(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@contextlib.contextmanager
def tracing(device=None):
    """Record spans and counters inside the block; yields the
    ``Recording``.  ``device``: where the work runs (default the card
    when there is one); on the card the session starts with one
    ``synchronize()`` for the events' anchor."""
    global _on, _rec
    if _on:
        raise RuntimeError("tracing() is already on")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    rec = Recording(device)
    _rec, _on = rec, True
    try:
        yield rec
    finally:
        _on = False
        _stack.clear()
        rec.finish()


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace of the block (host, and the card's kernels
    when CUDA is available), written into ``logdir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
