"""Per-stage timing and tracing (torch mirror of ugrt/api/profiler.py).

* ``StageTimer`` — wall-clock stage timing.  Where ugrt blocks on a
  stage's result (``jax.block_until_ready``), this one calls
  ``torch.cuda.synchronize()`` when the result holds a CUDA tensor, so
  a stage's time includes its work on the card.
* ``trace_to`` — a ``torch.profiler`` context that writes a Chrome trace
  (``*.pt.trace.json``, for chrome://tracing, Perfetto or TensorBoard)
  into ``logdir``.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _holds_cuda(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_holds_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_holds_cuda(v) for v in obj)
    return False


def block_until_ready(obj):
    """Wait for the card when ``obj`` (a tensor or nested dicts, lists and
    tuples of them) holds a CUDA tensor; returns ``obj``."""
    if _holds_cuda(obj):
        torch.cuda.synchronize()
    return obj


class StageTimer:
    """Accumulates per-stage wall-clock timings across frames."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            block_until_ready(result_holder)
        self._add(name, time.perf_counter() - t0)

    def time_stage(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs, record the stage time."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:32s} {total * 1000 / n:9.2f} ms/call x{n}")
        return "\n".join(lines)


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
