"""The program's own spans over the cell's own loop, for the readers of
in-loop times (``metrics/*.loop``, ``upload_ms``, ``camera_ms``,
``dispatch_ms.*``, ``launch_ms.train``, ``replay_ms.*``, ``adam_ms``).

Once per traced run, cached on the readers' context as ``sites()`` is:
the program's recorder on (``ugrt_torch.api.profiler.tracing``), a short
warm-up that captures the traced keys of the cell's programs (a program
called with the recorder on captures a key of its own, with the body's
device spans as event nodes), then, in a second session, the cell's loop
for ``SECONDS`` or the traced window's length where that is shorter:

- frames: the driver's ``window()`` (``driver.kept``, which the check
  reads, saved and restored);
- training: ``driver.train(n)``, n the steps of that time at the
  window's step rate (not ``window()``, which would overwrite the
  losses and the record that the check reads).

The recorder is off again before the next reader runs.  A metric is the
mean per frame or step of the loop: a span's host ms (``host_ms``,
``dispatch_ms``) or device ms (``device_ms``, CUDA events read on the
host's clock).  Where
the program has no recorder, or a span was not recorded or has no
device interval, the reader gets None.

The run prints one line per span name (calls, host, self and device ms
per frame or step) and the traced loop's frame or step ms beside the
untraced window's.
"""

from __future__ import annotations

import time
from typing import NamedTuple

SECONDS = 2.0
WARM_STEPS = 2


class Loop(NamedTuple):
    totals: dict          # span name -> the recorder's Totals
    count: int            # frames or steps of the loop
    seconds: float        # the loop's host time


def loop(ctx):
    """The cell's traced loop (module docstring), or None where the
    program records no spans."""
    if not hasattr(ctx, "_spans"):
        ctx._spans = _run(ctx)
    return ctx._spans


def host_ms(ctx, *names):
    """Host ms per frame or step of the spans ``names``, summed."""
    lp = loop(ctx)
    if lp is None or not all(n in lp.totals for n in names):
        return None
    return sum(lp.totals[n].host_ns for n in names) / lp.count / 1e6


def dispatch_ms(ctx):
    """Host ms per frame or step of the program's call (``program.call``)
    less the recorder's own reading of the last replay's events inside it
    (``profiler.read``, absent where nothing was read)."""
    call = host_ms(ctx, "program.call")
    if call is None:
        return None
    return call - (host_ms(ctx, "profiler.read") or 0.0)


def device_ms(ctx, *names):
    """Device ms per frame or step of the spans ``names``, summed; None
    unless each has device intervals."""
    lp = loop(ctx)
    if lp is None or not all(n in lp.totals and lp.totals[n].device_calls
                             for n in names):
        return None
    return sum(lp.totals[n].device_ns for n in names) / lp.count / 1e6


def _run(ctx):
    try:
        from ugrt_torch.api import profiler
    except ImportError:
        return None
    if not hasattr(profiler, "tracing"):
        return None
    d, w = ctx.driver, ctx.window
    seconds = min(SECONDS, w.window_s)
    if d.cell.traffic["kind"] == "train":
        steps = max(1, round(seconds / (w.window_s / w.attempted)))
        with profiler.tracing(d.device):
            d.train(WARM_STEPS)
        with profiler.tracing(d.device) as rec:
            t0 = time.perf_counter()
            d.train(steps)
            elapsed = time.perf_counter() - t0
        count = steps
    else:
        kept = d.kept
        try:
            with profiler.tracing(d.device):
                d.setup(seconds)
            with profiler.tracing(d.device) as rec:
                traced = d.window(seconds)
        finally:
            d.kept = kept
        count, elapsed = traced.attempted, traced.window_s
    if not rec.spans:
        return None
    lp = Loop(rec.totals(), count, elapsed)
    _print(lp, w)
    return lp


def _print(lp, w):
    what = "step" if "train.step" in lp.totals else "frame"
    print(f"spans: {lp.count} {what}s traced in {lp.seconds:.3f} s, "
          f"{lp.seconds / lp.count * 1e3:.4f} ms a {what} (untraced "
          f"window {w.window_s / w.attempted * 1e3:.4f})", flush=True)
    for name, t in lp.totals.items():
        dev = (f"{t.device_ns / lp.count / 1e6:.4f}" if t.device_calls
               else "-")
        print(f"spans: {name} calls {t.calls / lp.count:g}/{what} host "
              f"{t.host_ns / lp.count / 1e6:.4f} self "
              f"{t.self_ns / lp.count / 1e6:.4f} device {dev} ms/{what}",
              flush=True)
