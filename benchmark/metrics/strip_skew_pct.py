"""strip_skew_pct: how far the slowest rank's own work a step lies above
the mean of the ranks', in %.  A rank's own work is the device ms a
step of the span ``mesh.strip`` (its strip of the sharded step:
``render_color`` and the backward, before the final sums) less the
device ms of the ``mesh.allreduce`` spans inside it (the light window's
reductions, which wait for the other strips).  Read from a traced
``train()`` job of the traced loop's length (``spans``, the same on
every rank: ``sharded.agree``; a warm-up job first, which captures the
traced key), then gathered over the cell's group by one all-reduce:
max / mean - 1.

Every rank computes the same value; it goes back to the launcher as a
stage of that name.  None on one card, or where the program has no
such span (every rank still joins the all-reduce)."""

import math

import torch

from benchmark import sharded, spans

NAME = "strip_skew_pct"


def read(ctx):
    if ctx.driver is None:          # the launcher's reduction of the ranks
        return ctx.stages.get(NAME)
    d = ctx.driver
    if d.mesh is None:
        return None
    sharded.agree(ctx)
    import torch.distributed as dist
    own = torch.zeros(d.mesh.world_size, dtype=torch.float64,
                      device=d.device)
    own[d.mesh.rank] = _own_ms(ctx)
    dist.all_reduce(own, group=d.mesh.group)
    ms = own.tolist()
    mean = sum(ms) / len(ms)
    if not (math.isfinite(mean) and mean > 0):
        return None
    value = 100.0 * (max(ms) / mean - 1.0)
    ctx.stages.cache[NAME] = value
    return value


def _own_ms(ctx) -> float:
    """This rank's strip less the all-reduces inside it, ms a strip; NaN
    where no strip span has a device interval."""
    try:
        from ugrt_torch.api import profiler
    except ImportError:
        return math.nan
    if not hasattr(profiler, "tracing"):
        return math.nan
    d, w = ctx.driver, ctx.window
    seconds = min(spans.SECONDS, w.window_s)
    steps = max(1, round(seconds / (w.window_s / w.attempted)))
    with profiler.tracing(d.device):
        d.train(spans.WARM_STEPS)
    with profiler.tracing(d.device) as rec:
        d.train(steps)
    strips = [s for s in rec.spans if s.name == "mesh.strip"
              and s.d0 is not None]
    if not strips:
        return math.nan
    inside = sum(s.d1 - s.d0 for s in rec.spans
                 if s.name == "mesh.allreduce" and s.d0 is not None
                 and _inside(s, "mesh.strip"))
    return (sum(s.d1 - s.d0 for s in strips) - inside) / len(strips) / 1e6


def _inside(span, name) -> bool:
    p = span.parent
    while p is not None and p.name != name:
        p = p.parent
    return p is not None
