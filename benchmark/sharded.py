"""What the per-layer readers of a sharded cell share
(``metrics/allreduce_ms.py``, ``metrics/strip_skew_pct.py``).

Each rank runs the readers on a context of its own
(``launcher._run_rank``), whose window is the rank's own.  The traced
loop's steps are worked out from that window (``spans``), and a replayed
sharded step holds collectives: ranks that ran different numbers of
steps would pair one rank's step with another rank's next call, and
hang.  ``agree`` first gives every rank the slowest rank's window, the
one the launcher reports.

It also times the step's stage (``ctx.stage_ms("step")``) on every rank,
once: the launcher's traced run reads that stage for a training cell's
busy time where the profiled child gives none, and no accepted reader
of the cell times it."""

from __future__ import annotations

import torch


def agree(ctx) -> None:
    """Set ``ctx.window`` to the slowest rank's and time the step's stage
    (once per context; every rank of the cell's group must call it)."""
    if getattr(ctx, "_agreed", False):
        return
    import torch.distributed as dist
    d = ctx.driver
    t = torch.tensor([ctx.window.window_s], dtype=torch.float64,
                     device=d.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=d.mesh.group)
    ctx.window = ctx.window._replace(window_s=float(t[0]))
    ctx._agreed = True
    ctx.stage_ms("step")
