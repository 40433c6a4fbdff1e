"""Sharding over torch.distributed process groups (``dist.mesh``), and the
one reduction helper that the frame body shares with it."""

from __future__ import annotations

import torch.distributed as dist

from ugrt_torch.api import profiler


def all_reduce(x, op, group):
    """``x`` reduced with ``op`` (a ``dist.ReduceOp``) over ``group``, as a
    new tensor of x's shape and dtype; ``x`` itself where ``group`` is
    None.  It travels flat, so a 0-d scalar goes as the 1-element tensor
    every backend takes, and comes back bit for bit.  The reduction is
    the device span ``mesh.allreduce``; it counts in ``mesh.collectives``
    and its bytes in ``mesh.allreduce_bytes``."""
    if group is None:
        return x
    flat = x.reshape(-1).clone()
    profiler.count("mesh.collectives")
    profiler.count("mesh.allreduce_bytes", flat.numel() * flat.element_size())
    with profiler.span("mesh.allreduce", device=True):
        dist.all_reduce(flat, op=op, group=group)
    return flat.reshape(x.shape)
