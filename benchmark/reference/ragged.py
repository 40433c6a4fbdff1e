"""Frozen copy of ``ugrt_torch/core/ragged.py`` (lines 1-19), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Ragged-expansion primitive (torch mirror of ugrt/core/ragged.py:86-97).

ugrt's ``searchsorted_2level`` and ``dense_int_bounds`` work around the
TPU's serial binary search; on the GPU ``torch.searchsorted`` is the
primitive, so they have no counterpart here.
"""

from __future__ import annotations

import torch


def segment_ids_from_starts(starts, capacity: int):
    """Dense segment ids for positions arange(capacity):
    max{f : starts[f] <= p}; positions past the last segment's end give
    F-1 (callers mask with their own validity predicate)."""
    p = torch.arange(capacity, dtype=starts.dtype, device=starts.device)
    ids = torch.searchsorted(starts, p, right=True) - 1
    return ids.to(torch.int32)
