"""Row gathers whose backward sums exactly, in any order, on any device.

autograd's backward of ``table[idx]`` is index accumulation.  On CUDA
that is a sort-based kernel that walks each row's duplicates one after
another: the material gather of a 1024² frame sends ~1M pixels into a
handful of rows, and its backward took 204 ms of a 252 ms step (NVIDIA
H100 80GB HBM3, 700 W).  Float atomics (``index_add_``) would be fast
but sum in a different order on every run.

``gather_rows`` sums the cotangents in 64-bit fixed point instead, the
deterministic segment sum ugrt gets from sorting (diff/fastgrad.py:
129-186) reached without a sort: each cotangent is rounded to a multiple
of q, the power of two with q >= 2^-62 * sum|g| (sum|g| over the whole
cotangent), and integer addition is exact and associative, so
``index_add_``'s atomics give the same bits in any order, on the card
and on the CPU alike.  No partial sum can exceed 2^62 in magnitude.
Error of a row's sum before its f32 rounding: at most n * q / 2 for n
duplicates, i.e. below 2^-38 * sum|g| for n < 2^23; a sum that is not
finite comes out NaN.
"""

from __future__ import annotations

import torch

_FRAC_BITS = 62


def segment_sum(values, idx, rows: int):
    """Deterministic ``out[r] = sum of values[i] over idx[i] == r``.

    values: [N, ...] floating point; idx: [N] int64 in [0, rows).  Returns
    [rows, ...] of ``values.dtype``.
    """
    v = values.double()
    total = v.abs().sum()
    _, exp = torch.frexp(total)                 # total < 2^exp
    shift = (_FRAC_BITS - exp).double()
    fixed = torch.round(torch.ldexp(v, shift)).long()
    acc = torch.zeros((rows,) + tuple(values.shape[1:]), dtype=torch.int64,
                      device=values.device)
    acc.index_add_(0, idx, fixed)
    out = torch.ldexp(acc.double(), -shift)
    out = torch.where(torch.isfinite(total), out, torch.nan)
    return out.to(values.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = grad.reshape((idx.numel(),) + tuple(grad.shape[idx.dim():]))
        return segment_sum(flat, idx.reshape(-1), ctx.rows), None


def gather_rows(table, idx):
    """``table[idx]`` for an int64 index tensor of any shape, with
    ``segment_sum`` as its backward into ``table``."""
    return _GatherRows.apply(table, idx)
