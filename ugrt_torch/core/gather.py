"""Row gathers whose backward sums exactly, in any order, on any device.

autograd's backward of ``table[idx]`` is index accumulation.  On CUDA
that is a sort-based kernel that walks each row's duplicates one after
another: the material gather of a 1024² frame sends ~1M pixels into a
handful of rows, and its backward took 204 ms of a 252 ms step (NVIDIA
H100 80GB HBM3, 700 W).  Float atomics would be fast but sum in a
different order on every run.

``gather_rows`` sums the cotangents in 64-bit fixed point instead, the
deterministic segment sum ugrt gets from sorting (diff/fastgrad.py:
129-186) reached without a sort: each cotangent is rounded to a multiple
of q, the power of two with q >= 2^-62 * sum|g| (sum|g| over the whole
cotangent), and integer addition is exact and associative, so any order
of the sum gives the same bits.  No partial sum can exceed 2^62 in
magnitude.  Error of a row's sum before its f32 rounding: at most
n * q / 2 for n duplicates, i.e. below 2^-38 * sum|g| for n < 2^23; a
sum that is not finite comes out NaN.

The sum is ``kernels.segment_sum``: on the card the hand-written kernel
G1 (``csrc/segment_sum.cu``: warp-grouped 64-bit integer atomics), on the
CPU ``segment_sum_plain`` (``index_add_`` of the int64 values).  The two
take sum|g|, the one floating-point sum, in different orders, each fixed
(the kernel's by a fixed partition and trees); so they give the same
bits unless sum|g| lies within its rounding of a power of two, where
they may pick q one binade apart.  The kernel takes f32 cotangents, the
plain version any floating dtype.  An index outside [0, rows) is a
caller's error that the two treat differently: ``index_add_`` raises,
the kernel drops its contribution.
"""

from __future__ import annotations

import torch

from ugrt_torch.kernels.segment_sum import segment_sum


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
        return segment_sum(flat.contiguous(), idx.reshape(-1).contiguous(),
                           ctx.rows), None


def gather_rows(table, idx):
    """``table[idx]`` for an int64 index tensor of any shape, with
    ``segment_sum`` as its backward into ``table``."""
    return _GatherRows.apply(table, idx)
