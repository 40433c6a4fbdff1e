"""Frozen copy of ``ugrt_torch/core/gather.py`` (lines 1-131), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Gathers whose backward sums exactly, in any order, on any device
(torch mirror of ugrt/diff/fastgrad.py).

autograd's backward of ``table[idx]`` is index accumulation.  On CUDA
that is a sort-based kernel that walks each row's duplicates one after
another: the material gather of a 1024² frame sends ~1M pixels into a
handful of rows, and its backward took 204 ms of a 252 ms step (NVIDIA
H100 80GB HBM3, 700 W).  Float atomics would be fast but sum in a
different order on every run.

The gathers here sum their cotangents in 64-bit fixed point instead,
the deterministic sum ugrt gets from sorting (diff/fastgrad.py:129-186)
reached without a sort: each cotangent is rounded to a multiple of q,
the power of two with q >= 2^-62 * sum|g| (sum|g| over the whole
cotangent), and integer addition is exact and associative, so any order
of the sum gives the same bits.  No partial sum can exceed 2^62 in
magnitude.  Error of a row's sum before its f32 rounding: at most n * q
/ 2 for n duplicates, i.e. below 2^-38 * sum|g| for n < 2^23; a sum that
is not finite comes out NaN.

The routes, as in ugrt:

- ``gather_face_corners(vertices, faces, fid)`` (fastgrad.py:92-159) and
  ``gather_face_data(vertices, faces, aux, fid)`` (:59-89): one [F, 9]
  (or [F, 9 + A]) per-face table, ``vertices[faces]``, and one row
  gather of it per pixel; bitwise ``vertices[faces[fid]]``, since both
  are pure gathers.  The backward sums the pixels' [N, 9] cotangents
  keyed by face onto the vertices, ``kernels.face_corner_sum``; ``aux``
  gets no gradient.
- ``gather_rows(table, idx)`` (:162-186): ``table[idx]``, summed back by
  row with ``kernels.segment_sum`` (the materials).

On the card the sums are the hand-written kernel G1
(``csrc/segment_sum.cu``), on the CPU their plain versions
(``index_add_`` of the int64 values; the face-keyed sum's keys are
``faces[fid]``, one per corner).  The two routes differ in two ways.
They take sum|g|, the one floating-point sum, in different orders, each
fixed (the kernel's by a fixed partition and trees); so they give the
same bits unless sum|g| lies within its rounding of a power of two,
where they may pick q one binade apart.  The kernel takes f32
cotangents, the plain versions any floating dtype.  And an index
outside its table (a row, a face, or a face's vertex) is a caller's
error that the two treat differently: ``index_add_`` raises, the kernel
drops its contribution.
"""

from __future__ import annotations

import torch

from benchmark.reference.sweeps import face_corner_sum, segment_sum


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
        return segment_sum(flat.contiguous(),
                           idx.reshape(-1).to(torch.int32).contiguous(),
                           ctx.rows), None


def gather_rows(table, idx):
    """``table[idx]`` for an int32 or int64 index tensor of any shape,
    with ``segment_sum`` as its backward into ``table``."""
    return _GatherRows.apply(table, idx)


def _corner_sum(ctx, grad):
    """The backward of both face gathers: [N, 3, 3] cotangents summed
    onto the vertices of their faces."""
    faces, fid = ctx.saved_tensors
    if grad is None:
        return None
    return face_corner_sum(grad.reshape(fid.numel(), 9).contiguous(),
                           fid.reshape(-1).contiguous(), faces, ctx.rows)


class _GatherFaceCorners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, faces, fid):
        ctx.save_for_backward(faces, fid)
        ctx.rows = vertices.shape[0]
        tbl = vertices[faces].reshape(faces.shape[0], 9)
        return tbl[fid].reshape(fid.shape + (3, 3))

    @staticmethod
    def backward(ctx, grad):
        return _corner_sum(ctx, grad), None, None


class _GatherFaceData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, faces, aux, fid):
        ctx.save_for_backward(faces, fid)
        ctx.rows = vertices.shape[0]
        tbl = torch.cat([vertices[faces].reshape(faces.shape[0], 9), aux],
                        dim=1)
        rows = tbl[fid]
        aux_rows = rows[..., 9:]
        ctx.mark_non_differentiable(aux_rows)
        return rows[..., :9].reshape(fid.shape + (3, 3)), aux_rows

    @staticmethod
    def backward(ctx, grad, _aux_grad):
        return _corner_sum(ctx, grad), None, None, None


def gather_face_corners(vertices, faces, fid):
    """``vertices[faces[fid]]`` [..., 3, 3] as one [F, 9] per-face table
    and one row gather a pixel, with ``face_corner_sum`` as its backward
    into ``vertices`` (fastgrad.py:92-159).

    vertices: [V, 3]; faces: [F, 3] int32; fid: int32 face ids in [0, F)
    (misses clamped to 0 by the caller, with zero cotangents)."""
    return _GatherFaceCorners.apply(vertices, faces, fid)


def gather_face_data(vertices, faces, aux, fid):
    """``gather_face_corners`` plus per-face ``aux`` [F, A] columns riding
    the same row gather of an [F, 9 + A] table (fastgrad.py:59-89).
    Returns (corners [..., 3, 3], aux rows [..., A]); ``aux`` gets no
    gradient."""
    return _GatherFaceData.apply(vertices, faces, aux, fid)
