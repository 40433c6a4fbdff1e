"""G1 — the fixed-point segment sums of the step's gathers' backwards
(CUDA: ``csrc/segment_sum.cu``).

Replaces ugrt's transposes of its gathers (ugrt/diff/fastgrad.py):
``_face_corners_bwd`` (:129-156, a sort by face, prefix sums and CSR
differences, then the same at 3F rows onto the vertices) by
``face_corner_sum``, and ``_rows_bwd`` (:172-183, a one-hot product at
HIGHEST precision) by ``segment_sum``.  Neither is a Pallas kernel.
Both sum in 64-bit fixed point, as core/gather.py's docstring sets out,
so the bits do not depend on the order of the sum:

- ``segment_sum(values, idx, rows)``: ``out[r] = sum of values[i] over
  idx[i] == r`` (``gather_rows``, the material gather);
- ``face_corner_sum(values, fid, faces, rows)``: ``values`` [N, 9] holds
  pixel p's corner cotangents (corner j, column c at 3 j + c), keyed by
  face; the sum of ``values.reshape(-1, 3)`` keyed by
  ``faces[fid].reshape(-1)`` (``gather_face_corners``, the corner
  gather).

Each launches the kernel for CUDA tensors and runs its plain version
only for CPU tensors (``_build.Kernel``; a call with nothing to sum
launches nothing and counts no launch).  The kernel takes ``Σ|v|`` in
another order than the plain versions' ``torch.sum``; the two give
other bits only when that sum lies within its rounding of a power of
two (core/gather.py).
"""

from __future__ import annotations

import math

import torch

from ugrt_torch.kernels import _build

_FRAC_BITS = 62
# The scale pass's block partials in the scratch (csrc/segment_sum.cu,
# kPartials), keys * columns up to which the kernel accumulates in a
# shared table of every key (kSharedEntries), and the bytes of its
# shared hash table of keys (kHashBytes).
PARTIALS = 1024
SHARED_ENTRIES = 2048
HASH_BYTES = 16 * 1024
# Blocks of the accumulate pass per SM (all resident at once), and their
# threads (csrc/segment_sum.cu, kBlocksPerSM and kThreads).
BLOCKS_PER_SM = 2
THREADS = 256
# The face-keyed sum's columns: three corners of three coordinates.
CORNER_COLUMNS = 9


def fixed_point(values):
    """(fixed, shift, total): ``values`` in 64-bit fixed point as the
    plain version sums them (core/gather.py): total = sum |v| in f64, exp
    from frexp(total), each value round(v 2^shift) with shift = 62 - exp,
    as int64."""
    v = values.double()
    total = v.abs().sum()
    _, exp = torch.frexp(total)                 # total < 2^exp
    shift = (_FRAC_BITS - exp).double()
    return torch.round(torch.ldexp(v, shift)).long(), shift, total


def segment_sum_plain(values, idx, rows: int):
    """Deterministic ``out[r] = sum of values[i] over idx[i] == r``.

    values: [N, ...] floating point; idx: [N] int32 or int64 in [0, rows)
    (one outside raises, as ``index_add_`` does).  Returns [rows, ...] of
    ``values.dtype``.
    """
    fixed, shift, total = fixed_point(values)
    acc = torch.zeros((rows,) + tuple(values.shape[1:]), dtype=torch.int64,
                      device=values.device)
    acc.index_add_(0, idx.long(), fixed)
    out = torch.ldexp(acc.double(), -shift)
    out = torch.where(torch.isfinite(total), out, torch.nan)
    return out.to(values.dtype)


def face_corner_sum_plain(values, fid, faces, rows: int):
    """``face_corner_sum``'s plain version: ``segment_sum_plain`` of the
    corners, ``values.reshape(-1, 3)`` keyed by ``faces[fid]``."""
    return segment_sum_plain(values.reshape(-1, 3),
                             faces[fid].reshape(-1).long(), rows)


def table(keys: int, cols: int) -> str:
    """The table of the accumulate pass that the kernel picks for
    ``keys`` x ``cols`` (csrc/segment_sum.cu, run): every key in shared
    memory ("direct"), a shared hash table of keys ("hashed"), or, for
    rows too wide for 32 hash slots (more than 63 columns), the global
    accumulator ("global").
    The face-keyed sum's keys are the faces, of 9 columns."""
    if keys * cols <= SHARED_ENTRIES:
        return "direct"
    slots = 1
    while slots * 2 * (8 * cols + 4) <= HASH_BYTES:
        slots *= 2
    return "hashed" if slots >= 32 else "global"


def _check_values(values, dtype):
    """Raise unless values ([N, ...]) is contiguous and of ``dtype``, or
    of any floating dtype for None; returns its device."""
    if dtype is None:
        if not values.is_floating_point():
            raise TypeError(f"values: expected a floating dtype, got "
                            f"{values.dtype}")
        dtype = values.dtype
    _build.check_tensor(values, "values", dtype,
                        (None,) + tuple(values.shape[1:]), values.device)
    return values.device


def _check_rows(rows, cols):
    if not isinstance(rows, int) or rows < 0:
        raise ValueError(f"rows must be an int >= 0, got {rows!r}")
    if rows * cols >= 2**31:
        raise ValueError("segment_sum: rows * columns must be below 2^31")


def _check(values, idx, rows, dtype=None):
    """Raise unless values ([N, ...], of ``dtype``, or of any floating
    dtype for None) and idx ([N] int32) are contiguous on one device;
    returns the device."""
    dev = _check_values(values, dtype)
    _build.check_tensor(idx, "idx", torch.int32, (values.shape[0],), dev)
    _check_rows(rows, math.prod(values.shape[1:]))
    return dev


def _check_faces(values, fid, faces, rows, dtype=None):
    """Raise unless values ([N, 9]), fid ([N] int32) and faces ([F, 3]
    int32) are contiguous on one device; returns the device."""
    dev = _check_values(values, dtype)
    if values.dim() != 2 or values.shape[1] != CORNER_COLUMNS:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         f"(*, {CORNER_COLUMNS})")
    _build.check_tensor(fid, "fid", torch.int32, (values.shape[0],), dev)
    _build.check_tensor(faces, "faces", torch.int32, (None, 3), dev)
    _check_rows(rows, 3)
    if faces.shape[0] * CORNER_COLUMNS >= 2**31:
        raise ValueError("face_corner_sum: faces * 9 must be below 2^31")
    return dev


def _scratch(values, rows, cols):
    """The kernel's scratch: the accumulator, the total and the partials
    (no fill: the scale pass zeroes the accumulator)."""
    return torch.empty((rows * cols + 1 + PARTIALS,), dtype=torch.int64,
                       device=values.device)


def _grid(values):
    sms = torch.cuda.get_device_properties(values.device).multi_processor_count
    return max(1, min(-(-values.shape[0] // THREADS), BLOCKS_PER_SM * sms))


@_build.kernel(segment_sum_plain, _check)
def segment_sum(values, idx, rows: int):
    """``out[r] = sum of values[i] over idx[i] == r`` in fixed point (the
    module docstring): the CUDA kernel for CUDA tensors, the plain
    version for CPU ones.

    values: [N, ...] contiguous, f32 on the card, any floating dtype on
    the CPU; idx: [N] contiguous int32 in [0, rows) (core/gather.py: on
    the card an index outside adds nothing, on the CPU it raises).
    Returns [rows, ...] of values' dtype.
    """
    _check(values, idx, rows, torch.float32)
    cols = math.prod(values.shape[1:])
    out = torch.empty((rows,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    if rows * cols == 0:
        return out
    _build.launch("ugrt_segment_sum", values, idx, values.shape[0], rows,
                  cols, _scratch(values, rows, cols), out, _grid(values))
    return out


@_build.kernel(face_corner_sum_plain, _check_faces)
def face_corner_sum(values, fid, faces, rows: int):
    """The corner cotangents ``values`` [N, 9] of N pixels summed onto
    the ``rows`` vertices of their faces, ``faces[fid]``, in fixed point
    (the module docstring): the CUDA kernel for CUDA tensors, the plain
    version for CPU ones.

    values: [N, 9] contiguous, f32 on the card, any floating dtype on the
    CPU; fid: [N] contiguous int32 in [0, F); faces: [F, 3] contiguous
    int32 in [0, rows) (on the card a face or vertex outside adds
    nothing, on the CPU it raises).  Returns [rows, 3] of values' dtype.
    """
    _check_faces(values, fid, faces, rows, torch.float32)
    out = torch.empty((rows, 3), dtype=torch.float32, device=values.device)
    if rows == 0:
        return out
    _build.launch("ugrt_face_corner_sum", values, fid, faces,
                  values.shape[0], faces.shape[0], rows,
                  _scratch(values, rows, 3), out, _grid(values))
    return out
