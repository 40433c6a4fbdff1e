"""G1 — the fixed-point segment sum of ``gather_rows``'s backward (CUDA:
``csrc/segment_sum.cu``).

Replaces ugrt's transposes of its row gathers (ugrt/diff/fastgrad.py):
``_face_corners_bwd`` (:129-156, sort, prefix sum and CSR differences,
twice) and ``_rows_bwd`` (:172-183, a one-hot product at HIGHEST
precision).  Neither is a Pallas kernel.  ``out[r] = sum of values[i]
over idx[i] == r``, summed in 64-bit fixed point as core/gather.py's
docstring sets out, so the bits do not depend on the order of the sum.

``segment_sum`` launches the kernel for CUDA tensors and runs
``segment_sum_plain`` only for CPU tensors.  The kernel takes ``Σ|v|``
in another order than the plain version's ``torch.sum``; the two give
other bits only when that sum lies within its rounding of a power of
two (core/gather.py).
"""

from __future__ import annotations

import math

import torch

from ugrt_torch.kernels import _build

_FRAC_BITS = 62
# The scale pass's block partials in the scratch (csrc/segment_sum.cu,
# kPartials), rows * columns up to which the kernel accumulates in
# shared memory (kSharedEntries), and the bytes of its shared hash table
# (kHashBytes).
PARTIALS = 1024
SHARED_ENTRIES = 4096
HASH_BYTES = 24 * 1024
# Blocks of the accumulate pass per SM (all resident at once), and their
# threads (csrc/segment_sum.cu, kThreads).
BLOCKS_PER_SM = 4
THREADS = 256


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

    values: [N, ...] floating point; idx: [N] int64 in [0, rows) (one
    outside raises, as ``index_add_`` does).  Returns [rows, ...] of
    ``values.dtype``.
    """
    fixed, shift, total = fixed_point(values)
    acc = torch.zeros((rows,) + tuple(values.shape[1:]), dtype=torch.int64,
                      device=values.device)
    acc.index_add_(0, idx, fixed)
    out = torch.ldexp(acc.double(), -shift)
    out = torch.where(torch.isfinite(total), out, torch.nan)
    return out.to(values.dtype)


def table(rows: int, cols: int) -> str:
    """The accumulate pass's table that the kernel picks for ``rows`` x
    ``cols`` (csrc/segment_sum.cu, ugrt_segment_sum): every row in shared
    memory ("direct"), a shared hash table of rows ("hashed"), or, for
    rows too wide for 32 hash slots, the global accumulator ("global")."""
    if rows * cols <= SHARED_ENTRIES:
        return "direct"
    slots = 1
    while slots * 2 * (8 * cols + 4) <= HASH_BYTES:
        slots *= 2
    return "hashed" if slots >= 32 else "global"


def _check(values, idx, rows, dtype=None):
    """Raise unless values ([N, ...], of ``dtype``, or of any floating
    dtype for None) and idx ([N] int64) are contiguous on one device."""
    dev = values.device
    if not isinstance(rows, int) or rows < 0:
        raise ValueError(f"rows must be an int >= 0, got {rows!r}")
    if dtype is None:
        if not values.is_floating_point():
            raise TypeError(f"values: expected a floating dtype, got "
                            f"{values.dtype}")
        dtype = values.dtype
    _build.check_tensor(values, "values", dtype,
                        (None,) + tuple(values.shape[1:]), dev)
    _build.check_tensor(idx, "idx", torch.int64, (values.shape[0],), dev)
    if rows * math.prod(values.shape[1:]) >= 2**31:
        raise ValueError("segment_sum: rows * columns must be below 2^31")


def _launch(values, idx, rows):
    """The kernel on f32 CUDA tensors (anything else raises)."""
    _check(values, idx, rows, torch.float32)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum's CUDA kernel needs CUDA tensors, "
                         f"not {values.device}")
    n = values.shape[0]
    cols = math.prod(values.shape[1:])
    out = torch.empty((rows,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    if rows * cols == 0:
        return out
    scratch = torch.zeros((rows * cols + 2 + PARTIALS,), dtype=torch.int64,
                          device=values.device)
    sms = torch.cuda.get_device_properties(values.device).multi_processor_count
    grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))
    _build.launch("ugrt_segment_sum", values, idx, n, rows, cols, scratch,
                  out, grid)
    return out


def segment_sum(values, idx, rows: int):
    """``out[r] = sum of values[i] over idx[i] == r`` in fixed point (the
    module docstring): the CUDA kernel for CUDA tensors, the plain
    version for CPU ones.

    values: [N, ...] contiguous, f32 on the card, any floating dtype on
    the CPU; idx: [N] contiguous int64 in [0, rows) (core/gather.py: on
    the card an index outside adds nothing, on the CPU it raises).
    Returns [rows, ...] of values' dtype.
    """
    _check(values, idx, rows)
    if values.device.type == "cpu":
        return segment_sum_plain(values, idx, rows)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    out = _launch(values, idx, rows)
    if out.numel():
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
