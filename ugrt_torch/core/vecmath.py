"""float32 vector/matrix helpers (torch mirror of ugrt/core/vecmath.py).

Every function keeps ugrt's exact operation order — products summed
left to right, normalize as multiply by 1/sqrt — and each torch op
rounds once to f32, so results are bitwise equal to ugrt's evaluated op
by op (and to the numpy oracle's).  ``rotate_basis`` is written as three
broadcast multiply-adds instead of a matmul so no library GEMM (which
may fuse or reorder the sums) decides its rounding.

``sqrt`` and ``acos`` are taken in float64 and rounded once to float32:
torch's vectorized CPU sqrt is not correctly rounded (measured: 0.66% of
random f32 inputs off by an ulp; numpy's and CUDA's sqrtf are exact),
and float32 acos differs between torch, numpy and XLA by up to 2 ulp.
Through float64 both are correctly rounded for practical purposes and
give the same bits on the CPU and on the card.
"""

from __future__ import annotations

import torch


def cross(a, b):
    """CROSS macro (main.cu.h:44-47)."""
    return torch.stack(
        [a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def dot(a, b):
    """DOT macro (main.cu.h:49)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sqrt(x):
    """Correctly rounded f32 square root (see the module docstring)."""
    return torch.sqrt(x.double()).to(x.dtype)


def acos(x):
    """f32 arccos rounded once from float64 (see the module docstring)."""
    return torch.acos(x.double()).to(x.dtype)


def absolute(x):
    """|x| with ugrt's (JAX's) derivative at the kink: +1 at x = +-0, where
    torch.abs has 0.  The forward equals torch.abs bit for bit (x + 0.0
    turns -0 into +0).  The port's gradients follow ugrt's at the
    reference's abs quirks, which axis-aligned geometry puts exactly on
    the kink (a normal component of 0)."""
    return torch.where(x >= 0, x + 0.0, -x)


def magnitude(a):
    """getMagnitude (grid_kernel.cu:354-363)."""
    return sqrt(dot(a, a))


def normalize(a):
    """NORMALIZE macro (main.cu.h:56): multiply by 1/sqrt."""
    inv = 1.0 / sqrt(dot(a, a))
    return a * inv[..., None]


def transform_point(mat_flat, p3):
    """Transform [..., 3] points by a column-major flat 4x4, w-divide."""
    m = mat_flat.reshape(4, 4)  # m[c, r]
    out = (p3[..., 0:1] * m[0] + p3[..., 1:2] * m[1]
           + p3[..., 2:3] * m[2] + m[3])
    return out[..., :3] / out[..., 3:4]


def rotate_basis(mv_flat, v3):
    """3x3 rotation block of a modelview: out[r] = sum_c mv[c*4+r]*v[c]."""
    m = mv_flat.reshape(4, 4)[:3, :3]  # m[c, r]
    return v3[..., 0:1] * m[0] + v3[..., 1:2] * m[1] + v3[..., 2:3] * m[2]
