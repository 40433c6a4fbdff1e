"""Frozen copy of ``ugrt_torch/core/camera.py`` (lines 1-42), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Primary ray generation (torch mirror of ugrt/core/camera.py:160-189).

The camera matrices themselves (``camcoords_from_spec``) stay ugrt's
numpy code; this module only builds the per-pixel directions on the
device, in ugrt's operation order.
"""

from __future__ import annotations

import torch

from benchmark.reference.vecmath import normalize


def _scalar(x, device):
    # A fill, not a host-to-device copy (capturable; see core.program).
    return torch.full((), x, dtype=torch.float32, device=device)


def primary_ray_dirs(camcoords, width: int, height: int):
    """Per-pixel primary ray directions, [H, W, 3] float32 (normalized):
    bilerp of the four near-plane corners at x = 1 - col/W, y = row/H,
    minus the eye (trace_kernel.cu:96-114)."""
    dev = camcoords.device
    eye = camcoords[0:3]
    c0 = camcoords[4:7]
    c1 = camcoords[7:10]
    c2 = camcoords[10:13]
    c3 = camcoords[13:16]

    col = torch.arange(width, dtype=torch.float32, device=dev)
    row = torch.arange(height, dtype=torch.float32, device=dev)
    # Divide by device tensors: on CUDA, PyTorch turns division by a
    # host scalar into multiplication by its reciprocal, which can round
    # differently from ugrt's true division.
    fx = (1.0 - col / _scalar(width, dev))[None, :, None]
    fy = (row / _scalar(height, dev))[:, None, None]

    bottom = c0[None, None, :] + fx * (c1 - c0)[None, None, :]
    top = c3[None, None, :] + fx * (c2 - c3)[None, None, :]
    pt = bottom + fy * (top - bottom)
    return normalize(pt - eye[None, None, :])
