"""Primary ray generation (torch mirror of ugrt/core/camera.py:160-189).

The camera matrices themselves (``camcoords_from_spec``) stay ugrt's
numpy code; this module only builds the per-pixel directions on the
device, in ugrt's operation order.
"""

from __future__ import annotations

import torch

from ugrt_torch.core.vecmath import normalize, scalar


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
    fx = (1.0 - col / scalar(width, dev))[None, :, None]
    fy = (row / scalar(height, dev))[:, None, None]

    bottom = c0[None, None, :] + fx * (c1 - c0)[None, None, :]
    top = c3[None, None, :] + fx * (c2 - c3)[None, None, :]
    pt = bottom + fy * (top - bottom)
    return normalize(pt - eye[None, None, :])
