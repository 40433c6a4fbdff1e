"""Frozen copy of ``ugrt_torch/trace/heavy.py`` (lines 1-52), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Heavy-face coefficients (torch mirror of ugrt/trace/heavy.py:49-77).

All primary rays share the eye and all of a light's shadow rays share the
light, so Möller–Trumbore against a heavy face collapses to dot products
of the ray direction with per-face constants:

    det = d.a,  u*det = d.b,  v*det = d.c,  t*det = k
    a = e2 x e1,  b = e2 x tvec,  c = tvec x e1,  k = e2.c

ugrt's ``heavy_min_t`` / ``heavy_shadowed`` (heavy.py:100-192) have no
runtime counterpart here: the heavy sweeps are the CUDA kernels K2
(kernels/heavy_primary_sweep.py) and K3 with ``box=True``
(kernels/shadow_sweep.py), and ``heavy_min_t`` stays their op-order spec.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.vecmath import cross, dot


class HeavyCoeffs(NamedTuple):
    """Per-heavy-face triple-product coefficients for one ray origin."""

    a: torch.Tensor       # [H, 3] e2 x e1      (det = d.a)
    b: torch.Tensor       # [H, 3] e2 x tvec    (u*det = d.b)
    c: torch.Tensor       # [H, 3] tvec x e1    (v*det = d.c)
    k: torch.Tensor       # [H]    e2.c         (t*det)
    face: torch.Tensor    # [H] int32 face id (-1 pad)
    live: torch.Tensor    # [H] bool
    ranges: torch.Tensor  # [H, 4] int32 footprint (gxmin, gxmax, gymin, gymax)


def heavy_coeffs(vertices, faces, heavy_faces, heavy_count, origin,
                 heavy_ranges) -> HeavyCoeffs:
    """Coefficients of the heavy list; origin = eye (primary) or light."""
    H = heavy_faces.shape[0]
    fidx = torch.clamp(heavy_faces, 0, faces.shape[0] - 1).long()
    v = vertices[faces[fidx].long()]          # [H, 3, 3]
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    tvec = origin[None, :] - v0
    c = cross(tvec, e1)
    live = torch.arange(H, dtype=torch.int32,
                        device=heavy_faces.device) < heavy_count
    return HeavyCoeffs(cross(e2, e1), cross(e2, tvec), c, dot(e2, c),
                       heavy_faces.to(torch.int32), live,
                       heavy_ranges.to(torch.int32))
