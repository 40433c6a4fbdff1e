"""Frozen copy of ``ugrt_torch/trace/refine.py`` (lines 1-75), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Differentiable hit refinement (torch mirror of ugrt/trace/refine.py).

The trace (grid build, K1-K3) decides each pixel's winning face and is
piecewise constant in the scene, so it runs on detached vertices.  Here
the Möller–Trumbore t (trace_kernel.cu:4-45) and the geometric normal
(:232-253) are re-evaluated at the winning face in PyTorch ops, so
autograd carries the image's gradient into ``vertices[faces[fid]]``:
exact almost everywhere (away from visibility edges) at O(pixels) cost.

As ugrt does (refine.py:45-67), the corners come from one [F, 9] per-face
table (with ``face_aux``, [F, 9 + A]) and one row gather a pixel,
``gather.gather_face_corners`` / ``gather_face_data``; their backward
sums the pixels' cotangents keyed by face onto the vertices in fixed
point, exact in any order: on the card the kernel G1
(``kernels.segment_sum.face_corner_sum``).  The |t| and |normal| quirks
take ``vecmath.absolute``, whose derivative at 0 is ugrt's.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.gather import gather_face_corners, gather_face_data
from benchmark.reference.vecmath import absolute, cross, dot, normalize


def refine_primary(vertices, faces, camcoords, primary_raw,
                   cfg: RenderConfig, face_aux=None):
    """Recompute (t, normal, u, v) at the winning faces, differentiably
    in ``vertices``.

    primary_raw: ``trace_primary``'s result; its face_id decides, its t
    is recomputed.  Misses keep the reference sentinels t = -1 and
    normal = -1.  face_aux: optional [F, A] f32 per-face data (such as
    ``shaders.face_shade_meta``), gathered to the pixels with the corners
    and returned as "aux" [H, W, A].
    """
    fid = primary_raw["face_id"]
    dirs = primary_raw["ray_dir"].detach()
    eye = camcoords[0:3]
    hit = fid >= 0
    H, W = fid.shape
    f = torch.clamp(fid, min=0).reshape(-1)
    aux = None
    if face_aux is not None:
        v, aux = gather_face_data(vertices, faces, face_aux, f)
    else:
        v = gather_face_corners(vertices, faces, f)    # [H*W, 3, 3]
    d = dirs.reshape(H * W, 3)
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    tvec = eye[None, :] - v0

    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / det
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    vv = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    if cfg.quirks.abs_t:
        t = absolute(t)

    n = normalize(cross(normalize(e1), normalize(e2)))
    if cfg.quirks.abs_normal:
        n = absolute(n)

    out = dict(t=torch.where(hit, t.reshape(H, W), -1.0), face_id=fid,
               normal=torch.where(hit[..., None], n.reshape(H, W, 3), -1.0),
               ray_dir=dirs, u=u.reshape(H, W), v=vv.reshape(H, W))
    if aux is not None:
        out["aux"] = aux.reshape((H, W) + face_aux.shape[1:])
    return out
