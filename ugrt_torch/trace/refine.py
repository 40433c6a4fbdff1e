"""Differentiable hit refinement (torch mirror of ugrt/trace/refine.py).

The trace (grid build, K1-K3) decides each pixel's winning face and is
piecewise constant in the scene, so it runs on detached vertices.  Here
the Möller–Trumbore t (trace_kernel.cu:4-45) and the geometric normal
(:232-253) are re-evaluated at the winning face in PyTorch ops, so
autograd carries the image's gradient into ``vertices[faces[fid]]``:
exact almost everywhere (away from visibility edges) at O(pixels) cost.

ugrt gathers the corners through custom VJPs that sort the cotangents
by face and take prefix-sum differences (diff/fastgrad.py:93-160); here
``gather.gather_rows`` fetches them and sums its backward in fixed point,
exact in any order.  The |t| and |normal| quirks take
``vecmath.absolute``, whose derivative at 0 is ugrt's.
"""

from __future__ import annotations

import torch

from ugrt.config import RenderConfig
from ugrt_torch.core.gather import gather_rows
from ugrt_torch.core.vecmath import absolute, cross, dot, normalize


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
    f = torch.clamp(fid, min=0).reshape(-1).long()
    v = gather_rows(vertices, faces[f].long())         # [H*W, 3, 3]
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
    if face_aux is not None:
        out["aux"] = face_aux[f].reshape((H, W) + face_aux.shape[1:])
    return out
