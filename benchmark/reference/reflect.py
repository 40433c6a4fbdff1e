"""Frozen copy of ``ugrt_torch/trace/reflect.py`` (lines 1-105), kept for the benchmark's
reference; it imports nothing of ``ugrt_torch``.  The original docstring follows.

Reflection rays through the world-space uniform grid (torch mirror of
ugrt/trace/reflect.py:43-283).

From each primary hit, the mirror direction about the SIGNED geometric
normal oriented against the incoming ray; then a 3-D DDA
(Amanatides–Woo) through the uniform grid of
``grid.build.build_uniform_grid``.  Per DDA step each live ray first
skips up to ``skip_k`` empty cells, then tests its cell's faces in
batches of B (``moller_trumbore_t`` with signed t) up to ``max_batches``
batches, keeps the min t and the first face reaching it (strictly
smaller t replaces), and stops once that t lies before the cell's exit
(+ eps).  Hits at t <= eps and on the ray's own face are rejected;
misses report t = -1 and face -2.  A cell deeper than max_batches * B
faces sets ``overflow``.

ugrt chunks the rays (``lax.map``) and runs a ``lax.while_loop`` per
chunk for the TPU's memory and control flow.  A ray's (t, face) depends
on that ray alone and the step bound gx + gy + gz is global, so the port
traces each ray on its own: on the card the kernel D1
(``kernels.uniform_dda``, ``csrc/uniform_dda.cu``) runs one thread per
ray, the lanes of a warp staging each cell's faces together, in one
launch with no host read, which lets the reflective frame be
captured (``api.renderer.render_frame_reflective``); on the CPU its
plain version runs all rays as PyTorch ops compacted to the live ones.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.vecmath import dot, normalize
from benchmark.reference.build import DeviceGrid
from benchmark.reference.sweeps import uniform_dda


def reflect_directions(primary):
    """Mirror reflection of the primary ray at the hit normal, the
    normal first oriented against the incoming direction:
    n <- -sign(d.n) n, r = d - 2 (d.n) n."""
    d = primary["ray_dir"]
    n = primary["normal"]
    s = torch.where(dot(d, n) > 0, -1.0, 1.0)[..., None]
    n = n * s
    return d - 2.0 * dot(d, n)[..., None] * n


def face_table(vertices, faces):
    """[F, 12] f32 per-face corner table (v0, e1, e2, then 3 zeros): one
    row gather per (ray, face) test, a row three aligned 16-byte loads in
    D1.  Its first nine columns are ugrt's [F, 9] table."""
    fv = vertices[faces.long()]
    return torch.cat([fv[:, 0], fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0],
                      torch.zeros_like(fv[:, 0])], dim=1)


def trace_uniform_dda(vertices, faces, grid: DeviceGrid, origins, dirs,
                      active, exclude_face, aabb_min, aabb_max,
                      grid_dims, cfg: RenderConfig, *,
                      max_batches: int = 4, eps: float = 1e-4,
                      batch: int | None = None, skip_k: int = 6,
                      width: int | None = None):
    """Trace rays through a uniform grid with 3-D DDA.

    origins/dirs: [N, 3] float32; active: [N] bool; exclude_face: [N]
    int32 face to ignore (self-hit); aabb_min/aabb_max: [3] f32 tensors.
    ``batch`` defaults to cfg.tri_batch; ``width``: the image width when
    the rays are an image's pixels in row-major order.  Returns dict(t
    [N] (-1: miss), face_id [N] int32 (-2: miss), overflow (0-d bool
    tensor), steps (0-d int32 tensor: DDA steps run))."""
    dev = origins.device
    return uniform_dda(
        face_table(vertices, faces), grid, origins, dirs, active.bool(),
        exclude_face.to(torch.int32),
        aabb_min.to(dtype=torch.float32, device=dev),
        aabb_max.to(dtype=torch.float32, device=dev), tuple(grid_dims),
        cfg=cfg, max_batches=max_batches, eps=eps,
        batch=batch if batch is not None else cfg.tri_batch, skip_k=skip_k,
        width=width)


def reflection_pass(vertices, faces, primary_refined, uniform_grid,
                    aabb_min, aabb_max, grid_dims, cfg: RenderConfig,
                    primary_eye, *, max_batches: int = 4,
                    batch: int | None = None):
    """Second-level trace: reflect the primary hits (their ``normal``
    signed, not the abs quirk's) and trace the uniform grid.  Returns
    per-pixel dict(t, face_id, ray_dir, origin) of the reflection hit,
    shapes [H, W(, 3)], with ``overflow`` and ``steps``."""
    H, W = primary_refined["t"].shape
    n = H * W
    t = primary_refined["t"].reshape(n)
    d = primary_refined["ray_dir"].reshape(n, 3)
    face = primary_refined["face_id"].reshape(n)

    origins = primary_eye[None] + t[:, None] * d
    rdir = normalize(reflect_directions(dict(
        ray_dir=d, normal=primary_refined["normal"].reshape(n, 3))))
    res = trace_uniform_dda(vertices, faces, uniform_grid, origins, rdir,
                            face >= 0, face, aabb_min, aabb_max, grid_dims,
                            cfg, max_batches=max_batches, batch=batch,
                            width=W)
    return dict(t=res["t"].reshape(H, W), face_id=res["face_id"].reshape(H, W),
                ray_dir=rdir.reshape(H, W, 3), origin=origins.reshape(H, W, 3),
                overflow=res["overflow"], steps=res["steps"])
