"""The reflection DDA's edge case: a small synthetic scene and rays, made
with numpy from a seed, that take every branch of ``trace_uniform_dda``
and of the kernel D1 (``kernels.uniform_dda``).

- one cell of the 4^3 grid holds far more than ``MAX_BATCHES * BATCH``
  faces (overflow, and batches past the first);
- two coincident triangles (the same corners, consecutive face ids)
  give equal t: the first face in CSR order must win;
- an open box (a floor and four walls, no lid) whose faces span many
  cells, so that most rays inside it hit;
- rays with one or two exact zero direction components (the 1e-20 guard
  of the slab test), among them axis-aligned rays onto the coincident
  pair from outside the box;
- rays that start outside the AABB, rays that miss it, rays inside the
  deep cell, inactive rays, and rays whose own face is excluded.

The tests hold the port's plain DDA to ugrt's on it (CPU), and the
kernel to the plain version (card); chip_smoke phase 8 runs it too.
"""

from __future__ import annotations

import numpy as np
import torch

DIMS = (4, 4, 4)
CAPACITY = 1 << 13
MAX_BATCHES = 2
BATCH = 4
RAYS = 4096


def dda_edge_case(seed: int = 0):
    """numpy dict(vertices [V, 3] f32, faces [F, 3] i32, origins, dirs
    [N, 3] f32, active [N] bool, exclude [N] i32, lo, hi [3] f32: the
    padded scene AABB) from ``seed``."""
    rng = np.random.default_rng(seed)
    tris = []
    # Scattered triangles of a few cells each, none over the coincident
    # pair below.
    centers = rng.uniform(0.05, 0.95, (300, 3))
    centers = centers[(centers[:, 0] > 0.55) | (centers[:, 1] > 0.55)]
    tris.append(centers[:, None, :]
                + rng.uniform(-0.08, 0.08, (centers.shape[0], 3, 3)))
    # 24 tiny triangles inside one cell: deeper than 2 batches of 4.
    centers = rng.uniform(0.58, 0.67, (24, 3))
    tris.append(centers[:, None, :] + rng.uniform(-0.02, 0.02, (24, 3, 3)))
    # The coincident pair, in the plane z = 0.3.
    pair = np.asarray([[0.2, 0.2, 0.3], [0.45, 0.2, 0.3], [0.2, 0.45, 0.3]])
    tris.append(np.stack([pair, pair]))
    # An open box: the floor z = 0 and four walls, two triangles each
    # (faces spanning 16 cells), with no lid.
    q = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], float)
    for axis, level in ((2, 0.0), (0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)):
        wall = np.insert(q, axis, level, axis=1).reshape(2, 3, 3)
        tris.append(wall)
    tri = np.concatenate(tris).astype(np.float32)
    vertices = tri.reshape(-1, 3)
    faces = np.arange(vertices.shape[0], dtype=np.int32).reshape(-1, 3)
    num_faces = faces.shape[0]

    origins = rng.uniform(-0.3, 1.3, (RAYS, 3))
    dirs = rng.standard_normal((RAYS, 3))
    a, b, c = 1024, 1536, 1792
    # One exact zero component, then axis-aligned rays down onto the pair
    # from above the box, then rays starting inside the deep cell.
    dirs[a:b][np.arange(b - a), rng.integers(0, 3, b - a)] = 0.0
    origins[b:c, 0:2] = rng.uniform(0.21, 0.3, (c - b, 2))
    origins[b:c, 2] = 1.2
    dirs[b:c] = (0.0, 0.0, -1.0)
    origins[c:c + 256] = rng.uniform(0.58, 0.67, (256, 3))
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    active = rng.random(RAYS) < 0.85
    active[b:c] = True
    exclude = rng.integers(-1, num_faces, RAYS).astype(np.int32)
    exclude[b:c] = -1

    lo = vertices.min(axis=0) - np.float32(1e-3)
    hi = vertices.max(axis=0) + np.float32(1e-3)
    return dict(vertices=vertices, faces=faces,
                origins=origins.astype(np.float32),
                dirs=dirs.astype(np.float32), active=active,
                exclude=exclude, lo=lo, hi=hi)


def dda_edge_inputs(device, seed: int = 0, dims: tuple = DIMS):
    """``uniform_dda``'s positional arguments for the edge case on
    ``device``: (ftab, grid, origins, dirs, active, exclude, lo, hi,
    dims); its keywords but ``cfg`` are MAX_BATCHES, BATCH, skip_k 6 and
    eps 1e-4 (trace_uniform_dda's defaults).  A coarser grid than DIMS
    gives deeper cells (2^3: up to 73 faces)."""
    from ugrt_torch.grid.build import build_uniform_grid
    from ugrt_torch.trace.reflect import face_table

    case = dda_edge_case(seed)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in case.items()}
    grid = build_uniform_grid(t["vertices"], t["faces"], t["lo"], t["hi"],
                              grid_dims=dims, capacity=CAPACITY)
    return (face_table(t["vertices"], t["faces"]), grid, t["origins"],
            t["dirs"], t["active"], t["exclude"], t["lo"], t["hi"], dims)
