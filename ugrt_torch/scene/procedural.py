"""Procedural test scenes (the port's copy of ugrt/scene/procedural.py:
``single_triangle``, ``cornell_box`` and ``cathedral`` with their
helpers; the arrays equal ugrt's, tests/test_torch_isolation.py).

The reference's scenes (sibenik.obj, crashing.obj) are not in its repo, so
tests and benchmarks use deterministic procedural stand-ins at matching
scales (sibenik ≈ 75k triangles).  These build the same flat Scene arrays
as the OBJ path.
"""

from __future__ import annotations

import numpy as np

from ugrt_torch.scene.model import Scene


def single_triangle(z: float = -3.0) -> Scene:
    """BASELINE config 1: one triangle facing a camera at the origin."""
    vertices = np.asarray(
        [[-1.0, -1.0, z], [1.0, -1.0, z], [0.0, 1.0, z]], dtype=np.float32)
    faces = np.asarray([[0, 1, 2]], dtype=np.int32)
    mat_index = np.zeros(1, dtype=np.int32)
    materials = np.asarray([[0.2, 0.2, 0.2, 0.8, 0.3, 0.3]], dtype=np.float32)
    return Scene(vertices, faces, mat_index, materials)


def _quad(v0, v1, v2, v3):
    """Two triangles for a quad, consistent winding."""
    return [[v0, v1, v2], [v0, v2, v3]]


def _subdivided_quad(p00, p10, p11, p01, n: int, base_vertex: int):
    """n x n grid of quads spanning the bilinear patch p00..p01."""
    p00, p10, p11, p01 = (np.asarray(p, dtype=np.float32)
                          for p in (p00, p10, p11, p01))
    verts = []
    for j in range(n + 1):
        fy = j / n
        left = p00 + fy * (p01 - p00)
        right = p10 + fy * (p11 - p10)
        for i in range(n + 1):
            fx = i / n
            verts.append(left + fx * (right - left))
    faces = []
    for j in range(n):
        for i in range(n):
            a = base_vertex + j * (n + 1) + i
            b = a + 1
            c = a + (n + 1) + 1
            d = a + (n + 1)
            faces.extend(_quad(a, b, c, d))
    return np.asarray(verts, dtype=np.float32), faces


def cornell_box(subdiv: int = 1) -> Scene:
    """Cornell-box-scale scene (BASELINE config 2).

    A 2x2x2 box centered at the origin, open toward +z, with two interior
    blocks.  ``subdiv`` subdivides each wall into subdiv^2 quads, scaling
    the triangle count as ~10 * 2 * subdiv^2.
    """
    verts_all = []
    faces_all = []
    mats_all = []

    def add_patch(p00, p10, p11, p01, mat, n=subdiv):
        base = sum(v.shape[0] for v in verts_all)
        v, f = _subdivided_quad(p00, p10, p11, p01, n, base)
        verts_all.append(v)
        faces_all.extend(f)
        mats_all.extend([mat] * len(f))

    s = 1.0
    # floor (y=-1), ceiling (y=1), back (z=-1), left (x=-1, red),
    # right (x=1, green)
    add_patch([-s, -s, s], [s, -s, s], [s, -s, -s], [-s, -s, -s], 0)
    add_patch([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s], 0)
    add_patch([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], 0)
    add_patch([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s], 1)
    add_patch([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s], 2)

    # Two interior blocks (axis-aligned, unsubdivided).
    def add_box(lo, hi, mat):
        lo = np.asarray(lo, dtype=np.float32)
        hi = np.asarray(hi, dtype=np.float32)
        base = sum(v.shape[0] for v in verts_all)
        corners = np.asarray(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
             [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
             [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
             [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], dtype=np.float32)
        verts_all.append(corners)
        quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                 (2, 3, 7, 6), (0, 3, 7, 4), (1, 2, 6, 5)]
        for q in quads:
            faces_all.extend(_quad(*[base + i for i in q]))
            mats_all.extend([mat, mat])

    add_box([-0.6, -1.0, -0.6], [-0.1, 0.2, -0.1], 3)
    add_box([0.15, -1.0, -0.3], [0.65, -0.4, 0.2], 3)

    vertices = np.concatenate(verts_all, axis=0)
    faces = np.asarray(faces_all, dtype=np.int32)
    mat_index = np.asarray(mats_all, dtype=np.int32)
    materials = np.asarray(
        [
            [0.4, 0.4, 0.4, 0.7, 0.7, 0.7],   # white walls
            [0.3, 0.05, 0.05, 0.8, 0.1, 0.1],  # red
            [0.05, 0.3, 0.05, 0.1, 0.8, 0.1],  # green
            [0.3, 0.3, 0.2, 0.7, 0.7, 0.5],    # blocks
        ],
        dtype=np.float32,
    )
    return Scene(vertices, faces, mat_index, materials)


def cathedral(num_faces_target: int = 75000, seed: int = 0) -> Scene:
    """Sibenik-scale stand-in (~75k triangles, BASELINE config 3).

    A long hall (30 x 20 x 10 world units, matching the sibenik camera path
    in main.cu:87-90) with heavily subdivided walls plus rows of columns,
    giving realistic grid occupancy: large walls span many cells, columns
    concentrate triangles locally.
    """
    rng = np.random.default_rng(seed)
    verts_all = []
    faces_all = []
    mats_all = []

    def add_patch(p00, p10, p11, p01, mat, n):
        base = sum(v.shape[0] for v in verts_all)
        v, f = _subdivided_quad(p00, p10, p11, p01, n, base)
        verts_all.append(v)
        faces_all.extend(f)
        mats_all.extend([mat] * len(f))

    # Hall interior: x in [0,30], y in [0,20], z in [0,10] (z-up like the
    # sibenik camera which uses up=(0,0,1)).
    # Face count: 4 big walls at 2*wall_n^2 tris each, 2 end walls at
    # 2*(wall_n//2+1)^2, plus 12 columns * 8 sides * 2*col_n^2 = 6912;
    # total ~ 9*wall_n^2 + 6912, solved for wall_n to land on target.
    col_tris = 12 * 8 * 2 * 6 * 6
    wall_n = max(4, int(np.sqrt(max(num_faces_target - col_tris, 144) / 9)))
    add_patch([0, 0, 0], [30, 0, 0], [30, 20, 0], [0, 20, 0], 0, wall_n)  # floor
    add_patch([0, 0, 10], [30, 0, 10], [30, 20, 10], [0, 20, 10], 1, wall_n)
    add_patch([0, 0, 0], [30, 0, 0], [30, 0, 10], [0, 0, 10], 2, wall_n)
    add_patch([0, 20, 0], [30, 20, 0], [30, 20, 10], [0, 20, 10], 2, wall_n)
    add_patch([30, 0, 0], [30, 20, 0], [30, 20, 10], [30, 0, 10], 3, wall_n // 2 + 1)
    add_patch([0, 0, 0], [0, 20, 0], [0, 20, 10], [0, 0, 10], 3, wall_n // 2 + 1)

    # Columns: octagonal prisms with subdivided sides.
    col_n = 6
    n_cols = 12
    for c in range(n_cols):
        cx = 4.0 + (c % 6) * 4.5
        cy = 6.0 if c < 6 else 14.0
        r = 0.6 + 0.1 * rng.random()
        for k in range(8):
            a0 = 2 * np.pi * k / 8
            a1 = 2 * np.pi * (k + 1) / 8
            p00 = [cx + r * np.cos(a0), cy + r * np.sin(a0), 0.0]
            p10 = [cx + r * np.cos(a1), cy + r * np.sin(a1), 0.0]
            p11 = [cx + r * np.cos(a1), cy + r * np.sin(a1), 9.0]
            p01 = [cx + r * np.cos(a0), cy + r * np.sin(a0), 9.0]
            add_patch(p00, p10, p11, p01, 4, col_n)

    vertices = np.concatenate(verts_all, axis=0)
    faces = np.asarray(faces_all, dtype=np.int32)
    mat_index = np.asarray(mats_all, dtype=np.int32)
    materials = np.asarray(
        [
            [0.35, 0.32, 0.28, 0.75, 0.70, 0.60],  # floor
            [0.30, 0.30, 0.35, 0.65, 0.65, 0.75],  # ceiling
            [0.32, 0.30, 0.26, 0.70, 0.66, 0.58],  # long walls
            [0.30, 0.28, 0.24, 0.66, 0.62, 0.55],  # end walls
            [0.36, 0.34, 0.30, 0.78, 0.74, 0.66],  # columns
        ],
        dtype=np.float32,
    )
    return Scene(vertices, faces, mat_index, materials)
