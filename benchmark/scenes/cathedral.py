"""Scene generator ``cathedral``: a frozen copy of the procedural
cathedral, the stand-in for sibenik.obj at its published face count.

``cathedral`` is copied from ``ugrt_torch/scene/procedural.py``
(``_quad`` :24-26, ``_subdivided_quad`` :29-50, ``cathedral`` :103-181),
so that a later change to the program's generator cannot change what the
benchmark renders.  The copy also records where each column's vertices
lie (``Scene.columns``), which the dynamic-frame traffic animates.
``benchmark/tests`` holds its arrays equal to the program's at seed 0.

The seed moves only the twelve column radii (0.6 + 0.1 * U[0, 1)); the
vertex and face counts do not depend on it.  Parameters (the
configuration's ``scene`` object): ``num_faces_target``.
"""

from __future__ import annotations

import numpy as np

from benchmark.scene import Column, Scene


def build(params: dict, seed: int) -> Scene:
    """The scene of a configuration's ``scene`` object."""
    return cathedral(int(params["num_faces_target"]), seed)


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


def cathedral(num_faces_target: int = 75000, seed: int = 0) -> Scene:
    """Sibenik-scale stand-in: a 30 x 20 x 10 hall with subdivided walls
    and twelve subdivided octagonal columns (the program's generator,
    arrays equal)."""
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
        return base, v.shape[0]

    col_tris = 12 * 8 * 2 * 6 * 6
    wall_n = max(4, int(np.sqrt(max(num_faces_target - col_tris, 144) / 9)))
    add_patch([0, 0, 0], [30, 0, 0], [30, 20, 0], [0, 20, 0], 0, wall_n)
    add_patch([0, 0, 10], [30, 0, 10], [30, 20, 10], [0, 20, 10], 1, wall_n)
    add_patch([0, 0, 0], [30, 0, 0], [30, 0, 10], [0, 0, 10], 2, wall_n)
    add_patch([0, 20, 0], [30, 20, 0], [30, 20, 10], [0, 20, 10], 2, wall_n)
    add_patch([30, 0, 0], [30, 20, 0], [30, 20, 10], [30, 0, 10], 3,
              wall_n // 2 + 1)
    add_patch([0, 0, 0], [0, 20, 0], [0, 20, 10], [0, 0, 10], 3,
              wall_n // 2 + 1)

    col_n = 6
    n_cols = 12
    columns = []
    for c in range(n_cols):
        cx = 4.0 + (c % 6) * 4.5
        cy = 6.0 if c < 6 else 14.0
        r = 0.6 + 0.1 * rng.random()
        start = sum(v.shape[0] for v in verts_all)
        for k in range(8):
            a0 = 2 * np.pi * k / 8
            a1 = 2 * np.pi * (k + 1) / 8
            p00 = [cx + r * np.cos(a0), cy + r * np.sin(a0), 0.0]
            p10 = [cx + r * np.cos(a1), cy + r * np.sin(a1), 0.0]
            p11 = [cx + r * np.cos(a1), cy + r * np.sin(a1), 9.0]
            p01 = [cx + r * np.cos(a0), cy + r * np.sin(a0), 9.0]
            add_patch(p00, p10, p11, p01, 4, col_n)
        end = sum(v.shape[0] for v in verts_all)
        columns.append(Column(start, end - start, cx, cy))

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
    return Scene(vertices, faces, mat_index, materials, tuple(columns))

