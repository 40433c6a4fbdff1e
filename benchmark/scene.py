"""The benchmark's scenes: the arrays every configuration renders, made
from ``--seed`` by the generator that its ``scene`` object names
(``"generator": "<name>"`` is ``scenes/<name>.py``, found by
``registry.scene_builder``; the rest of the object is its parameters).

A generator's ``build(params, seed)`` returns a ``Scene``.  A later
scene (a Cornell box, a larger cathedral, a loaded OBJ) is a new file in
``scenes/`` and a configuration that names it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Column(NamedTuple):
    """A part that the dynamic-frame traffic turns about its own vertical
    axis: its vertex rows [start, start + count) and its axis (cx, cy)."""

    start: int
    count: int
    cx: float
    cy: float


class Scene(NamedTuple):
    """Flat scene arrays, as the program's ``scene.model.Scene`` holds
    them, and the parts that the traffic may animate (none is fine)."""

    vertices: np.ndarray    # [V, 3] float32
    faces: np.ndarray       # [F, 3] int32
    mat_index: np.ndarray   # [F] int32
    materials: np.ndarray   # [M, 6] float32
    columns: tuple


def generate(params: dict, seed: int) -> Scene:
    """The scene of a configuration's ``scene`` object for ``seed``."""
    from benchmark import registry
    return registry.scene_builder(params["generator"])(params, seed)


def rotate_columns(scene: Scene, angles) -> np.ndarray:
    """The scene's vertices with column i turned by ``angles[i]`` radians
    about its own vertical axis (float32 [V, 3]; the rest stays)."""
    v = scene.vertices.copy()
    for col, a in zip(scene.columns, angles):
        rows = slice(col.start, col.start + col.count)
        x = v[rows, 0].astype(np.float64) - col.cx
        y = v[rows, 1].astype(np.float64) - col.cy
        c, s = np.cos(a), np.sin(a)
        v[rows, 0] = (col.cx + c * x - s * y).astype(np.float32)
        v[rows, 1] = (col.cy + s * x + c * y).astype(np.float32)
    return v
