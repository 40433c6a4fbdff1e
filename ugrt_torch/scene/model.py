"""Scene model: flat arrays + materials (the port's copy of the parts of
ugrt/scene/model.py that the port uses).

Copied: ``Scene``, ``load_material_file`` (the reference's custom
material format, scene.h:370-439), ``load_scene`` and
``load_dynamic_scene`` (Model::load_model, scene.h:70-331).  The port
parses OBJ files with the Python parser (``scene.obj_loader``) alone:
ugrt's optional ctypes loader of the C parser (ugrt/scene/native.py) is
not copied, and both give the same arrays.  ugrt's writers and vertex
animation are not used by the port and are not copied.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from ugrt_torch.scene.obj_loader import parse_obj

MATERIAL_SIZE = 6  # main.cu.h:34


@dataclasses.dataclass
class Scene:
    """Flat scene arrays (mirrors Model's device buffers, scene.h:24-27)."""

    vertices: np.ndarray    # [V, 3] float32
    faces: np.ndarray       # [F, 3] int32
    mat_index: np.ndarray   # [F]    int32
    materials: np.ndarray   # [M, 6] float32 — ambient rgb, diffuse rgb

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_materials(self) -> int:
        return self.materials.shape[0]


def load_material_file(path: str) -> np.ndarray:
    """The reference's custom material format (scene.h:370-439).

    Per material: ``newmtl <name> <tag>`` then 3 ambient floats, one token,
    3 diffuse floats, 11 skipped tokens, then a texture filename or ``NA``.
    The parser is pure token-skipping with fixed counts; we replicate that
    exactly (including ignoring the names).
    """
    with open(path, "r", errors="replace") as fh:
        tokens = fh.read().split()

    num_materials = sum(1 for t in tokens if t == "newmtl")
    mats = np.zeros((num_materials, MATERIAL_SIZE), dtype=np.float32)

    pos = 0
    for mt in range(num_materials):
        pos += 3  # 3 tokens skipped (scene.h:402-403)
        mats[mt, 0:3] = [float(tokens[pos + i]) for i in range(3)]
        pos += 3
        pos += 1  # 1 token skipped (scene.h:409)
        mats[mt, 3:6] = [float(tokens[pos + i]) for i in range(3)]
        pos += 3
        pos += 11  # 11 tokens skipped (scene.h:415-416)
        pos += 1   # texture filename or NA (scene.h:418-426)
    return mats


def load_scene(obj_path: str, material_path: str | None = None) -> Scene:
    """Model::load_model static path (scene.h:226-331).

    Faces are truncated to their first three vertex indices — the reference
    reads only vertex_index[0..2] even for quads (scene.h:249-253).
    """
    parsed = parse_obj(obj_path)
    num_faces = len(parsed.faces)

    faces = np.zeros((num_faces, 3), dtype=np.int32)
    mat_index = np.zeros(num_faces, dtype=np.int32)
    for f, face in enumerate(parsed.faces):
        faces[f] = face.vertex_index[:3]
        mat_index[f] = face.material_index

    vertices = parsed.vertices.astype(np.float32)

    if material_path is not None:
        materials = load_material_file(material_path)
    elif parsed.materials:
        materials = np.asarray(
            [list(m.amb) + list(m.diff) for m in parsed.materials],
            dtype=np.float32,
        )
    else:
        materials = np.asarray([[0.5, 0.5, 0.5, 0.8, 0.8, 0.8]],
                               dtype=np.float32)
        mat_index[:] = np.maximum(mat_index, 0)

    return Scene(vertices=vertices, faces=faces, mat_index=mat_index,
                 materials=materials)


def load_dynamic_scene(dir_path: str, material_path: str | None = None,
                       num_frames: int | None = None) -> list[Scene]:
    """Dynamic multi-frame scenes: ``dir/f_<i>.obj`` (scene.h:70-120).

    The face topology and materials come from frame 0; later frames only
    update vertices (scene.h:97-119).
    """
    if num_frames is None:
        frame_re = re.compile(r"f_(\d+)\.obj$")
        found = [int(m.group(1)) for f in os.listdir(dir_path)
                 if (m := frame_re.match(f))]
        num_frames = max(found) + 1 if found else 0

    base = load_scene(os.path.join(dir_path, "f_0.obj"), material_path)
    scenes = [base]
    for i in range(1, num_frames):
        parsed = parse_obj(os.path.join(dir_path, f"f_{i}.obj"))
        scenes.append(dataclasses.replace(
            base, vertices=parsed.vertices.astype(np.float32)))
    return scenes
