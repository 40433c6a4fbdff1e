"""Scene model: flat arrays + materials + animation (the port's copy of
ugrt/scene/model.py).

``Scene`` (with its ``aabb``), ``load_material_file`` (the reference's
custom material format, scene.h:370-439), ``load_scene`` and
``load_dynamic_scene`` (Model::load_model, scene.h:70-331), the writers
``write_obj`` and ``write_material_file``, and ``rotate_subrange`` (the
bunny animation, transformation_kernel.cu:4-18), which takes a numpy
array or a torch tensor where ugrt takes ``xp=``.  ``load_scene`` takes
the native C++ parser (``scene.native``) when a material file is given
and a C++ compiler exists, the Python parser (``scene.obj_loader``)
otherwise; both give the same arrays.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

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

    @property
    def aabb(self):
        """(min, max) per axis — scene.h:272-293."""
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


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


def write_obj(path: str, scene: Scene) -> None:
    """Deterministic OBJ writer — the round-trip partner of load_scene.

    Emits ``v`` lines with 9 significant digits (exact float32 round
    trip), ``usemtl m<k>`` switches wherever the face material index
    changes, and 1-indexed ``f`` lines — the subset of the grammar both
    the Python parser (obj_loader) and the native C++ parser
    (native/ugrt_native.cpp) consume.  A sibling ``<path>.mtl`` holds
    ``newmtl m0..mM`` in index order (both parsers assign material ids
    by mtllib registration order, so ``m<k>`` maps back to index k).
    """
    mtl_name = os.path.basename(path) + ".mtl"
    with open(path + ".mtl", "w") as fh:
        for k, m in enumerate(np.asarray(scene.materials,
                                         dtype=np.float32)):
            fh.write(f"newmtl m{k}\n"
                     f"Ka {m[0]:.9g} {m[1]:.9g} {m[2]:.9g}\n"
                     f"Kd {m[3]:.9g} {m[4]:.9g} {m[5]:.9g}\n")
    lines = [f"mtllib {mtl_name}"]
    for v in scene.vertices:
        lines.append(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}")
    last_mat = None
    for f in range(scene.num_faces):
        m = int(scene.mat_index[f])
        if m != last_mat:
            lines.append(f"usemtl m{m}")
            last_mat = m
        a, b, c = (int(x) + 1 for x in scene.faces[f])
        lines.append(f"f {a} {b} {c}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_material_file(path: str, materials: np.ndarray) -> None:
    """Write the reference's custom material format (the exact token
    grammar load_material_file / some_material consumes, scene.h:370-439):
    per material ``newmtl <name> <tag>``, 3 ambient floats, one skipped
    token, 3 diffuse floats, 11 skipped tokens, a texture name (NA)."""
    toks = []
    for k, m in enumerate(np.asarray(materials, dtype=np.float32)):
        toks.append(f"newmtl m{k} t{k}")
        toks.append(f"{m[0]:.9g} {m[1]:.9g} {m[2]:.9g}")
        toks.append("Kd")
        toks.append(f"{m[3]:.9g} {m[4]:.9g} {m[5]:.9g}")
        toks.append("0 0 0 0 0 0 0 0 0 0 0")  # 11 skipped tokens
        toks.append("NA")
    with open(path, "w") as fh:
        fh.write("\n".join(toks) + "\n")


def load_scene(obj_path: str, material_path: str | None = None,
               prefer_native: bool = True) -> Scene:
    """Model::load_model static path (scene.h:226-331).

    Faces are truncated to their first three vertex indices — the reference
    reads only vertex_index[0..2] even for quads (scene.h:249-253).

    With a material file, uses the native C++ parser (``scene.native``)
    where a C++ compiler exists, else the Python parser; MTL-color scenes
    (no material file) always take the Python parser.
    """
    # The native fast path covers the reference's own flow (a custom
    # material file supplies the colors; the OBJ only contributes
    # usemtl indices).
    if prefer_native and material_path is not None:
        from ugrt_torch.scene import native

        fast = native.parse_obj_fast(obj_path)
        if fast is not None:
            vertices, faces, mat_index = fast
            return Scene(vertices=vertices, faces=faces, mat_index=mat_index,
                         materials=native.parse_materials_fast(material_path))

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


def rotate_subrange(vertices, orig_subrange, offset: int, rot_factor: float):
    """copy_data_transform (transformation_kernel.cu:4-18).

    Normalizes a vertex sub-range about (12, 11, 4.5)/12, rotates it by
    ``rot_factor`` in the xy plane, rescales by 9 and re-centers at
    (14.5, 13, 4).  Used for the conference-scene bunny animation
    (scene.h:122-139).  Returns a new full vertex array: numpy for numpy
    ``vertices``, a tensor on their device for a torch tensor.
    """
    c = np.cos(np.float32(rot_factor))
    s = np.sin(np.float32(rot_factor))

    def rotated(o, twelve):
        x = (o[:, 0] - 12.0) / twelve
        y = (o[:, 1] - 11.0) / twelve
        z = (o[:, 2] - 4.5) / twelve
        return [(x * c - y * s) * 9.0 + 14.5, (x * s + y * c) * 9.0 + 13.0,
                z * 9.0 + 4.0]

    if isinstance(vertices, torch.Tensor):
        dev = vertices.device
        o = torch.as_tensor(orig_subrange, dtype=torch.float32, device=dev)
        # A device divisor: on CUDA a Python one becomes a multiply by its
        # reciprocal.
        new = torch.stack(rotated(o, torch.tensor(12.0, device=dev)), dim=-1)
        out = vertices.clone()
    else:
        o = np.asarray(orig_subrange, dtype=np.float32)
        new = np.stack(rotated(o, 12.0), axis=-1).astype(np.float32)
        out = np.array(vertices, copy=True)
    out[offset:offset + new.shape[0]] = new
    return out
