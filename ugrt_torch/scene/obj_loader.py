"""OBJ / MTL scene parser (the port's copy of ugrt/scene/obj_loader.py,
unchanged but for this docstring; tests/test_torch_isolation.py holds
its result equal to ugrt's).

Python re-implementation of the reference's vendored C parser
(obj_parser/obj_parser.cpp, objLoader.cpp).  Feature set matches the
reference:

* ``v`` / ``vn`` / ``vt`` vertex data (obj_parser.cpp:163-178)
* ``f`` faces — triangles and quads, with ``v``, ``v/t``, ``v//n``,
  ``v/t/n`` index forms and negative (relative) indices
  (obj_parser.cpp:16-30, :52-101)
* ``sp`` spheres, ``pl`` planes (obj_parser.cpp:104-130)
* ``lp`` point lights, ``ld`` directional lights, ``lq`` quad lights
  (obj_parser.cpp:133-157)
* ``c`` camera (obj_parser.cpp:137 area)
* ``usemtl`` / ``mtllib`` with the MTL subset Ka/Kd/Ks/Ns/d/r/sharpness/
  Ni/illum/map_Ka (obj_parser.cpp:180-298)

Host-side I/O only — never on the hot path; outputs flat numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

MAX_VERTEX_COUNT = 4  # obj_parser.h:10 — triangles and quads only


@dataclasses.dataclass
class ObjMaterial:
    """obj_material (obj_parser.h:46-59) with its defaults."""

    name: str = ""
    texture_filename: str = ""
    amb: tuple = (0.2, 0.2, 0.2)
    diff: tuple = (0.8, 0.8, 0.8)
    spec: tuple = (1.0, 1.0, 1.0)
    reflect: float = 0.0
    refract: float = 0.0
    trans: float = 1.0
    shiny: float = 0.0
    glossy: float = 98.0
    refract_index: float = 1.0


@dataclasses.dataclass
class ObjFace:
    vertex_index: list
    normal_index: list
    texture_index: list
    vertex_count: int
    material_index: int = -1


@dataclasses.dataclass
class ObjSphere:
    pos_index: int
    up_normal_index: int
    equator_normal_index: int
    material_index: int = -1


@dataclasses.dataclass
class ObjPlane:
    pos_index: int
    normal_index: int
    rotation_normal_index: int
    material_index: int = -1


@dataclasses.dataclass
class ObjLightPoint:
    pos_index: int
    material_index: int = -1


@dataclasses.dataclass
class ObjLightDisc:
    pos_index: int
    normal_index: int
    material_index: int = -1


@dataclasses.dataclass
class ObjLightQuad:
    vertex_index: list
    material_index: int = -1


@dataclasses.dataclass
class ObjCamera:
    camera_pos_index: int
    camera_look_point_index: int
    camera_up_norm_index: int


@dataclasses.dataclass
class ObjScene:
    """objLoader output (objLoader.h:8-40) as numpy-friendly lists."""

    vertices: np.ndarray          # [V, 3] float64 (parser uses double)
    normals: np.ndarray           # [VN, 3]
    texcoords: np.ndarray         # [VT, 3]
    faces: list                   # list[ObjFace]
    spheres: list
    planes: list
    point_lights: list
    disc_lights: list
    quad_lights: list
    materials: list               # list[ObjMaterial]
    camera: ObjCamera | None


def _to_list_index(current_max: int, index: int) -> int:
    """obj_convert_to_list_index (obj_parser.cpp:16-25)."""
    if index == 0:
        return -1
    if index < 0:
        return current_max + index
    return index - 1


def _parse_face_indices(tokens, n_verts, n_tex, n_norms):
    """obj_parse_vertex_index + index conversion (obj_parser.cpp:52-101)."""
    vi, ti, ni = [], [], []
    for tok in tokens[:MAX_VERTEX_COUNT]:
        parts = tok.split("/")
        v = int(parts[0]) if parts[0] else 0
        t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi.append(_to_list_index(n_verts, v))
        ti.append(_to_list_index(n_tex, t))
        ni.append(_to_list_index(n_norms, n))
    return vi, ti, ni


def parse_mtl(path: str) -> list[ObjMaterial]:
    """obj_parse_mtl_file (obj_parser.cpp:180-298)."""
    materials: list[ObjMaterial] = []
    cur: ObjMaterial | None = None
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tokens = line.split()
            if not tokens or tokens[0] in ("#", "//"):
                continue
            cmd = tokens[0]
            if cmd == "newmtl":
                cur = ObjMaterial(name=tokens[1] if len(tokens) > 1 else "")
                materials.append(cur)
            elif cur is None:
                continue
            elif cmd == "Ka":
                cur.amb = tuple(float(x) for x in tokens[1:4])
            elif cmd == "Kd":
                cur.diff = tuple(float(x) for x in tokens[1:4])
            elif cmd == "Ks":
                cur.spec = tuple(float(x) for x in tokens[1:4])
            elif cmd == "Ns":
                cur.shiny = float(tokens[1])
            elif cmd == "d":
                cur.trans = float(tokens[1])
            elif cmd == "r":
                cur.reflect = float(tokens[1])
            elif cmd == "sharpness":
                cur.glossy = float(tokens[1])
            elif cmd == "Ni":
                cur.refract_index = float(tokens[1])
            elif cmd == "map_Ka":
                cur.texture_filename = tokens[1]
    return materials


def parse_obj(path: str) -> ObjScene:
    """obj_parse_obj_file + vector flattening (obj_parser.cpp:300-420)."""
    vertices: list = []
    normals: list = []
    texcoords: list = []
    faces: list[ObjFace] = []
    spheres: list[ObjSphere] = []
    planes: list[ObjPlane] = []
    point_lights: list[ObjLightPoint] = []
    disc_lights: list[ObjLightDisc] = []
    quad_lights: list[ObjLightQuad] = []
    materials: list[ObjMaterial] = []
    material_names: dict[str, int] = {}
    camera: ObjCamera | None = None
    current_material = -1

    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tokens = line.split()
            if not tokens or tokens[0] in ("#", "//"):
                continue
            cmd = tokens[0]

            if cmd == "v":
                vertices.append([float(x) for x in tokens[1:4]])
            elif cmd == "vn":
                normals.append([float(x) for x in tokens[1:4]])
            elif cmd == "vt":
                vals = [float(x) for x in tokens[1:4]]
                vals += [0.0] * (3 - len(vals))
                texcoords.append(vals)
            elif cmd == "f":
                vi, ti, ni = _parse_face_indices(
                    tokens[1:], len(vertices), len(texcoords), len(normals))
                faces.append(ObjFace(vi, ni, ti, len(tokens) - 1,
                                     current_material))
            elif cmd == "sp":
                vi, ti, _ = _parse_face_indices(
                    tokens[1:], len(vertices), len(texcoords), len(normals))
                # sp: pos, up-normal, equator-normal (obj_parser.cpp:104-116)
                ni = [_to_list_index(len(normals), int(t.split("/")[0]))
                      for t in tokens[2:4]] + [-1, -1]
                spheres.append(ObjSphere(vi[0], ni[0], ni[1],
                                         current_material))
            elif cmd == "pl":
                vi, ti, _ = _parse_face_indices(
                    tokens[1:], len(vertices), len(texcoords), len(normals))
                ni = [_to_list_index(len(normals), int(t.split("/")[0]))
                      for t in tokens[2:4]] + [-1, -1]
                planes.append(ObjPlane(vi[0], ni[0], ni[1], current_material))
            elif cmd == "lp":
                idx = _to_list_index(len(vertices), int(tokens[1]))
                point_lights.append(ObjLightPoint(idx, current_material))
            elif cmd == "ld":
                vi = _to_list_index(len(vertices), int(tokens[1]))
                ni = _to_list_index(len(normals), int(tokens[2]))
                disc_lights.append(ObjLightDisc(vi, ni, current_material))
            elif cmd == "lq":
                vi, _, _ = _parse_face_indices(
                    tokens[1:], len(vertices), len(texcoords), len(normals))
                quad_lights.append(ObjLightQuad(vi, current_material))
            elif cmd == "c":
                idxs = [int(t) for t in tokens[1:4]]
                camera = ObjCamera(
                    _to_list_index(len(vertices), idxs[0]),
                    _to_list_index(len(vertices), idxs[1]),
                    _to_list_index(len(normals), idxs[2]),
                )
            elif cmd == "usemtl":
                name = tokens[1] if len(tokens) > 1 else ""
                current_material = material_names.get(name, -1)
            elif cmd == "mtllib":
                mtl_path = os.path.join(base_dir, tokens[1])
                if os.path.exists(mtl_path):
                    loaded = parse_mtl(mtl_path)
                    base = len(materials)
                    materials.extend(loaded)
                    for i, m in enumerate(loaded):
                        material_names[m.name] = base + i

    def _arr(rows, width):
        if not rows:
            return np.zeros((0, width), dtype=np.float64)
        return np.asarray(rows, dtype=np.float64)

    return ObjScene(
        vertices=_arr(vertices, 3),
        normals=_arr(normals, 3),
        texcoords=_arr(texcoords, 3),
        faces=faces,
        spheres=spheres,
        planes=planes,
        point_lights=point_lights,
        disc_lights=disc_lights,
        quad_lights=quad_lights,
        materials=materials,
        camera=camera,
    )
