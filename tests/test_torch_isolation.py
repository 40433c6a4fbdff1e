"""ugrt_torch imports nothing of ugrt, and its copies of ugrt's host
modules equal the originals.

The guard test imports every module of the port, and every import
statement of chip_smoke.py, in a fresh interpreter where ``ugrt`` cannot
be imported.  The copy tests hold each copied object to ugrt's: configs
field for field, the packed camera vector and the procedural scenes
bitwise, the OBJ parser on a small file, the OBJ and material writers
byte for byte, the vertex animation bitwise.  Tolerance: none.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ugrt import config as config_j
from ugrt.core import camera as cam_j
from ugrt.scene import model as model_j
from ugrt.scene import obj_loader as obj_j
from ugrt.scene import procedural as proc_j
from ugrt_torch import bridge
from ugrt_torch import config as config_t
from ugrt_torch.core import host_camera as cam_t
from ugrt_torch.scene import model as model_t
from ugrt_torch.scene import obj_loader as obj_t
from ugrt_torch.scene import procedural as proc_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py:170-179 (chip_smoke's flagship) and tests/conftest.py's
# Cornell camera and light.
CAMERAS = {
    "bench": dict(eye=(3.0, 15.0, 5.0), look_at=(13.0, 13.0, 3.0),
                  up=(0.0, 0.0, 1.0)),
    "bench_light": dict(eye=(14.0, 13.0, 8.0), look_at=(14.0, 13.0, 0.0),
                        up=(0.0, 1.0, 0.0)),
    "cornell": dict(eye=(0.123, 0.071, 2.531), look_at=(-0.037, 0.011, 0.0),
                    up=(0.02, 1.0, 0.013)),
    "cornell_light": dict(eye=(0.13, 0.87, 0.52), look_at=(0.07, -1.0, 0.49),
                          up=(0.0, 0.0, 1.0)),
}


def _random_cameras(n, seed=20):
    """n seeded cameras as (CameraSpec fields, fovy, aspect): eye and
    look-at across the cathedral's box (0..30, 0..20, 0..10) and beyond,
    ``up`` along each axis, negated or skewed, the near/far pairs
    0.01/10, 0.1/100 and 1/1000, fovy 30-90 and aspects 1, 4/3 and 16/9;
    every 16th view looks within 1e-3 rad of ``up`` or of its negation,
    and every 16th other has its eye at the origin (each translation a
    sum of signed zeros)."""
    rng = np.random.default_rng(seed)
    ups = [(0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0),
           (0.0, 0.0, -1.0), (0.02, 1.0, 0.013), (0.3, -0.2, 0.9)]
    clips = [(0.01, 10.0), (0.1, 100.0), (1.0, 1000.0)]
    out = []
    for i in range(n):
        eye = rng.uniform((-15, -10, -5), (45, 30, 15)) * (i % 16 != 8)
        up = np.asarray(ups[i % len(ups)])
        if i % 16 == 0:
            # Near-degenerate: the view direction is up (or -up) tilted by
            # an angle of 1e-6 to 1e-3 rad, for each up in turn.
            up = np.asarray(ups[i // 16 % len(ups)])
            u = up / np.linalg.norm(up)
            side = np.cross(u, rng.normal(size=3))
            side /= np.linalg.norm(side)
            angle = 10 ** rng.uniform(-6, -3)
            d = np.cos(angle) * u + np.sin(angle) * side
            look = eye + rng.choice((-1.0, 1.0)) * rng.uniform(1, 20) * d
        else:
            look = rng.uniform((-15, -10, -5), (45, 30, 15))
        near, far = clips[i % len(clips)]
        spec = dict(eye=tuple(map(float, eye)),
                    look_at=tuple(map(float, look)),
                    up=tuple(map(float, up)), near=near, far=far)
        out.append((spec, float(rng.uniform(30, 90)),
                    (1.0, 4 / 3, 16 / 9)[(i // 3) % 3]))
    return out


def _assert_bits_equal(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _chip_smoke_imports():
    """Every import statement of chip_smoke.py, as source lines."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    return sorted({ast.unparse(node) for node in ast.walk(tree)
                   if isinstance(node, (ast.Import, ast.ImportFrom))
                   and not (isinstance(node, ast.ImportFrom)
                            and node.module == "__future__")})


def test_port_imports_nothing_of_ugrt():
    imports = _chip_smoke_imports()
    assert any("ugrt_torch" in line for line in imports)
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "sys.modules['ugrt'] = None   # any import of ugrt now fails",
        "import ugrt_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    ugrt_torch.__path__, 'ugrt_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert {'ugrt_torch.dist.mesh', 'ugrt_torch.scene.native',",
        "        'ugrt_torch.core.program', 'ugrt_torch.kernels.uniform_dda',",
        "        'ugrt_torch.micro.dda_edge', 'ugrt_torch.bench',",
        "        'ugrt_torch.micro._timing',",
        "        'ugrt_torch.micro.bench_reflective',",
        "        'ugrt_torch.micro.parse_trace', 'ugrt_torch.micro.capture_trace',",
        "        'ugrt_torch.micro.profile_chain', 'ugrt_torch.micro.render_samples',",
        "        'ugrt_torch.micro.trace_psum_overlap',",
        "        'ugrt_torch.kernels.segment_sum',",
        "        'ugrt_torch.micro.gather_bwd',",
        "        'ugrt_torch.micro.profile_crash'} <= set(names)",
        *imports,
        "assert not [m for m in sys.modules if m.startswith('ugrt.')]",
        "print(len(names))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def _write_obj(path):
    """A small OBJ with a material library, quads, relative indices,
    normals and texture coordinates."""
    (path.parent / "m.mtl").write_text(
        "newmtl red\nKa 0.3 0.05 0.05\nKd 0.8 0.1 0.1\nNs 10\n"
        "newmtl grey\nKa 0.2 0.2 0.2\nKd 0.5 0.5 0.5\nd 0.5\n")
    path.write_text(
        "mtllib m.mtl\n# a comment\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1.25\n"
        "vn 0 0 1\nvt 0.5 0.5\n"
        "usemtl red\nf 1/1/1 2/1/1 3/1/1 4/1/1\n"
        "usemtl grey\nf -5//1 -4//1 -1//1\nf 3 4 5\n")


@pytest.mark.parametrize("what", [
    "RenderConfig", "QuirkConfig", "pair_capacity", "camcoords",
    "cathedral", "cornell_box", "single_triangle", "obj_parser",
    "load_scene", "bridge", "aabb", "write_obj", "write_material_file",
    "rotate_subrange", "read_ppm", "camcoords_random", "look_at_matrix",
    "frustum_planes", "frustum_corners"])
def test_copies_equal_ugrt(what, tmp_path):
    if what == "RenderConfig":
        a, b = config_j.RenderConfig(), config_t.RenderConfig()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert ([f.name for f in dataclasses.fields(a)]
                == [f.name for f in dataclasses.fields(b)])
        for prop in ("image_size", "num_cells", "cell_sentinel"):
            assert getattr(a, prop) == getattr(b, prop)
    elif what == "QuirkConfig":
        assert (dataclasses.asdict(config_j.QuirkConfig())
                == dataclasses.asdict(config_t.QuirkConfig()))
    elif what == "pair_capacity":
        for kw in ({}, dict(pair_capacity_factor=3, tri_batch=64)):
            a = dataclasses.replace(config_j.RenderConfig(), **kw)
            b = dataclasses.replace(config_t.RenderConfig(), **kw)
            for n in (0, 1, 100, 2047, 2048, 2049, 73824, 10**6):
                assert a.pair_capacity(n) == b.pair_capacity(n)
    elif what == "camcoords":
        for spec in CAMERAS.values():
            for aspect in (1.0, 16 / 9):
                a = cam_j.camcoords_from_spec(cam_j.CameraSpec(**spec),
                                              45.0, aspect)
                b = cam_t.camcoords_from_spec(cam_t.CameraSpec(**spec),
                                              45.0, aspect)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a.view(np.int32),
                                              b.view(np.int32))
    elif what == "camcoords_random":
        for spec, fovy, aspect in _random_cameras(1024):
            _assert_bits_equal(
                cam_j.camcoords_from_spec(cam_j.CameraSpec(**spec), fovy,
                                          aspect),
                cam_t.camcoords_from_spec(cam_t.CameraSpec(**spec), fovy,
                                          aspect))
    elif what in ("look_at_matrix", "frustum_planes", "frustum_corners"):
        # Each stage of the camera on ugrt's own input to it, so that a
        # mismatch names its stage.
        for spec, fovy, aspect in _random_cameras(1024, seed=21):
            mv = cam_j.look_at_matrix(spec["eye"], spec["look_at"],
                                      spec["up"])
            if what == "look_at_matrix":
                _assert_bits_equal(mv, cam_t.look_at_matrix(
                    spec["eye"], spec["look_at"], spec["up"]))
                continue
            mvp = cam_j.mvp_matrix(mv, cam_j.perspective_matrix(
                fovy, aspect, spec["near"], spec["far"]))
            planes = cam_j.frustum_planes(mvp)
            if what == "frustum_planes":
                _assert_bits_equal(planes, cam_t.frustum_planes(mvp))
                continue
            _assert_bits_equal(cam_j.frustum_corners(planes),
                               cam_t.frustum_corners(planes))
    elif what in ("cathedral", "cornell_box", "single_triangle"):
        kw = {"cathedral": dict(num_faces_target=2000, seed=0),
              "cornell_box": dict(subdiv=2),
              "single_triangle": dict(z=-2.5)}[what]
        a, b = getattr(proc_j, what)(**kw), getattr(proc_t, what)(**kw)
        for f in ("vertices", "faces", "mat_index", "materials"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    elif what == "obj_parser":
        _write_obj(tmp_path / "s.obj")
        a = obj_j.parse_obj(str(tmp_path / "s.obj"))
        b = obj_t.parse_obj(str(tmp_path / "s.obj"))
        for f in ("vertices", "normals", "texcoords"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert [dataclasses.asdict(x) for x in a.faces] == [
            dataclasses.asdict(x) for x in b.faces]
        assert [dataclasses.asdict(x) for x in a.materials] == [
            dataclasses.asdict(x) for x in b.materials]
    elif what == "load_scene":
        _write_obj(tmp_path / "s.obj")
        model_j.write_material_file(str(tmp_path / "mat.txt"),
                                    np.asarray([[0.1, 0.2, 0.3, 0.4, 0.5,
                                                 0.6]], np.float32))
        for mat in (None, str(tmp_path / "mat.txt")):
            a = model_j.load_scene(str(tmp_path / "s.obj"), mat,
                                   prefer_native=False)
            b = model_t.load_scene(str(tmp_path / "s.obj"), mat)
            for f in ("vertices", "faces", "mat_index", "materials"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    elif what == "aabb":
        sc = proc_j.cathedral(num_faces_target=2000, seed=1)
        for x, y in zip(sc.aabb, bridge.scene(sc).aabb):
            np.testing.assert_array_equal(x, y)
        assert (sc.aabb[0] < sc.aabb[1]).all()
    elif what in ("write_obj", "write_material_file"):
        sc = proc_j.cathedral(num_faces_target=500, seed=2)
        for mod, name in ((model_j, "j"), (model_t, "t")):
            (tmp_path / name).mkdir()
            if what == "write_obj":
                mod.write_obj(str(tmp_path / name / "s.obj"), sc)
            else:
                mod.write_material_file(str(tmp_path / name / "s.obj"),
                                        sc.materials)
        for f in ("s.obj", "s.obj.mtl")[:2 if what == "write_obj" else 1]:
            assert ((tmp_path / "j" / f).read_bytes()
                    == (tmp_path / "t" / f).read_bytes())
        if what == "write_obj":       # and it round-trips through the port
            back = model_t.load_scene(str(tmp_path / "t" / "s.obj"),
                                      prefer_native=False)
            for f in ("vertices", "faces", "mat_index", "materials"):
                np.testing.assert_array_equal(getattr(back, f),
                                              getattr(sc, f))
    elif what == "rotate_subrange":
        import torch
        rng = np.random.default_rng(4)
        verts = rng.uniform(0, 25, (40, 3)).astype(np.float32)
        sub = rng.uniform(0, 25, (11, 3)).astype(np.float32)
        for rot in (0.0, 0.3, -2.7):
            want = model_j.rotate_subrange(verts, sub, 7, rot)
            got = model_t.rotate_subrange(verts, sub, 7, rot)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            tv = torch.from_numpy(verts.copy())
            got_t = model_t.rotate_subrange(tv, torch.from_numpy(sub), 7,
                                            rot)
            assert got_t is not tv and torch.equal(tv, torch.from_numpy(
                verts))
            np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                          want.view(np.int32))
    elif what == "read_ppm":
        from ugrt.api import io as io_j
        from ugrt_torch.api import io as io_t
        img = np.random.default_rng(6).integers(0, 256, (9, 13, 3)).astype(
            np.uint8)
        io_j.write_ppm(str(tmp_path / "a.ppm"), img, flip=True)
        io_t.write_ppm(str(tmp_path / "b.ppm"), img, flip=True)
        assert ((tmp_path / "a.ppm").read_bytes()
                == (tmp_path / "b.ppm").read_bytes())
        for path in ("a.ppm", "b.ppm"):
            back = io_t.read_ppm(str(tmp_path / path))
            np.testing.assert_array_equal(back, img[::-1])
            np.testing.assert_array_equal(
                back, io_j.read_ppm(str(tmp_path / path)))
    else:
        cfg = dataclasses.replace(
            config_j.RenderConfig(), screen_width=64, grid_x=8,
            quirks=config_j.QuirkConfig(abs_t=False))
        assert (dataclasses.asdict(bridge.render_config(cfg))
                == dataclasses.asdict(cfg))
        assert isinstance(bridge.render_config(cfg), config_t.RenderConfig)
        spec = cam_j.CameraSpec(**CAMERAS["bench"], near=0.5)
        assert bridge.camera_spec(spec) == cam_t.CameraSpec(
            **CAMERAS["bench"], near=0.5)
        sc = bridge.scene(proc_j.cornell_box())
        assert isinstance(sc, model_t.Scene)
        np.testing.assert_array_equal(sc.faces, proc_t.cornell_box().faces)
