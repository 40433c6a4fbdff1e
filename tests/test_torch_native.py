"""ugrt_torch's native host library (scene/native.py over
native/ugrt_native.cpp, built here with the C++ compiler) against the
port's Python parser and writer, as tests/test_native.py holds ugrt's,
and against ugrt's native parser on the same files.

Tolerance: none — arrays equal, PPM files byte-identical.
"""

import unittest.mock as mock

import numpy as np
import pytest

from ugrt.scene import native as native_j
from ugrt_torch.api import io
from ugrt_torch.scene import model as smodel
from ugrt_torch.scene import native
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("no C++ compiler ($CXX or g++) to build the library")
    return native._load()


def _write_obj(tmp_path):
    obj = tmp_path / "s.obj"
    obj.write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl red\nf 1 2 3\n"
        "usemtl blue\nf 1/1 2/1 3/1 4/1\n"  # quad truncates
        "f -4 -3 -2\n")
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 1 0 0\n"
                                    "newmtl blue\nKd 0 0 1\n")
    return obj


def test_native_obj_matches_python(lib, tmp_path):
    obj = _write_obj(tmp_path)
    v, f, mi = native.parse_obj_fast(str(obj))
    sc = smodel.load_scene(str(obj), prefer_native=False)
    np.testing.assert_array_equal(v, sc.vertices)
    np.testing.assert_array_equal(f, sc.faces)
    np.testing.assert_array_equal(mi, sc.mat_index)


def test_native_materials_match_python(lib, tmp_path):
    mat = tmp_path / "mats.txt"
    mat.write_text(
        "newmtl wall 1\n0.2 0.3 0.4\nKd\n0.5 0.6 0.7\n"
        "a b c d e f g h i j k\nNA\n"
        "newmtl floor 2\n0.1 0.1 0.1\nKd\n0.9 0.8 0.7\n"
        "a b c d e f g h i j k\ntex.png\n")
    m_native = native.parse_materials_fast(str(mat))
    m_python = smodel.load_material_file(str(mat))
    np.testing.assert_array_equal(m_native, m_python)


def test_native_ppm_byte_identical(lib, tmp_path):
    img = np.random.default_rng(3).integers(
        0, 256, (16, 24, 3)).astype(np.uint8)
    p_native = tmp_path / "n.ppm"
    p_python = tmp_path / "p.ppm"
    assert native.write_ppm_fast(str(p_native), img)
    with mock.patch.object(native, "available", return_value=False):
        io.write_ppm(str(p_python), img)
    assert p_native.read_bytes() == p_python.read_bytes()
    io.write_ppm(str(tmp_path / "w.ppm"), img)       # the native branch
    assert (tmp_path / "w.ppm").read_bytes() == p_python.read_bytes()

    flipped = tmp_path / "f.ppm"
    native.write_ppm_fast(str(flipped), img, flip=True)
    np.testing.assert_array_equal(io.read_ppm(str(flipped)), img[::-1])


def test_load_scene_native_path(lib, tmp_path):
    obj = tmp_path / "s.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\n")
    mat = tmp_path / "m.txt"
    mat.write_text("newmtl a 1\n0.1 0.2 0.3\nKd\n0.4 0.5 0.6\n"
                   "a b c d e f g h i j k\nNA\n")
    calls = []
    parse = native.parse_obj_fast
    with mock.patch.object(native, "parse_obj_fast",
                           lambda p: calls.append(p) or parse(p)):
        sc_native = smodel.load_scene(str(obj), str(mat), prefer_native=True)
        sc_python = smodel.load_scene(str(obj), str(mat),
                                      prefer_native=False)
    assert calls == [str(obj)]
    for f in ("vertices", "faces", "mat_index", "materials"):
        np.testing.assert_array_equal(getattr(sc_native, f),
                                      getattr(sc_python, f))


def test_native_matches_ugrt_native(lib, tmp_path):
    """The port's library and ugrt's parse the same OBJ (write_obj of the
    Cornell box, materials by usemtl) into equal arrays."""
    if not native_j.available():
        pytest.skip("ugrt's native library is not built")
    from ugrt_torch.scene import procedural

    obj = str(tmp_path / "box.obj")
    smodel.write_obj(obj, procedural.cornell_box(subdiv=2))
    for got, want in zip(native.parse_obj_fast(obj),
                         native_j.parse_obj_fast(obj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_library_built_from_source(lib, tmp_path, monkeypatch):
    """The port loads its own build of native/ugrt_native.cpp from
    ugrt_torch/_build (never native/libugrt_native.so), and a source that
    does not compile raises with the compiler's output."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert lib._name == str(path)
    assert native.SOURCE.name == "ugrt_native.cpp"
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
