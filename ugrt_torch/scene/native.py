"""ctypes bindings for the native host library (torch port's copy of
ugrt/scene/native.py, same API and C signatures).

The library is ``native/ugrt_native.cpp`` (a fast OBJ parser, the
custom material-file parser and a buffered P3 PPM writer), compiled
here at first use with ``native/Makefile``'s flags by ``$CXX`` (default
``g++``) into ``ugrt_torch/_build/``, under a name keyed by a hash of the
flags and the source, so an edited source rebuilds and an unchanged one
loads at once.  The checked-in ``native/libugrt_native.so`` is never
loaded: it is a binary built elsewhere.

``available()`` is False only where no C++ compiler exists; then the
``*_fast`` functions return None or False and the callers use the Python
parser and writer.  A compiler that fails, or a library that does not
load, raises: a broken build is never hidden behind the Python path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "ugrt_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
# native/Makefile's CXXFLAGS, then its -shared.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _compiler() -> list[str] | None:
    """The C++ compiler command ($CXX, else g++), or None if absent."""
    cmd = shlex.split(os.environ.get("CXX", "g++"))
    return cmd if cmd and shutil.which(cmd[0]) else None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libugrt_native-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    in the compiler).  Raises if there is no compiler or it fails."""
    out = library_path()
    if out.exists():
        return out, 0.0
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++) to build "
                           f"{SOURCE.name}")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cxx)} failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.ugrt_parse_obj.restype = ctypes.c_void_p
    lib.ugrt_parse_obj.argtypes = [ctypes.c_char_p]
    lib.ugrt_free_scene.argtypes = [ctypes.c_void_p]
    for fn in ("ugrt_num_vertices", "ugrt_num_faces", "ugrt_num_normals"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ugrt_copy_vertices.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_faces.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_mat_index.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_normals.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_parse_materials.restype = ctypes.c_int64
    lib.ugrt_parse_materials.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64]
    lib.ugrt_write_ppm.restype = ctypes.c_int
    lib.ugrt_write_ppm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    return lib


def available() -> bool:
    """True where a C++ compiler exists (the library builds at first
    use)."""
    return _compiler() is not None


def parse_obj_fast(path: str):
    """Parse an OBJ into (vertices f32 [V,3], faces i32 [F,3],
    mat_index i32 [F]) via the native parser.  None if unavailable."""
    if not available():
        return None
    lib = _load()
    h = lib.ugrt_parse_obj(path.encode())
    if not h:
        raise IOError(f"native parser failed on {path}")
    try:
        nv = lib.ugrt_num_vertices(h)
        nf = lib.ugrt_num_faces(h)
        vertices = np.empty((nv, 3), dtype=np.float32)
        faces = np.empty((nf, 3), dtype=np.int32)
        mat_index = np.empty((nf,), dtype=np.int32)
        if nv:
            lib.ugrt_copy_vertices(h, vertices.ctypes.data)
        if nf:
            lib.ugrt_copy_faces(h, faces.ctypes.data)
            lib.ugrt_copy_mat_index(h, mat_index.ctypes.data)
        return vertices, faces, mat_index
    finally:
        lib.ugrt_free_scene(h)


def parse_materials_fast(path: str):
    """Custom material file -> [M, 6] float32, or None if unavailable."""
    if not available():
        return None
    lib = _load()
    n = lib.ugrt_parse_materials(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot open {path}")
    out = np.zeros((n, 6), dtype=np.float32)
    lib.ugrt_parse_materials(path.encode(), out.ctypes.data, n)
    return out


def write_ppm_fast(path: str, image_u8, flip: bool = False) -> bool:
    """Native buffered P3 writer.  Returns False if unavailable."""
    if not available():
        return False
    lib = _load()
    img = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, _ = img.shape
    rc = lib.ugrt_write_ppm(path.encode(), img.ctypes.data, w, h,
                            1 if flip else 0)
    if rc != 0:
        raise IOError(f"native PPM write failed: {path}")
    return True
