"""Build the CUDA kernels from ``ugrt_torch/csrc`` at first use.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes.  Each entry point takes device
pointers, sizes and the CUDA stream as plain integers and returns the
``cudaError_t`` of its launch.  The library lands in
``ugrt_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited kernel rebuilds and an unchanged one loads at once.
Importing this module needs no nvcc: the build runs on the first CUDA
launch.

The flags pin the numerics the plain PyTorch versions reproduce: no FMA
contraction (``-fmad=false``), IEEE division and square root, and
denormals kept.  A kernel that needs more than 48 KB of shared memory
opts in with ``cudaFuncSetAttribute`` in its C launcher; a refused
launch comes back as the entry point's error and ``launch`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every entry point; the stream is always the last argument.
SIGNATURES = {
    "ugrt_primary_sweep": (_P, _I, _P, _I, _P, _P, _P, _I, _F, _I, _P, _P,
                           _P),
    "ugrt_heavy_primary_sweep": (_P, _I, _P, _P, _I, _F, _I, _P, _P, _P, _P),
    "ugrt_shadow_sweep": (_P, _I, _I, _P, _I, _P, _P, _P, _I, _F, _F, _I,
                          _I, _P, _P, _P),
    # The probes S1-S3 (ugrt_torch/micro).
    "ugrt_heavy_sweep_v1": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P, _P),
    "ugrt_heavy_sweep_v2": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P),
    "ugrt_heavy_sweep_v3": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P, _P),
    "ugrt_coeff_mt_fma": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P),
    "ugrt_coeff_mt_mma": (_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P),
    "ugrt_tile_sweep": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libugrt_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of ugrt_torch are built at their first launch")
    return path


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    in nvcc).  A failed compile raises with nvcc's output."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    logs = [o.with_suffix(".log") for o in objs]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(srcs, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    text = "".join(f"== {s.name}\n{log.read_text()}"
                   for s, log in zip(srcs, logs))
    tmp = out.with_name(f"{tag}.tmp.so")
    if not any(codes):
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(o) for o in objs)], capture_output=True, text=True)
        codes.append(link.returncode)
        text += link.stdout + link.stderr
    seconds = time.perf_counter() - t0
    for path in (*objs, *logs):
        path.unlink(missing_ok=True)
    if any(codes):
        raise RuntimeError(f"nvcc failed (exit codes {codes}):\n{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ugrt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ugrt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the current CUDA stream; tensors pass
    as their data pointers.  Raises if the launch reports an error."""
    lib = library()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    err = getattr(lib, name)(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ugrt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    whose shape matches ``shape`` (None entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
