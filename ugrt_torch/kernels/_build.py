"""Build the CUDA kernels from ``ugrt_torch/csrc`` at first use.

The sources make two libraries, each with a plain C interface loaded
with ctypes: ``kernels``, the sweeps K1-K3 of the frame, step and
training paths, the reflection DDA D1, the step's segment sums G1 and
the shadow pass's ray and triangle sides B1 and B2, and ``probes``, the
probes S1-S3 that only ``ugrt_torch.micro`` launches, so a renderer's
first frame waits for nvcc on the main paths' kernels alone.  Each
``.cu`` file of a library compiles with its own nvcc process, all
started together, and the objects link into one shared library;
``cuda_error.cu`` (``ugrt_cuda_error_string``) goes into both.  Each
entry point takes device pointers, sizes and the CUDA stream as plain
integers and returns the ``cudaError_t`` of its launch.  A library lands
in ``ugrt_torch/_build/`` under a name keyed by a hash of the flags, its
own sources and the local headers they include, so an edited kernel
rebuilds its library and an unchanged one loads at once.  Importing this
module needs no nvcc: a library is built at the first CUDA launch of one
of its entry points.

The flags pin the numerics the plain PyTorch versions reproduce: no FMA
contraction (``-fmad=false``), IEEE division and square root, and
denormals kept.  A kernel that needs more than 48 KB of shared memory
opts in with ``cudaFuncSetAttribute`` in its C launcher; a refused
launch comes back as the entry point's error and ``launch`` raises.

Every hand kernel's Python wrapper is a ``Kernel`` (the ``kernel``
decorator), which holds the wrapper's plain PyTorch version and routes
each call by the device of its tensors: CPU tensors to the plain
version, CUDA tensors to the wrapper's CUDA body.  ``Kernel.launches``
counts the calls whose body launched; every Kernel is in ``KERNELS``,
from which ``core.program`` credits a graph replay with the launches
its capture recorded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ugrt_torch.api import profiler

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)

# Library -> its .cu sources (each also links COMMON).
LIBRARIES = {
    "kernels": ("primary_sweep.cu", "heavy_primary_sweep.cu",
                "shadow_sweep.cu", "uniform_dda.cu", "segment_sum.cu",
                "shadow_bin.cu", "shadow_tris.cu"),
    "probes": ("coeff_mt.cu", "tile_pipeline.cu", "heavy_variants.cu"),
}
COMMON = ("cuda_error.cu",)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# argtypes of every entry point, by library; the stream is always the
# last argument.
SIGNATURES = {
    "kernels": {
        "ugrt_primary_sweep": (_P, _I, _P, _I, _P, _P, _P, _I, _F, _I, _P,
                               _P, _P),
        "ugrt_heavy_primary_sweep": (_P, _I, _P, _P, _I, _F, _I, _P, _P, _P,
                                     _P),
        "ugrt_shadow_sweep": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _F,
                              _F, _I, _I, _I, _P, _P, _I, _P, _P),
        "ugrt_uniform_dda": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P,
                             _P, _P, _P, _P),
        "ugrt_segment_sum": (_P, _P, _L, _I, _I, _P, _P, _I, _P),
        "ugrt_face_corner_sum": (_P, _P, _P, _L, _I, _I, _P, _P, _I, _P),
        "ugrt_shadow_rays": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _F,
                             _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P),
        "ugrt_shadow_unpermute": (_P, _P, _I, _P, _P),
        "ugrt_shadow_window": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P),
        "ugrt_shadow_tris": (_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                             _P, _P, _P),
    },
    "probes": {
        "ugrt_heavy_sweep_v1": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P,
                                _P),
        "ugrt_heavy_sweep_v2": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P),
        "ugrt_heavy_sweep_v3": (_P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P,
                                _P),
        "ugrt_coeff_mt_fma": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P),
        "ugrt_coeff_mt_mma": (_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P),
        "ugrt_tile_sweep": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P),
    },
}
_LIBRARY_OF = {name: lib for lib, sigs in SIGNATURES.items()
               for name in sigs}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(lib: str) -> list[Path]:
    """The .cu files of library ``lib``."""
    return [CSRC_DIR / name for name in (*LIBRARIES[lib], *COMMON)]


def headers(srcs) -> list[Path]:
    """The local headers that ``srcs`` include, directly or through
    another header, sorted."""
    seen, todo = set(), list(srcs)
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC_DIR / name
            if path.exists() and path not in seen:
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def library_path(lib: str = "kernels") -> Path:
    """Where library ``lib`` for its current sources and flags lives."""
    srcs = sources(lib)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*srcs, *headers(srcs)):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libugrt_{lib}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of ugrt_torch are built at their first launch")
    return path


def build(lib: str = "kernels") -> tuple[Path, float]:
    """Compile library ``lib`` unless it exists; returns (path, seconds
    spent in nvcc).  A failed compile raises with nvcc's output."""
    out = library_path(lib)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sources(lib)
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
        raise RuntimeError(f"nvcc failed for {lib} (exit codes {codes}):\n"
                           f"{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library(lib: str = "kernels") -> ctypes.CDLL:
    """Library ``lib`` loaded (built first if needed)."""
    dll = ctypes.CDLL(str(build(lib)[0]))
    for name, argtypes in SIGNATURES[lib].items():
        fn = getattr(dll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    dll.ugrt_cuda_error_string.argtypes = [ctypes.c_int]
    dll.ugrt_cuda_error_string.restype = ctypes.c_char_p
    return dll


# Entry point calls made by ``launch`` in this process.
_launched = 0


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the card that holds its first tensor
    argument, on that card's current stream; tensors pass as their data
    pointers.  Raises if the launch reports an error."""
    global _launched
    _launched += 1
    dll = library(_LIBRARY_OF[name])
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(device):
        err = getattr(dll, name)(
            *cargs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = dll.ugrt_cuda_error_string(err).decode()
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


# Every Kernel, by wrapper name.
KERNELS: dict = {}


class Kernel:
    """A hand kernel's wrapper (made by ``kernel``).  A call runs
    ``check``, which raises on bad arguments and returns the device of
    the call's tensors; CPU tensors then take ``plain``, CUDA tensors
    the CUDA ``body``, and any other device raises ``ValueError``.
    ``body`` and ``plain`` take the wrapper's arguments.

    ``launches`` counts the calls whose body issued at least one
    ``launch`` (while the recorder is on, also the counter
    ``kernel.<name>`` of ``api.profiler``).  A graph replay runs no
    wrapper: ``core.program`` credits each Kernel of ``KERNELS`` with
    what its capture counted."""

    def __init__(self, body, plain, check):
        functools.update_wrapper(self, body)
        self.body, self.plain, self.check = body, plain, check
        self.launches = 0
        self._counter = f"kernel.{body.__name__}"
        KERNELS[body.__name__] = self

    def __call__(self, *args, **kwargs):
        device = self.check(*args, **kwargs)
        if device.type == "cpu":
            return self.plain(*args, **kwargs)
        if device.type != "cuda":
            raise ValueError(f"{self.__name__}: unsupported device {device}")
        before = _launched
        out = self.body(*args, **kwargs)
        if _launched != before:
            self.launches += 1
            profiler.count(self._counter)
        return out


def kernel(plain, check):
    """Decorate a CUDA body as a ``Kernel`` with plain version ``plain``
    and argument check ``check``."""
    return lambda body: Kernel(body, plain, check)


def choose_sweep(kernel, backend, device):
    """The function a trace calls for ``backend`` (ugrt's ``backend=`` of
    trace_primary / trace_shadow) on tensors of ``device``: None, the
    Kernel ``kernel``; "kernel", the Kernel, on CUDA tensors only;
    "plain", its plain version, on any device."""
    if backend is None:
        return kernel
    if backend == "kernel":
        if device.type != "cuda":
            raise ValueError(f"backend='kernel' launches the CUDA kernel: "
                             f"it needs CUDA tensors, not {device}")
        return kernel
    if backend == "plain":
        return kernel.plain
    raise ValueError(f"unknown trace backend {backend!r} (None, 'kernel' "
                     "or 'plain')")
