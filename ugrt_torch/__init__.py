"""ugrt_torch — the PyTorch/CUDA port of ugrt for one NVIDIA H100.

The package mirrors ``ugrt/``'s layout and names module for module, so a
reader finds each function's counterpart at the same path.  ``ugrt/`` (JAX
on a TPU) stays the reference that the tests hold the port against; the
port imports ``torch`` and never ``jax``, and imports nothing of ``ugrt``:
it keeps its own copies of ugrt's JAX-free host modules (``config``,
``core.host_camera``, ``scene.*``, ``api.io``).  Host objects of ugrt
cross over through ``bridge``.  To check it: ``tests/
test_torch_isolation.py`` imports every module with ``ugrt`` blocked,
and ``chip_smoke.py`` runs in a copy of the repository without ``ugrt/``.

Each TPU (Pallas) kernel is a hand-written CUDA C++ kernel under
``csrc/``, built with nvcc at its first CUDA launch
(``kernels/_build.py``).  Beside every kernel sits its plain PyTorch
version, which the wrappers run for tensors on the CPU only.
"""

__version__ = "0.1.0"
