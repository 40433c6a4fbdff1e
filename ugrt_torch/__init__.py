"""ugrt_torch — the PyTorch/CUDA port of ugrt for one NVIDIA H100.

The package mirrors ``ugrt/``'s layout and names module for module, so a
reader finds each function's counterpart at the same path.  ``ugrt/`` (JAX
on a TPU) stays the reference; the port imports ``torch`` and never
``jax``.  It reuses only ugrt's JAX-free host modules: ``ugrt.config``,
``ugrt.core.camera``, ``ugrt.scene.*``, ``ugrt.api.io`` and
``ugrt.ref.oracle``.

Each TPU (Pallas) kernel on the forward frame path is a hand-written CUDA
C++ kernel under ``csrc/``, built with nvcc at its first CUDA launch
(``kernels/_build.py``).  Beside every kernel sits its plain PyTorch
version, which the wrappers run for tensors on the CPU only.
"""

__version__ = "0.1.0"
