// The message of a cudaError_t, for the Python launcher's exceptions
// (kernels/_build.py).  Linked into both libraries: the sweeps K1-K3 and
// the probes S1-S3.

#include <cuda_runtime.h>

extern "C" const char* ugrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
