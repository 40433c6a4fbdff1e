// Shared pieces of the three sweep kernels (K1 primary_sweep.cu,
// K2 heavy_primary_sweep.cu, K3 shadow_sweep.cu).
//
// Layout contract with the Python wrappers (ugrt_torch/kernels/):
//   rays       f32 [NB, 128, 8]  ray-major rows, one CUDA block per
//                                128-ray block, one thread per ray
//   windows    f32 [NW, win, 16] triangle rows (ugrt_torch/trace/windows.py)
//   w_lo/w_hi  i32 [NB]          each block's inclusive window range
//
// Numerics: the library is compiled with -fmad=false -ftz=false
// -prec-div=true -prec-sqrt=true (kernels/_build.py), so every product
// and sum below rounds once to f32 in the written, left-associated
// order — the order of the Pallas bodies — and the kernels are bitwise
// equal to their plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>

namespace ugrt {

constexpr int kRays = 128;           // rays per block == threads per block
constexpr int kComp = 16;            // f32 components per triangle row
constexpr float kBig = 3.0e38f;      // "no hit" t
constexpr int kMaxI = 0x7fffffff;    // "no hit" face id

// Copy `n_f4` float4s of one window from global to shared memory with
// all 128 threads (16 B per thread per step, neighbouring threads on
// neighbouring addresses).  Callers fence with __syncthreads().
__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int n_f4) {
  for (int j = threadIdx.x; j < n_f4; j += kRays) dst[j] = src[j];
}

}  // namespace ugrt
