// Shared pieces of the three sweep kernels (K1 primary_sweep.cu,
// K2 heavy_primary_sweep.cu, K3 shadow_sweep.cu) and of K2's probes
// (heavy_variants.cu).
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

// One ray against one heavy face of the comp-major heavy table, for K2's
// loop-layout probes (heavy_variants.cu): comp(c) returns the face's
// component c.  Folds an accepted hit into the ray's running lex-min
// (best_t, best_f) with K2's body (heavy_primary_sweep.cu), in the op
// order of _heavy_common (ugrt/trace/pallas_tracer.py:605-635): det = d.a,
// up = d.b, vp = d.c; accept ud = up*det and vd = vp*det in [0, det^2]
// with ud + vd <= det^2; t = k * (1/det); the ray's cell (gx, gy) must
// lie in the face's footprint.  Callers pass a lambda that indexes their
// __shared__ array by name: through a plain float pointer the loads lose
// their shared address space.  K2 keeps its own copy of the body: built
// on this helper it measured 11% slower through a pointer and 1.8%
// through a lambda (2.27 / 2.08 vs 2.04 ms at the flagship inputs, H100
// at 700 W).
template <typename Comp>
__device__ __forceinline__ void heavy_fold(Comp comp, float dx, float dy,
                                           float dz, float gx, float gy,
                                           float eps, int abs_t,
                                           float& best_t, int& best_f) {
  const float det = dx * comp(0) + dy * comp(1) + dz * comp(2);
  const float up = dx * comp(3) + dy * comp(4) + dz * comp(5);
  const float vp = dx * comp(6) + dy * comp(7) + dz * comp(8);
  const float det2 = det * det;
  const float ud = up * det;
  const float vd = vp * det;
  const float inv = 1.0f / det;
  float t = comp(9) * inv;
  const bool in_fp = (gx >= comp(10)) & (gx <= comp(11)) &
                     (gy >= comp(12)) & (gy <= comp(13));
  if (abs_t) t = fabsf(t);
  const bool reject = (fabsf(det) < eps) | (ud < 0.0f) | (ud > det2) |
                      (vd < 0.0f) | (ud + vd > det2) | !in_fp | (t <= 0.0f);
  const int face = static_cast<int>(comp(14));
  if (!reject && t < kBig && (t < best_t || (t == best_t && face < best_f))) {
    best_t = t;
    best_f = face;
  }
}

}  // namespace ugrt
