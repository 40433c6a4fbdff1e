// Shared pieces of the three sweep kernels (K1 primary_sweep.cu,
// K2 heavy_primary_sweep.cu, K3 shadow_sweep.cu) and of K2's probes
// (heavy_variants.cu).
//
// Layout contract with the Python wrappers (ugrt_torch/kernels/):
//   rays       f32 [NB, 128, 8]  ray-major rows; a CUDA block of 128
//                                threads takes a 128-ray block, one
//                                thread per ray (K2: two blocks, two rays
//                                per thread)
//   windows    f32 [NW, win, 16] triangle rows (ugrt_torch/trace/windows.py)
//   w_lo/w_hi  i32 [NB]          each ray block's inclusive window range
//   item_end   i32 [NB]          K1/K3: inclusive prefix sum of each ray
//                                block's work items, chunks of at most
//                                `chunk` windows (kernels/_plain.py,
//                                chunk_item_end)
//
// Numerics: the library is compiled with -fmad=false -ftz=false
// -prec-div=true -prec-sqrt=true (kernels/_build.py), so every product
// and sum below rounds once to f32 in the written, left-associated
// order — the order of the Pallas bodies — and the kernels are bitwise
// equal to their plain PyTorch versions.  Without contraction a multiply
// and an add are two instructions, so the card's f32 rate for this code
// is half the 67 TFLOP/s it quotes for fused multiply-adds.
#pragma once

#include <cuda_runtime.h>

namespace ugrt {

constexpr int kRays = 128;           // rays per block == threads per block
constexpr int kComp = 16;            // f32 components per triangle row
constexpr float kBig = 3.0e38f;      // "no hit" t
constexpr int kMaxI = 0x7fffffff;    // "no hit" face id
constexpr unsigned kFull = 0xffffffffu;

// Copy `n_f4` float4s of one window from global to shared memory with
// all 128 threads (16 B per thread per step, neighbouring threads on
// neighbouring addresses).  Callers fence with __syncthreads().
__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int n_f4) {
  for (int j = threadIdx.x; j < n_f4; j += kRays) dst[j] = src[j];
}

// Decode work item `item` of a chunked sweep into s_item = {ray block,
// first window, last window}; ray block -1 when `item` is past the last
// item.  The item's ray block is the first b whose inclusive item_end[b]
// exceeds `item`; its windows start at max(w_lo[b], 0) + (item -
// item_end[b - 1]) * chunk (kernels/_plain.py, chunk_windows, decodes the
// same way).  Called by all 32 lanes of one warp with the same `item`:
// each step splits the candidate blocks into 32 runs and one ballot over
// the runs' last entries picks the run, so 8192 ray blocks take three
// dependent loads.  Lane 0 writes s_item; callers fence before others
// read it.
__device__ __forceinline__ void decode_item(
    int item, const int* __restrict__ item_end, int nb,
    const int* __restrict__ w_lo, const int* __restrict__ w_hi, int nw,
    int chunk, int* s_item) {
  const int lane = threadIdx.x & 31;
  int b = -1;
  if (item < item_end[nb - 1]) {
    // The answer lies in [lo, lo + n) and item_end[lo + n - 1] > item.
    int lo = 0, n = nb;
    while (n > 1) {
      const int step = (n + 31) >> 5;
      const int last = min(lo + (lane + 1) * step, lo + n) - 1;
      const int run = __ffs(__ballot_sync(kFull, item_end[last] > item)) - 1;
      lo += run * step;
      n = min(step, n - run * step);
    }
    b = lo;
  }
  if (lane == 0) {
    if (b >= 0) {
      const int first = b > 0 ? item_end[b - 1] : 0;
      const int w0 = max(w_lo[b], 0) + (item - first) * chunk;
      s_item[1] = w0;
      s_item[2] = min(min(w_hi[b], nw - 1), w0 + chunk - 1);
    }
    s_item[0] = b;
  }
}

// The grid of a persistent sweep: as many blocks of `threads` as fit on
// every SM at once with `smem` bytes of dynamic shared memory each.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// One ray against one heavy face of the comp-major heavy table, for K2's
// loop-layout probes (heavy_variants.cu): comp(c) returns the face's
// component c.  Folds an accepted hit into the ray's running lex-min
// (best_t, best_f) in the op order of _heavy_common
// (ugrt/trace/pallas_tracer.py:605-635): det = d.a, up = d.b, vp = d.c;
// accept ud = up*det and vd = vp*det in [0, det^2] with ud + vd <= det^2;
// t = k * (1/det); the ray's cell (gx, gy) must lie in the face's
// footprint.  Callers pass a lambda that indexes their __shared__ array
// by name: through a plain float pointer the loads lose their shared
// address space.  K2 (heavy_primary_sweep.cu) has its own body, which
// reorders the tests so that warps skip work (the same values result).
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
