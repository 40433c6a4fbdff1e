// K2 — dense primary sweep over the heavy-face list.
//
// Replaces the Pallas kernels _heavy_primary_kernel (looped) and
// _heavy_primary_kernel_unrolled (ugrt/trace/pallas_tracer.py:641-724,
// with _heavy_common :605-635), which return the same result bitwise; a
// lax.cond picked one by the live density of the table (:799-803).  One
// kernel serves both cases here because a block's loop runs over the
// live windows only.
//
// Every ray tests every live heavy face (heavy faces are few, ~780 on
// the flagship, but each spans many cells) in coefficient form:
// det = d.a, up = d.b, vp = d.c; accept ud = up*det and vd = vp*det in
// [0, det^2] with ud + vd <= det^2; t = k * (1/det); the ray's own cell
// (gx, gy) must lie in the face's footprint.  Per ray: lex-min (t, face),
// t = 3e38 / face = 2^31-1 where nothing is admitted.  Heavy faces are
// packed ascending, so this equals Pallas's tie-break (:674-683).
//
// What bounds it on the H100: ~25 flops per (ray, face) on 15 row
// components, every ray against every live face — compute, not bytes
// (the whole table is NWH x 8 KB).  The design stages one 128-face
// window of the comp-major table in shared memory per step (each thread
// loads one face's column, coalesced across threads) and keeps the ray
// and its (t, face) in registers.  The live window count comes from the
// device-side heavy_count, so the launch needs no host sync.

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kWin = 128;

__global__ void __launch_bounds__(kRays)
heavy_primary_sweep_kernel(const float* __restrict__ table, int nwh,
                           const int* __restrict__ heavy_count,
                           const float* __restrict__ rays, float eps,
                           int abs_t, float* __restrict__ t_out,
                           int* __restrict__ f_out) {
  __shared__ float s[kComp][kWin];
  const size_t ncol = static_cast<size_t>(nwh) * kWin;
  const size_t ray = static_cast<size_t>(blockIdx.x) * kRays + threadIdx.x;
  const float* r = rays + ray * 8;
  const float dx = r[0], dy = r[1], dz = r[2], gx = r[4], gy = r[5];

  const int n_live = min(max((heavy_count[0] + kWin - 1) / kWin, 0), nwh);
  float best_t = kBig;
  int best_f = kMaxI;
  for (int w = 0; w < n_live; ++w) {
    __syncthreads();
    for (int comp = 0; comp < kComp; ++comp)
      s[comp][threadIdx.x] =
          table[comp * ncol + static_cast<size_t>(w) * kWin + threadIdx.x];
    __syncthreads();
    for (int q = 0; q < kWin; ++q) {
      const float det = dx * s[0][q] + dy * s[1][q] + dz * s[2][q];
      const float up = dx * s[3][q] + dy * s[4][q] + dz * s[5][q];
      const float vp = dx * s[6][q] + dy * s[7][q] + dz * s[8][q];
      const float det2 = det * det;
      const float ud = up * det;
      const float vd = vp * det;
      const float inv = 1.0f / det;
      float t = s[9][q] * inv;
      const bool in_fp = (gx >= s[10][q]) & (gx <= s[11][q]) &
                         (gy >= s[12][q]) & (gy <= s[13][q]);
      if (abs_t) t = fabsf(t);
      const bool reject = (fabsf(det) < eps) | (ud < 0.0f) | (ud > det2) |
                          (vd < 0.0f) | (ud + vd > det2) | !in_fp |
                          (t <= 0.0f);
      const int face = static_cast<int>(s[14][q]);
      if (!reject && t < kBig &&
          (t < best_t || (t == best_t && face < best_f))) {
        best_t = t;
        best_f = face;
      }
    }
  }
  t_out[ray] = best_t;
  f_out[ray] = best_f;
}

}  // namespace

// Launches K2 on `stream`: one block per 128-ray block; the table is
// f32 [16, nwh * 128] and heavy_count an int32 scalar on the device.
extern "C" int ugrt_heavy_primary_sweep(const void* table, int nwh,
                                        const void* heavy_count,
                                        const void* rays, int nb, float eps,
                                        int abs_t, void* t_out, void* f_out,
                                        void* stream) {
  if (nb == 0) return 0;
  heavy_primary_sweep_kernel<<<nb, ugrt::kRays, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), nwh,
      static_cast<const int*>(heavy_count), static_cast<const float*>(rays),
      eps, abs_t, static_cast<float*>(t_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}
