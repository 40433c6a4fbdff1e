// K1 — primary windowed sweep.
//
// Replaces the Pallas kernel _primary_kernel + _primary_body
// (ugrt/trace/pallas_tracer.py:304-387): direct-form Möller–Trumbore of
// each ray of a 128-ray block against 128-triangle windows of the
// perspective grid's sorted pair array, admission by cell key, per ray
// the lex-min (t, face) of the admitted hits.
//
// What bounds it on the H100: per (ray, triangle) about 40 f32 flops on
// 11 row components, and every row is read by all 128 threads.  The
// design stages one 8 KB window in shared memory per step (coalesced
// float4 loads, read back as broadcasts), keeps the ray and the running
// (t, face) in registers, and reads each window once per block.  The
// TPU's sequential grid of (block, window) work items becomes a loop
// inside the block over its own window range, so there is no schedule
// array and no work capacity.
//
// Contract per ray (pallas_tracer.py:353-387): reject |det| < eps,
// u < 0, u > 1, v < 0, u + v > 1, t <= 0 (after |t| under the abs_t
// quirk) and a row key != the ray's cell key; keep the lex-min (t, face)
// of the rest.  Pallas's "min face among equal t in a window, strict <
// across ascending windows" is the same because pairs sort by (cell,
// face).  Outputs t = 3e38 and face = 2^31-1 where nothing is admitted.

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kWin = 128;

__global__ void __launch_bounds__(kRays)
primary_sweep_kernel(const float* __restrict__ tri, int nw,
                     const float* __restrict__ rays,
                     const int* __restrict__ w_lo,
                     const int* __restrict__ w_hi, float eps, int abs_t,
                     float* __restrict__ t_out, int* __restrict__ f_out) {
  __shared__ float4 s_win[kWin * kComp / 4];
  const float* s = reinterpret_cast<const float*>(s_win);
  const int b = blockIdx.x;
  const size_t ray = static_cast<size_t>(b) * kRays + threadIdx.x;
  const float* r = rays + ray * 8;
  const float dx = r[0], dy = r[1], dz = r[2], cell = r[3];

  const int lo = max(w_lo[b], 0);
  const int hi = min(w_hi[b], nw - 1);
  float best_t = kBig;
  int best_f = kMaxI;
  for (int w = lo; w <= hi; ++w) {
    __syncthreads();
    stage(s_win,
          reinterpret_cast<const float4*>(tri + static_cast<size_t>(w) *
                                                    kWin * kComp),
          kWin * kComp / 4);
    __syncthreads();
    for (int q = 0; q < kWin; ++q) {
      const float* c = s + q * kComp;
      const float tvx = c[0], tvy = c[1], tvz = c[2];
      const float e1x = c[3], e1y = c[4], e1z = c[5];
      const float e2x = c[6], e2y = c[7], e2z = c[8];
      // pvec = dir x e2 (intersectTriUV, trace_kernel.cu:4-45)
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = 1.0f / det;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      if (abs_t) t = fabsf(t);
      const bool reject = (fabsf(det) < eps) | (u < 0.0f) | (u > 1.0f) |
                          (v < 0.0f) | (u + v > 1.0f) | (t <= 0.0f) |
                          (c[9] != cell);
      const int face = static_cast<int>(c[10]);
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

// Launches K1 on `stream`: one block per 128-ray block.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ugrt_primary_sweep(const void* tri, int nw, const void* rays,
                                  int nb, const void* w_lo, const void* w_hi,
                                  float eps, int abs_t, void* t_out,
                                  void* f_out, void* stream) {
  if (nb == 0) return 0;
  primary_sweep_kernel<<<nb, ugrt::kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri), nw, static_cast<const float*>(rays),
      static_cast<const int*>(w_lo), static_cast<const int*>(w_hi), eps,
      abs_t, static_cast<float*>(t_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ugrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
