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
// What bounds it on the H100: instruction issue.  The table is small
// (NWH x 8 KB) and every ray meets every live face, so the work is the
// (ray, face) tests, ~21 flops each; without FMA contraction
// (sweep.cuh) a multiply and an add are separate instructions, and under
// 1% of tests can be accepted.  A direct body spends ~64 instructions per
// test (15 scalar shared loads, an IEEE division, the footprint compares
// after the arithmetic); this design spends ~31:
// - each window is staged face-major, 16 floats per face, so a face
//   arrives as four 128-bit broadcasts, and each thread takes two rays
//   of one 64-ray tile, so a load serves two tests;
// - the footprint is tested first, and a warp skips a face that none of
//   its rays' cells lies in: on the frame path a tile's 64 rays share
//   one cell, and one ballot per 32 faces finds the faces whose
//   footprint holds it; otherwise a warp-uniform vote per face decides;
// - the rejections that need no t (|det| < eps, ud and vd out of
//   [0, det^2], the footprint) come next, and a warp takes the division,
//   t and the fold only when one of its rays survives them.
// Survivors see the operations of _heavy_common on the same values, so
// the result is bitwise equal to heavy_primary_sweep_plain.  The live
// window count comes from the device-side heavy_count, so the launch
// needs no host sync.

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kWin = 128;
constexpr int kBlocks = 2;         // 128-ray blocks per CUDA block

// Fold ray candidate (pre: it survived every test that needs no t) into
// the ray's running lex-min, in the op order of _heavy_common.
__device__ __forceinline__ void fold(bool pre, float det, float k, int abs_t,
                                     int face, float& best_t, int& best_f) {
  const float inv = 1.0f / det;
  float t = k * inv;
  if (abs_t) t = fabsf(t);
  if (pre && !(t <= 0.0f) && t < kBig &&
      (t < best_t || (t == best_t && face < best_f))) {
    best_t = t;
    best_f = face;
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kRays)
heavy_primary_sweep_kernel(const float* __restrict__ table, int nwh,
                           const int* __restrict__ heavy_count,
                           const float* __restrict__ rays, int nb, float eps,
                           int abs_t, float* __restrict__ t_out,
                           int* __restrict__ f_out,
                           unsigned long long* __restrict__ stats) {
  // Face q of the staged window: {a0 a1 a2 b0} {b1 b2 c0 c1} {c2 k x0 x1}
  // {y0 y1 face -}.
  __shared__ float4 s[kWin][4];
  const size_t ncol = static_cast<size_t>(nwh) * kWin;
  // Warp w takes tile w of the four 64-ray tiles of ray blocks
  // kBlocks * blockIdx.x and the next; lane l its rays l and l + 32.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ray0 =
      static_cast<size_t>(blockIdx.x) * kBlocks * kRays + warp * 64 + lane;
  const size_t ray1 = ray0 + 32;
  // Warp-uniform: the last block's second ray block may not exist.
  const bool live = ray0 < static_cast<size_t>(nb) * kRays;
  const float4 r0 = live ? *reinterpret_cast<const float4*>(rays + ray0 * 8)
                         : float4{};
  const float4 r1 = live ? *reinterpret_cast<const float4*>(rays + ray1 * 8)
                         : float4{};
  const float2 g0 = live ? *reinterpret_cast<const float2*>(rays + ray0 * 8 + 4)
                         : float2{};
  const float2 g1 = live ? *reinterpret_cast<const float2*>(rays + ray1 * 8 + 4)
                         : float2{};
  const float dx0 = r0.x, dy0 = r0.y, dz0 = r0.z, gx0 = g0.x, gy0 = g0.y;
  const float dx1 = r1.x, dy1 = r1.y, dz1 = r1.z, gx1 = g1.x, gy1 = g1.y;
  unsigned long long n_fp = 0, n_pre = 0, n_div = 0;   // warp-rows, kStats
  // On the frame path a tile's 64 rays share one grid cell (gx, gy).
  const bool one_cell =
      __all_sync(kFull, (gx0 == gx1) & (gy0 == gy1) &
                            (gx0 == __shfl_sync(kFull, gx0, 0)) &
                            (gy0 == __shfl_sync(kFull, gy0, 0)));

  const int n_live = min(max((heavy_count[0] + kWin - 1) / kWin, 0), nwh);
  float bt0 = kBig, bt1 = kBig;
  int bf0 = kMaxI, bf1 = kMaxI;
  for (int w = 0; w < n_live; ++w) {
    __syncthreads();
    {
      // Thread q stages face q: 15 loads coalesced across threads.
      const float* col = table + static_cast<size_t>(w) * kWin + threadIdx.x;
      float v[15];
#pragma unroll
      for (int comp = 0; comp < 15; ++comp) v[comp] = col[comp * ncol];
      s[threadIdx.x][0] = make_float4(v[0], v[1], v[2], v[3]);
      s[threadIdx.x][1] = make_float4(v[4], v[5], v[6], v[7]);
      s[threadIdx.x][2] = make_float4(v[8], v[9], v[10], v[11]);
      s[threadIdx.x][3] = make_float4(v[12], v[13], v[14], 0.0f);
    }
    __syncthreads();
    if (!live) continue;
    // Face q against the thread's two rays, of which fp0 / fp1 lie in its
    // footprint; skipped by the warp where no ray survives the tests that
    // need no t.
    auto run_face = [&](int q, bool fp0, bool fp1) {
      const float4 A = s[q][0], B = s[q][1], C = s[q][2];
      const float det0 = dx0 * A.x + dy0 * A.y + dz0 * A.z;
      const float up0 = dx0 * A.w + dy0 * B.x + dz0 * B.y;
      const float vp0 = dx0 * B.z + dy0 * B.w + dz0 * C.x;
      const float det20 = det0 * det0;
      const float ud0 = up0 * det0;
      const float vd0 = vp0 * det0;
      const bool pre0 = fp0 & !((fabsf(det0) < eps) | (ud0 < 0.0f) |
                                (ud0 > det20) | (vd0 < 0.0f) |
                                (ud0 + vd0 > det20));
      const float det1 = dx1 * A.x + dy1 * A.y + dz1 * A.z;
      const float up1 = dx1 * A.w + dy1 * B.x + dz1 * B.y;
      const float vp1 = dx1 * B.z + dy1 * B.w + dz1 * C.x;
      const float det21 = det1 * det1;
      const float ud1 = up1 * det1;
      const float vd1 = vp1 * det1;
      const bool pre1 = fp1 & !((fabsf(det1) < eps) | (ud1 < 0.0f) |
                                (ud1 > det21) | (vd1 < 0.0f) |
                                (ud1 + vd1 > det21));
      if (!__any_sync(kFull, pre0 | pre1)) {
        if (kStats) ++n_pre;
        return;
      }
      if (kStats) ++n_div;
      const int face = static_cast<int>(s[q][3].z);
      fold(pre0, det0, C.y, abs_t, face, bt0, bf0);
      fold(pre1, det1, C.y, abs_t, face, bt1, bf1);
    };
    if (one_cell) {
      // The warp's 64 rays share one cell: lane l checks faces l, l + 32,
      // ..., one ballot per 32 faces, and the warp runs the faces whose
      // footprint holds the cell in ascending order.
      for (int j = 0; j < kWin; j += 32) {
        const float4 C = s[j + lane][2], D = s[j + lane][3];
        unsigned faces = __ballot_sync(kFull, (gx0 >= C.z) & (gx0 <= C.w) &
                                                  (gy0 >= D.x) & (gy0 <= D.y));
        if (kStats) n_fp += 32 - __popc(faces);
        while (faces) {
          const int q = j + __ffs(faces) - 1;
          faces &= faces - 1;
          run_face(q, true, true);
        }
      }
      continue;
    }
    for (int q = 0; q < kWin; ++q) {
      const float4 C = s[q][2], D = s[q][3];
      const bool fp0 = (gx0 >= C.z) & (gx0 <= C.w) & (gy0 >= D.x) &
                       (gy0 <= D.y);
      const bool fp1 = (gx1 >= C.z) & (gx1 <= C.w) & (gy1 >= D.x) &
                       (gy1 <= D.y);
      if (!__any_sync(kFull, fp0 | fp1)) {
        if (kStats) ++n_fp;
        continue;
      }
      run_face(q, fp0, fp1);
    }
  }
  if (!live) return;
  t_out[ray0] = bt0;
  f_out[ray0] = bf0;
  t_out[ray1] = bt1;
  f_out[ray1] = bf1;
  if (kStats && lane == 0) {
    // In (ray, row) tests: a warp-row is 64 of them.
    atomicAdd(stats, n_fp * 64);
    atomicAdd(stats + 1, n_pre * 64);
    atomicAdd(stats + 2, n_div * 64);
  }
}

template <bool kStats>
int launch(const void* table, int nwh, const void* heavy_count,
           const void* rays, int nb, float eps, int abs_t, void* t_out,
           void* f_out, void* stats, cudaStream_t stream) {
  heavy_primary_sweep_kernel<kStats>
      <<<(nb + kBlocks - 1) / kBlocks, kRays, 0, stream>>>(
          static_cast<const float*>(table), nwh,
          static_cast<const int*>(heavy_count),
          static_cast<const float*>(rays), nb, eps, abs_t,
          static_cast<float*>(t_out), static_cast<int*>(f_out),
          static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream`: one CUDA block per two 128-ray blocks; the
// table is f32 [16, nwh * 128] and heavy_count an int32 scalar on the
// device.  With `stats` (int64 [3], zeroed) non-null it also counts the
// (ray, row) tests whose warp skipped the row at the footprint vote, at
// the vote before the division, and that took the division.
extern "C" int ugrt_heavy_primary_sweep(const void* table, int nwh,
                                        const void* heavy_count,
                                        const void* rays, int nb, float eps,
                                        int abs_t, void* t_out, void* f_out,
                                        void* stats, void* stream) {
  if (nb == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return stats ? launch<true>(table, nwh, heavy_count, rays, nb, eps, abs_t,
                              t_out, f_out, stats, s)
               : launch<false>(table, nwh, heavy_count, rays, nb, eps, abs_t,
                               t_out, f_out, stats, s);
}
