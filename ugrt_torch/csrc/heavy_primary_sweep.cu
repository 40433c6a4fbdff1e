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
// after the arithmetic); the face body this kernel shares with the S3
// probes (heavy_window in sweep.cuh) spends ~31: face-major float4
// staging, two rays per thread, footprint ballots first, the t-free
// rejections under a warp vote, and the division only where a ray could
// still win.  Survivors see the operations of _heavy_common on the same
// values, so the result is bitwise equal to heavy_primary_sweep_plain.
// The live window count comes from the device-side heavy_count, so the
// launch needs no host sync.

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kBlocks = 2;         // 128-ray blocks per CUDA block

// A block of 128 threads takes two ray blocks and walks the live windows
// (heavy_walk in sweep.cuh).
template <bool kStats>
__global__ void __launch_bounds__(kBlocks * kHeavyTile)
heavy_primary_sweep_kernel(const float* __restrict__ table, int nwh,
                           const int* __restrict__ heavy_count,
                           const float* __restrict__ rays, int nb, float eps,
                           int abs_t, float* __restrict__ t_out,
                           int* __restrict__ f_out,
                           unsigned long long* __restrict__ stats) {
  heavy_walk<kBlocks, kStats>(table, nwh, heavy_count, rays, nb, eps, abs_t,
                              t_out, f_out, stats);
}

template <bool kStats>
int launch(const void* table, int nwh, const void* heavy_count,
           const void* rays, int nb, float eps, int abs_t, void* t_out,
           void* f_out, void* stats, cudaStream_t stream) {
  const int grid = (nb + kBlocks - 1) / kBlocks;
  heavy_primary_sweep_kernel<kStats>
      <<<grid, kBlocks * kHeavyTile, 0, stream>>>(
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
// device.  With `stats` (int64 [4], zeroed) non-null it also counts the
// (ray, face) tests whose warp skipped the face at the footprint, at the
// t-free vote and at the could-win vote, and those that divided.
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
