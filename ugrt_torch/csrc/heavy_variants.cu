// S3 — K2's function (dense heavy-face primary sweep) under three loop
// layouts, as a probe of how a block's window loop should be laid out.
//
// Replaces the Pallas probes _v1_kernel, _v2_kernel and _v3_kernel of
// scripts/micro_heavy.py:105-183 (launched at :70), which computed
// _heavy_primary_kernel's result with one window loop per grid step, the
// window as a grid axis, and a full unroll.  Every variant runs K2's face
// body (heavy_window in sweep.cuh: face-major float4 staging, two rays
// per thread, footprint ballots, the t-free vote, the could-win vote
// before the division) and returns K2's (t, face) bitwise.  A block of
// MB * 64 threads takes MB ray blocks of 128 rays, warp w the 64-ray
// tile w:
//
//   v1  the block walks the live windows and stages each once for all
//       its rays (heavy_walk in sweep.cuh: K2's own layout, which is v1
//       at MB = 2).
//   v2  the grid is (ceil(NB / MB), NWH); a block whose window is dead
//       exits at once.  Windows merge by a 64-bit atomicMin on the key
//       (float_bits(t) << 32) | face, which orders as lex-min (t, face)
//       because an admitted t lies in (0, 3e38) (positive floats order as
//       their bits) and a face id is >= 0.  The wrapper fills the keys
//       with the no-hit key and returns t and face as views of them; a
//       block starts from its rays' keys (any key read is an upper bound
//       of the result, which sharpens the could-win vote) and writes back
//       only the keys it lowers.
//   v3  NWH is a template constant; the live windows of the table are
//       staged once per block, face-major (NWH * 8 KB: 64 KB for 8
//       windows, opted in above 48 KB), and the window loop is unrolled
//       under the live predicate.
//
// What bounds them on the H100: instruction issue, as K2 (~21 flops per
// (ray, face) test, every ray against every live face; the table is
// NWH x 8 KB).  On the script's data every footprint holds the whole
// grid and the rays' cells are random, so the footprint ballots skip
// only dead faces; ~6% of tests survive the t-free rejections, and the
// could-win vote leaves the division to the few warps where a ray's t
// could still drop.  What the layouts trade: v1 stages each window per
// block (8 KB, 2 barriers), v2 reloads the rays per window and pays an
// atomic per lowered key but spreads a block's work over NWH blocks, v3
// stages once but holds NWH * 8 KB of shared memory per block.

#include "sweep.cuh"

namespace {

using namespace ugrt;

template <int MB, bool kStats>
__global__ void __launch_bounds__(MB * kHeavyTile)
heavy_v1_kernel(const float* __restrict__ table, int nwh,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                float* __restrict__ t_out, int* __restrict__ f_out,
                unsigned long long* __restrict__ stats) {
  heavy_walk<MB, kStats>(table, nwh, heavy_count, rays, nb, eps, abs_t, t_out,
                         f_out, stats);
}

__device__ __forceinline__ unsigned long long pack_key(float t, int f) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(f);
}

template <int MB, bool kStats>
__global__ void __launch_bounds__(MB * kHeavyTile)
heavy_v2_kernel(const float* __restrict__ table, int nwh,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                unsigned long long* __restrict__ key,
                unsigned long long* __restrict__ stats) {
  const int w = blockIdx.y;
  if (w >= heavy_live_windows(heavy_count, nwh)) return;   // whole block
  __shared__ float4 s[kHeavyWin][4];
  const size_t ray0 = static_cast<size_t>(blockIdx.x) * MB * kRays +
                      (threadIdx.x >> 5) * kHeavyTile + (threadIdx.x & 31);
  const bool live = ray0 < static_cast<size_t>(nb) * kRays;  // per warp
  HeavyRays r;
  HeavyStats st;
  unsigned long long k0[2];
  if (live) {
    heavy_load(rays, ray0, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      k0[h] = key[ray0 + 32 * h];
      heavy_set(r, h, __uint_as_float(static_cast<unsigned>(k0[h] >> 32)),
                static_cast<int>(k0[h] & 0xffffffffu));
    }
  }
  heavy_stage(s, table, static_cast<size_t>(nwh) * kHeavyWin, w * kHeavyWin,
              kHeavyWin);
  __syncthreads();
  if (!live) return;
  heavy_window<kStats>(s, r, eps, abs_t, st);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned long long k1 = pack_key(r.t[h], r.f[h]);
    if (k1 < k0[h]) atomicMin(key + ray0 + 32 * h, k1);
  }
  if (kStats) heavy_add_stats(st, stats);
}

template <int NWH, int MB, bool kStats>
__global__ void __launch_bounds__(MB * kHeavyTile)
heavy_v3_kernel(const float* __restrict__ table,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                float* __restrict__ t_out, int* __restrict__ f_out,
                unsigned long long* __restrict__ stats) {
  extern __shared__ float4 s_table[];               // [NWH * 128][4]
  auto s = reinterpret_cast<float4 (*)[4]>(s_table);
  const size_t ray0 = static_cast<size_t>(blockIdx.x) * MB * kRays +
                      (threadIdx.x >> 5) * kHeavyTile + (threadIdx.x & 31);
  const bool live = ray0 < static_cast<size_t>(nb) * kRays;  // per warp
  HeavyRays r;
  HeavyStats st;
  if (live) heavy_load(rays, ray0, r);
  const int n_live = heavy_live_windows(heavy_count, NWH);
  heavy_stage(s, table, NWH * kHeavyWin, 0, n_live * kHeavyWin);
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int w = 0; w < NWH; ++w) {
    if (w < n_live) heavy_window<kStats>(s + w * kHeavyWin, r, eps, abs_t, st);
  }
  heavy_store(r, ray0, t_out, f_out);
  if (kStats) heavy_add_stats(st, stats);
}

struct Args {
  const float* table;
  int nwh;
  const int* heavy_count;
  const float* rays;
  int nb;
  float eps;
  int abs_t;
  float* t_out;
  int* f_out;
  unsigned long long* key;
  unsigned long long* stats;
  cudaStream_t stream;
};

// One launch of each layout: V1<MB, kStats>::run(args), and so on.
template <int MB, bool kStats>
struct V1 {
  static cudaError_t run(const Args& a) {
    heavy_v1_kernel<MB, kStats><<<(a.nb + MB - 1) / MB, MB * kHeavyTile, 0,
                                  a.stream>>>(
        a.table, a.nwh, a.heavy_count, a.rays, a.nb, a.eps, a.abs_t,
        a.t_out, a.f_out, a.stats);
    return cudaGetLastError();
  }
};

template <int MB, bool kStats>
struct V2 {
  static cudaError_t run(const Args& a) {
    const dim3 grid((a.nb + MB - 1) / MB, a.nwh);
    heavy_v2_kernel<MB, kStats><<<grid, MB * kHeavyTile, 0, a.stream>>>(
        a.table, a.nwh, a.heavy_count, a.rays, a.nb, a.eps, a.abs_t, a.key,
        a.stats);
    return cudaGetLastError();
  }
};

template <int NWH>
struct V3 {
  template <int MB, bool kStats>
  struct At {
    static cudaError_t run(const Args& a) {
      const int smem = NWH * kHeavyWin * 4 * static_cast<int>(sizeof(float4));
      auto kernel = heavy_v3_kernel<NWH, MB, kStats>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<(a.nb + MB - 1) / MB, MB * kHeavyTile, smem, a.stream>>>(
          a.table, a.heavy_count, a.rays, a.nb, a.eps, a.abs_t, a.t_out,
          a.f_out, a.stats);
      return cudaGetLastError();
    }
  };
};

// Layout<MB, kStats>::run(args) for mb in {1, 2, 4, 8}, the counting
// build where args.stats is non-null.
template <template <int, bool> class Layout>
int dispatch(int mb, const Args& a) {
  if (a.nb == 0) return 0;
  const bool st = a.stats != nullptr;
  cudaError_t err;
  switch (mb) {
    case 1: err = st ? Layout<1, true>::run(a) : Layout<1, false>::run(a);
      break;
    case 2: err = st ? Layout<2, true>::run(a) : Layout<2, false>::run(a);
      break;
    case 4: err = st ? Layout<4, true>::run(a) : Layout<4, false>::run(a);
      break;
    case 8: err = st ? Layout<8, true>::run(a) : Layout<8, false>::run(a);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Args make_args(const void* table, int nwh, const void* heavy_count,
               const void* rays, int nb, float eps, int abs_t, void* t_out,
               void* f_out, void* key, void* stats, void* stream) {
  return Args{static_cast<const float*>(table), nwh,
              static_cast<const int*>(heavy_count),
              static_cast<const float*>(rays), nb, eps, abs_t,
              static_cast<float*>(t_out), static_cast<int*>(f_out),
              static_cast<unsigned long long*>(key),
              static_cast<unsigned long long*>(stats),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The three entry points take the table f32 [16, nwh * 128], heavy_count
// an int32 scalar on the device, rays f32 [nb, 128, 8], mb in
// {1, 2, 4, 8} (64 * mb threads per block) and `stats`, null or int64 [4]
// zeroed, for a counting build (the (ray, face) tests whose warp skipped
// the face at the footprint, at the t-free vote and at the could-win
// vote, and those that divided); they run on `stream`.

// v1 writes t f32 and face int32 [nb, 128].
extern "C" int ugrt_heavy_sweep_v1(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* t_out, void* f_out, void* stats,
                                   void* stream) {
  return dispatch<V1>(mb, make_args(table, nwh, heavy_count, rays, nb, eps,
                                    abs_t, t_out, f_out, nullptr, stats,
                                    stream));
}

// v2 lowers `key`, uint64 [nb * 128] filled with the no-hit key
// (bits(3e38) << 32) | (2^31 - 1); nwh <= 65535.
extern "C" int ugrt_heavy_sweep_v2(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* key, void* stats, void* stream) {
  if (nwh < 1 || nwh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<V2>(mb, make_args(table, nwh, heavy_count, rays, nb, eps,
                                    abs_t, nullptr, nullptr, key, stats,
                                    stream));
}

// v3 writes t and face as v1 and needs nwh in {1, 2, 4, 8, 16} (up to
// 128 KB of shared memory).
extern "C" int ugrt_heavy_sweep_v3(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* t_out, void* f_out, void* stats,
                                   void* stream) {
  const Args a = make_args(table, nwh, heavy_count, rays, nb, eps, abs_t,
                           t_out, f_out, nullptr, stats, stream);
  switch (nwh) {
    case 1: return dispatch<V3<1>::At>(mb, a);
    case 2: return dispatch<V3<2>::At>(mb, a);
    case 4: return dispatch<V3<4>::At>(mb, a);
    case 8: return dispatch<V3<8>::At>(mb, a);
    case 16: return dispatch<V3<16>::At>(mb, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
