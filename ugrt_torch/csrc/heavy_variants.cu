// S3 — K2's function (dense heavy-face primary sweep) under three loop
// layouts, as a probe of how a block's window loop should be laid out.
//
// Replaces the Pallas probes _v1_kernel, _v2_kernel and _v3_kernel of
// scripts/micro_heavy.py:105-183 (launched at :70), which computed
// _heavy_primary_kernel's result with one window loop per grid step, the
// window as a grid axis, and a full unroll.  Every variant here returns
// K2's (t, face) bitwise (heavy_fold in sweep.cuh, -fmad=false), for
// 128 * MB threads per block, MB ray blocks of 128 rays each:
//
//   v1  one block walks the live windows; each window is staged in shared
//       memory once for all its MB * 128 rays; (t, face) in registers.
//   v2  the grid is (ceil(NB / MB), NWH); a block whose window is dead
//       exits at once.  Windows merge by a 64-bit atomicMin on the key
//       (float_bits(t) << 32) | face, which orders as lex-min (t, face)
//       because an accepted t lies in (0, 3e38): positive floats order
//       as their bits.  An init pass sets every key to (3e38, 2^31-1), an
//       unpack pass writes t and face.  This is the split design proposed
//       for K3's long cell-key ranges, measured on K2's data.
//   v3  NWH is a template constant; the whole table (NWH * 8 KB) is
//       staged in shared memory once per block, and an unrolled loop over
//       the windows tests each one under a live predicate.
//
// What bounds them on the H100: ~25 flops per (ray, face), every ray
// against every live face — compute; the table is NWH x 8 KB.  What the
// layouts trade: v1 re-stages each window per block (8 KB, 2 syncs),
// v2 reloads the rays per window and pays one atomic per ray per window
// but spreads one block's work over NWH blocks, v3 stages once but needs
// NWH * 8 KB of shared memory per block (opt-in above 48 KB).

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kWin = 128;

__device__ __forceinline__ int live_windows(const int* heavy_count,
                                            int nwh) {
  return min(max((heavy_count[0] + kWin - 1) / kWin, 0), nwh);
}

struct Ray {
  float dx, dy, dz, gx, gy;
  bool valid;
};

// Thread threadIdx.x of a block of MB ray blocks starting at
// blockIdx.x * MB; rays past the last block are invalid but still
// take part in staging and barriers.
template <int MB>
__device__ __forceinline__ Ray load_ray(const float* rays, int nb,
                                        size_t* ray_index) {
  const size_t ray =
      static_cast<size_t>(blockIdx.x) * MB * kRays + threadIdx.x;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, ray < static_cast<size_t>(nb) * kRays};
  if (r.valid) {
    const float* p = rays + ray * 8;
    r.dx = p[0];
    r.dy = p[1];
    r.dz = p[2];
    r.gx = p[4];
    r.gy = p[5];
  }
  *ray_index = ray;
  return r;
}

// Stage window w of the [16, nwh * 128] table into s[16][128].
template <int MB>
__device__ __forceinline__ void stage_window(float (*s)[kWin],
                                             const float* table,
                                             size_t ncol, int w) {
  for (int j = threadIdx.x; j < kComp * kWin; j += MB * kRays)
    s[j / kWin][j % kWin] =
        table[(j / kWin) * ncol + static_cast<size_t>(w) * kWin + j % kWin];
}

template <int MB>
__global__ void __launch_bounds__(MB * kRays)
heavy_v1_kernel(const float* __restrict__ table, int nwh,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                float* __restrict__ t_out, int* __restrict__ f_out) {
  __shared__ float s[kComp][kWin];
  size_t ray;
  const Ray r = load_ray<MB>(rays, nb, &ray);
  const size_t ncol = static_cast<size_t>(nwh) * kWin;
  const int n_live = live_windows(heavy_count, nwh);
  float best_t = kBig;
  int best_f = kMaxI;
  for (int w = 0; w < n_live; ++w) {
    __syncthreads();
    stage_window<MB>(s, table, ncol, w);
    __syncthreads();
    for (int q = 0; q < kWin; ++q)
      heavy_fold([&](int c) { return s[c][q]; }, r.dx, r.dy, r.dz, r.gx,
                 r.gy, eps, abs_t, best_t, best_f);
  }
  if (r.valid) {
    t_out[ray] = best_t;
    f_out[ray] = best_f;
  }
}

// (float_bits(kBig) << 32) | kMaxI; 0x7f61b1e6 is 3e38f.
constexpr unsigned long long kInitKey =
    (static_cast<unsigned long long>(0x7f61b1e6u) << 32) | 0x7fffffffu;

__global__ void key_init_kernel(unsigned long long* key, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) key[i] = kInitKey;
}

__global__ void key_unpack_kernel(const unsigned long long* __restrict__ key,
                                  size_t n, float* __restrict__ t_out,
                                  int* __restrict__ f_out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = key[i];
    t_out[i] = __uint_as_float(static_cast<unsigned>(k >> 32));
    f_out[i] = static_cast<int>(k & 0xffffffffu);
  }
}

template <int MB>
__global__ void __launch_bounds__(MB * kRays)
heavy_v2_kernel(const float* __restrict__ table, int nwh,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                unsigned long long* __restrict__ key) {
  const int w = blockIdx.y;
  if (w >= live_windows(heavy_count, nwh)) return;   // whole block
  __shared__ float s[kComp][kWin];
  size_t ray;
  const Ray r = load_ray<MB>(rays, nb, &ray);
  stage_window<MB>(s, table, static_cast<size_t>(nwh) * kWin, w);
  __syncthreads();
  float best_t = kBig;
  int best_f = kMaxI;
  for (int q = 0; q < kWin; ++q)
    heavy_fold([&](int c) { return s[c][q]; }, r.dx, r.dy, r.dz, r.gx, r.gy,
               eps, abs_t, best_t, best_f);
  if (r.valid && best_t < kBig)
    atomicMin(key + ray,
              (static_cast<unsigned long long>(__float_as_uint(best_t)) << 32)
                  | static_cast<unsigned>(best_f));
}

template <int NWH, int MB>
__global__ void __launch_bounds__(MB * kRays)
heavy_v3_kernel(const float* __restrict__ table,
                const int* __restrict__ heavy_count,
                const float* __restrict__ rays, int nb, float eps, int abs_t,
                float* __restrict__ t_out, int* __restrict__ f_out) {
  extern __shared__ float s_table[];                 // [16][NWH * 128]
  constexpr int kCols = NWH * kWin;
  size_t ray;
  const Ray r = load_ray<MB>(rays, nb, &ray);
  for (int j = threadIdx.x; j < kComp * kCols; j += MB * kRays)
    s_table[j] = table[j];
  __syncthreads();
  const int n_live = live_windows(heavy_count, NWH);
  float best_t = kBig;
  int best_f = kMaxI;
#pragma unroll
  for (int w = 0; w < NWH; ++w) {
    if (w < n_live) {
      for (int q = 0; q < kWin; ++q)
        heavy_fold([&](int c) { return s_table[c * kCols + w * kWin + q]; },
                   r.dx, r.dy, r.dz, r.gx, r.gy, eps, abs_t, best_t, best_f);
    }
  }
  if (r.valid) {
    t_out[ray] = best_t;
    f_out[ray] = best_f;
  }
}

template <int NWH, int MB>
cudaError_t launch_v3(const float* table, const int* heavy_count,
                      const float* rays, int nb, float eps, int abs_t,
                      float* t_out, int* f_out, cudaStream_t stream) {
  const int smem = kComp * NWH * kWin * static_cast<int>(sizeof(float));
  auto kernel = heavy_v3_kernel<NWH, MB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(nb + MB - 1) / MB, MB * kRays, smem, stream>>>(
      table, heavy_count, rays, nb, eps, abs_t, t_out, f_out);
  return cudaGetLastError();
}

template <int NWH>
cudaError_t launch_v3_mb(int mb, const float* table, const int* heavy_count,
                         const float* rays, int nb, float eps, int abs_t,
                         float* t_out, int* f_out, cudaStream_t stream) {
  switch (mb) {
    case 1: return launch_v3<NWH, 1>(table, heavy_count, rays, nb, eps,
                                     abs_t, t_out, f_out, stream);
    case 2: return launch_v3<NWH, 2>(table, heavy_count, rays, nb, eps,
                                     abs_t, t_out, f_out, stream);
    case 4: return launch_v3<NWH, 4>(table, heavy_count, rays, nb, eps,
                                     abs_t, t_out, f_out, stream);
    case 8: return launch_v3<NWH, 8>(table, heavy_count, rays, nb, eps,
                                     abs_t, t_out, f_out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The three entry points take the table f32 [16, nwh * 128], heavy_count
// an int32 scalar on the device, rays f32 [nb, 128, 8], and mb in
// {1, 2, 4, 8} (128 * mb threads per block); they write t f32 and face
// int32 [nb, 128] on `stream`.

extern "C" int ugrt_heavy_sweep_v1(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* t_out, void* f_out, void* stream) {
  if (nb == 0) return 0;
  const auto* tb = static_cast<const float*>(table);
  const auto* hc = static_cast<const int*>(heavy_count);
  const auto* ry = static_cast<const float*>(rays);
  auto* t = static_cast<float*>(t_out);
  auto* f = static_cast<int*>(f_out);
  auto st = static_cast<cudaStream_t>(stream);
  const int grid = (nb + mb - 1) / mb;
  switch (mb) {
    case 1: heavy_v1_kernel<1><<<grid, 1 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, t, f); break;
    case 2: heavy_v1_kernel<2><<<grid, 2 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, t, f); break;
    case 4: heavy_v1_kernel<4><<<grid, 4 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, t, f); break;
    case 8: heavy_v1_kernel<8><<<grid, 8 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, t, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// v2 also takes `key`, scratch of nb * 128 uint64.
extern "C" int ugrt_heavy_sweep_v2(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* key, void* t_out, void* f_out,
                                   void* stream) {
  if (nb == 0) return 0;
  const auto* tb = static_cast<const float*>(table);
  const auto* hc = static_cast<const int*>(heavy_count);
  const auto* ry = static_cast<const float*>(rays);
  auto* k = static_cast<unsigned long long*>(key);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(nb) * kRays;
  const int pass_blocks = static_cast<int>((n + 255) / 256);
  if ((mb != 1 && mb != 2 && mb != 4 && mb != 8) || nwh < 1 || nwh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  key_init_kernel<<<pass_blocks, 256, 0, st>>>(k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nb + mb - 1) / mb, nwh);
  switch (mb) {
    case 1: heavy_v2_kernel<1><<<grid, 1 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, k); break;
    case 2: heavy_v2_kernel<2><<<grid, 2 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, k); break;
    case 4: heavy_v2_kernel<4><<<grid, 4 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, k); break;
    case 8: heavy_v2_kernel<8><<<grid, 8 * kRays, 0, st>>>(
        tb, nwh, hc, ry, nb, eps, abs_t, k); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  key_unpack_kernel<<<pass_blocks, 256, 0, st>>>(
      k, n, static_cast<float*>(t_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// v3 needs nwh in {1, 2, 4, 8, 16} (the table is staged whole: up to
// 128 KB of shared memory).
extern "C" int ugrt_heavy_sweep_v3(const void* table, int nwh,
                                   const void* heavy_count, const void* rays,
                                   int nb, float eps, int abs_t, int mb,
                                   void* t_out, void* f_out, void* stream) {
  if (nb == 0) return 0;
  const auto* tb = static_cast<const float*>(table);
  const auto* hc = static_cast<const int*>(heavy_count);
  const auto* ry = static_cast<const float*>(rays);
  auto* t = static_cast<float*>(t_out);
  auto* f = static_cast<int*>(f_out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nwh) {
    case 1: err = launch_v3_mb<1>(mb, tb, hc, ry, nb, eps, abs_t, t, f, st);
      break;
    case 2: err = launch_v3_mb<2>(mb, tb, hc, ry, nb, eps, abs_t, t, f, st);
      break;
    case 4: err = launch_v3_mb<4>(mb, tb, hc, ry, nb, eps, abs_t, t, f, st);
      break;
    case 8: err = launch_v3_mb<8>(mb, tb, hc, ry, nb, eps, abs_t, t, f, st);
      break;
    case 16: err = launch_v3_mb<16>(mb, tb, hc, ry, nb, eps, abs_t, t, f, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
