// Shared pieces of the three sweep kernels (K1 primary_sweep.cu,
// K2 heavy_primary_sweep.cu, K3 shadow_sweep.cu) and of K2's probes
// (heavy_variants.cu).
//
// Layout contract with the Python wrappers (ugrt_torch/kernels/):
//   rays       f32 [NB, 128, 8]  ray-major rows; K1/K3: a CUDA block of
//                                128 threads takes a 128-ray block, one
//                                thread per ray; K2/S3: a warp takes 64
//                                rays, two per lane
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

// ---- The heavy-face body: K2 (heavy_primary_sweep.cu) and its layout
// probes S3 (heavy_variants.cu) ----
//
// Every ray tests every live heavy face of the comp-major table f32
// [16, NWH * 128] (a = e2 x e1, b = e2 x tvec, c = tvec x e1, k, the
// footprint box x0 x1 y0 y1, the face id) in the op order of
// _heavy_common (ugrt/trace/pallas_tracer.py:605-635): det = d.a,
// up = d.b, vp = d.c; accept ud = up*det and vd = vp*det in [0, det^2]
// with ud + vd <= det^2; t = k * (1/det), |t| under the abs_t quirk,
// t > 0; the ray's cell (gx, gy) in the footprint.  Per ray: lex-min
// (t, face), (3e38, 2^31-1) where nothing is admitted.
//
// A window of 128 faces is staged face-major, face q = s[q][0..3] =
// {a0 a1 a2 b0} {b1 b2 c0 c1} {c2 k x0 x1} {y0 y1 face -} (the face id
// as the bits of its int), so a face
// arrives as four 128-bit broadcasts.  A warp takes a 64-ray tile, lane
// l its rays l and l + 32, so one load serves two tests.  A warp skips
// work in three warp-uniform steps, each before the costlier one:
// 1. the footprint: per 32 faces one ballot finds the faces that meet
//    the box of the warp's cells and one the faces that hold it; a face
//    that holds it needs no per-ray compares (on the frame path a tile's
//    64 rays share one cell, so every face is one or the other);
// 2. the rejections that need no t (|det| < eps, ud and vd out of
//    [0, det^2], the footprint), voted per face;
// 3. the could-win bound (win_bound): a ray whose candidate t provably
//    exceeds its running t needs no division; each half-warp divides only
//    where one of its rays could still win or tie.
// Rays that reach the division see _heavy_common's operations on the
// same values, and a skipped candidate could not have changed (t, face),
// so the result is bitwise heavy_primary_sweep_plain's.

constexpr int kHeavyWin = 128;       // faces per heavy window
constexpr int kHeavyTile = 64;       // rays per warp

// The could-win bound of a ray whose running t is best_t.  A candidate's
// t is RN(|k| * RN(1 / |det|)) (a negative t is rejected, and |t| under
// abs_t rounds the same; RN rounds to nearest, u = 2^-24), and it changes
// the ray's (t, face) only if t <= best_t.  With lim = RN(best_t * c),
// c = 1 + 2^-20, and Q = RN(|det| * lim): where best_t >= 2^-100,
// Q >= 2^-100 and |det| <= 2^100, the exact lim, Q and 1/|det| are
// normal floats (or Q overflows to inf, and nothing is dropped), so each
// rounding loses at most a factor (1 - u), and |k| > Q gives
//   |k| * RN(1/|det|) > best_t * c * (1 - u)^3 >= best_t * (1 + 2^-23)
// (c (1 - u)^3 > 1 + 13 * 2^-24), which is at least the next float above
// the normal best_t.  RN is monotone, so t > best_t: the candidate can
// neither win nor tie.  The margin is 3x what the roundings need.  Below
// 2^-100 the bound is inf and drops nothing; NaN drops nothing.
__device__ __forceinline__ float win_bound(float best_t) {
  return best_t >= 0x1p-100f ? best_t * (1.0f + 0x1p-20f)
                             : __int_as_float(0x7f800000);
}

// A warp's two rays per lane and their running (t, face).
struct HeavyRays {
  float dx[2], dy[2], dz[2], gx[2], gy[2];
  float t[2], lim[2];                 // running t and its win_bound
  int f[2];                           // running face
  float box[4];                       // the warp's cells: x lo, hi, y lo, hi
  unsigned box_ok;                    // kFull unless a cell is NaN
};

// Warp counts of a counting build, in half-warp rows (32 tests each):
// skipped at the footprint, at the t-free vote, at the could-win vote,
// and divided.
struct HeavyStats {
  unsigned fp = 0, pre = 0, win = 0, div = 0;
};

__device__ __forceinline__ void heavy_set(HeavyRays& r, int h, float t,
                                          int f) {
  r.t[h] = t;
  r.f[h] = f;
  r.lim[h] = win_bound(t);
}

// Lane l's rays ray0 and ray0 + 32 of rays f32 [NB, 128, 8] (dir 0:3,
// gx 4, gy 5), no hit yet.  All 32 lanes of a warp call it.
__device__ __forceinline__ void heavy_load(const float* __restrict__ rays,
                                           size_t ray0, HeavyRays& r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* p = rays + (ray0 + 32 * h) * 8;
    const float4 d = *reinterpret_cast<const float4*>(p);
    const float2 g = *reinterpret_cast<const float2*>(p + 4);
    r.dx[h] = d.x;
    r.dy[h] = d.y;
    r.dz[h] = d.z;
    r.gx[h] = g.x;
    r.gy[h] = g.y;
    heavy_set(r, h, kBig, kMaxI);
  }
  float b[4] = {fminf(r.gx[0], r.gx[1]), fmaxf(r.gx[0], r.gx[1]),
                fminf(r.gy[0], r.gy[1]), fmaxf(r.gy[0], r.gy[1])};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b[0] = fminf(b[0], __shfl_xor_sync(kFull, b[0], o));
    b[1] = fmaxf(b[1], __shfl_xor_sync(kFull, b[1], o));
    b[2] = fminf(b[2], __shfl_xor_sync(kFull, b[2], o));
    b[3] = fmaxf(b[3], __shfl_xor_sync(kFull, b[3], o));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) r.box[i] = b[i];
  // fminf skips NaN, and a NaN cell lies in no footprint.
  const bool nan = (r.gx[0] != r.gx[0]) | (r.gx[1] != r.gx[1]) |
                   (r.gy[0] != r.gy[0]) | (r.gy[1] != r.gy[1]);
  r.box_ok = __any_sync(kFull, nan) ? 0u : kFull;
}

// Stage faces [0, n) from table column col0 on into s, face-major: thread
// q stages face q, 15 loads coalesced across threads.  Callers fence
// with __syncthreads().
__device__ __forceinline__ void heavy_stage(float4 (*s)[4],
                                            const float* __restrict__ table,
                                            size_t ncol, int col0, int n) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const float* col = table + col0 + q;
    float v[15];
#pragma unroll
    for (int c = 0; c < 15; ++c) v[c] = col[c * ncol];
    s[q][0] = make_float4(v[0], v[1], v[2], v[3]);
    s[q][1] = make_float4(v[4], v[5], v[6], v[7]);
    s[q][2] = make_float4(v[8], v[9], v[10], v[11]);
    s[q][3] = make_float4(v[12], v[13],
                          __int_as_float(static_cast<int>(v[14])), 0.0f);
  }
}

// Fold ray h's candidate (need: it survived every test that needs no t
// and may win) into its running lex-min, in the op order of
// _heavy_common.
__device__ __forceinline__ void heavy_take(bool need, float det, float k,
                                           int abs_t, int face, HeavyRays& r,
                                           int h) {
  const float inv = 1.0f / det;
  float t = k * inv;
  if (abs_t) t = fabsf(t);
  if (need && !(t <= 0.0f) && t < kBig &&
      (t < r.t[h] || (t == r.t[h] && face < r.f[h])))
    heavy_set(r, h, t, face);
}

// Face q against the lane's two rays, of which fp[h] lie in its
// footprint.
template <bool kStats>
__device__ __forceinline__ void heavy_face(const float4 (*s)[4], int q,
                                           const bool fp[2], HeavyRays& r,
                                           float eps, int abs_t,
                                           HeavyStats& st) {
  const float4 A = s[q][0], B = s[q][1], C = s[q][2];
  float det[2];
  bool pre[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float d = r.dx[h] * A.x + r.dy[h] * A.y + r.dz[h] * A.z;
    const float up = r.dx[h] * A.w + r.dy[h] * B.x + r.dz[h] * B.y;
    const float vp = r.dx[h] * B.z + r.dy[h] * B.w + r.dz[h] * C.x;
    const float d2 = d * d;
    const float ud = up * d;
    const float vd = vp * d;
    det[h] = d;
    pre[h] = fp[h] & !((fabsf(d) < eps) | (ud < 0.0f) | (ud > d2) |
                       (vd < 0.0f) | (ud + vd > d2));
  }
  if (!__any_sync(kFull, pre[0] | pre[1])) {
    if (kStats) st.pre += 2;
    return;
  }
  const float ak = fabsf(C.y);
  bool need[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ad = fabsf(det[h]);
    const float lq = ad * r.lim[h];
    need[h] = pre[h] & !((ak > lq) & (lq >= 0x1p-100f) & (ad <= 0x1p100f));
  }
  if (!__any_sync(kFull, need[0] | need[1])) {
    if (kStats) st.win += 2;
    return;
  }
  const int face = __float_as_int(s[q][3].z);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool any = __any_sync(kFull, need[h]);
    if (kStats) (any ? st.div : st.win) += 1;
    if (any) heavy_take(need[h], det[h], C.y, abs_t, face, r, h);
  }
}

// The warp's rays against the 128 faces of the staged window s.
template <bool kStats>
__device__ __forceinline__ void heavy_window(const float4 (*s)[4],
                                             HeavyRays& r, float eps,
                                             int abs_t, HeavyStats& st) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < kHeavyWin; j += 32) {
    const float4 C = s[j + lane][2], D = s[j + lane][3];
    const float x0 = C.z, x1 = C.w, y0 = D.x, y1 = D.y;
    unsigned meet = __ballot_sync(
        kFull, (x0 <= x1) & (y0 <= y1) & (x0 <= r.box[1]) &
                   (x1 >= r.box[0]) & (y0 <= r.box[3]) & (y1 >= r.box[2]));
    const unsigned hold =
        __ballot_sync(kFull, (x0 <= r.box[0]) & (x1 >= r.box[1]) &
                                 (y0 <= r.box[2]) & (y1 >= r.box[3])) &
        r.box_ok;
    if (kStats) st.fp += 2 * (32 - __popc(meet));
    if (hold == kFull) {
      // Every face of the group holds the warp's cells (always, on S3's
      // data): no per-face bit scan and no per-ray footprint test.
      const bool all[2] = {true, true};
#pragma unroll 2
      for (int q = j; q < j + 32; ++q)
        heavy_face<kStats>(s, q, all, r, eps, abs_t, st);
      continue;
    }
    while (meet) {
      const int b = __ffs(meet) - 1;
      meet &= meet - 1;
      const int q = j + b;
      bool fp[2] = {true, true};
      if (!((hold >> b) & 1)) {
        const float4 Cq = s[q][2], Dq = s[q][3];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fp[h] = (r.gx[h] >= Cq.z) & (r.gx[h] <= Cq.w) & (r.gy[h] >= Dq.x) &
                  (r.gy[h] <= Dq.y);
        if (!__any_sync(kFull, fp[0] | fp[1])) {
          if (kStats) st.fp += 2;
          continue;
        }
      }
      heavy_face<kStats>(s, q, fp, r, eps, abs_t, st);
    }
  }
}

__device__ __forceinline__ int heavy_live_windows(const int* heavy_count,
                                                  int nwh) {
  return min(max((heavy_count[0] + kHeavyWin - 1) / kHeavyWin, 0), nwh);
}

__device__ __forceinline__ void heavy_store(const HeavyRays& r, size_t ray0,
                                            float* __restrict__ t_out,
                                            int* __restrict__ f_out) {
  t_out[ray0] = r.t[0];
  f_out[ray0] = r.f[0];
  t_out[ray0 + 32] = r.t[1];
  f_out[ray0 + 32] = r.f[1];
}

// Adds a warp's counts, in (ray, face) tests, to stats[0..3].
__device__ __forceinline__ void heavy_add_stats(const HeavyStats& st,
                                                unsigned long long* stats) {
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, 32ull * st.fp);
    atomicAdd(stats + 1, 32ull * st.pre);
    atomicAdd(stats + 2, 32ull * st.win);
    atomicAdd(stats + 3, 32ull * st.div);
  }
}

// K2's layout, and S3's v1: a block of MB * 64 threads takes MB ray
// blocks (warp w the 64-ray tile w) and walks the live windows, staging
// each once for all its rays.  Rays past the last block only stage.
template <int MB, bool kStats>
__device__ __forceinline__ void heavy_walk(
    const float* __restrict__ table, int nwh,
    const int* __restrict__ heavy_count, const float* __restrict__ rays,
    int nb, float eps, int abs_t, float* __restrict__ t_out,
    int* __restrict__ f_out, unsigned long long* __restrict__ stats) {
  __shared__ float4 s[kHeavyWin][4];
  const size_t ray0 = static_cast<size_t>(blockIdx.x) * MB * kRays +
                      (threadIdx.x >> 5) * kHeavyTile + (threadIdx.x & 31);
  const bool live = ray0 < static_cast<size_t>(nb) * kRays;  // per warp
  HeavyRays r;
  HeavyStats st;
  if (live) heavy_load(rays, ray0, r);
  const size_t ncol = static_cast<size_t>(nwh) * kHeavyWin;
  const int n_live = heavy_live_windows(heavy_count, nwh);
  for (int w = 0; w < n_live; ++w) {
    __syncthreads();
    heavy_stage(s, table, ncol, w * kHeavyWin, kHeavyWin);
    __syncthreads();
    if (live) heavy_window<kStats>(s, r, eps, abs_t, st);
  }
  if (!live) return;
  heavy_store(r, ray0, t_out, f_out);
  if (kStats) heavy_add_stats(st, stats);
}

}  // namespace ugrt
