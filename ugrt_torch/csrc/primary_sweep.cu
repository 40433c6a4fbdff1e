// K1 — primary windowed sweep.
//
// Replaces the Pallas kernel _primary_kernel + _primary_body
// (ugrt/trace/pallas_tracer.py:304-387): direct-form Möller–Trumbore of
// each ray of a 128-ray block against 128-triangle windows of the
// perspective grid's sorted pair array, admission by cell key, per ray
// the lex-min (t, face) of the admitted hits.
//
// Contract per ray (pallas_tracer.py:353-387): reject |det| < eps,
// u < 0, u > 1, v < 0, u + v > 1, t <= 0 (after |t| under the abs_t
// quirk) and a row key != the ray's cell key; keep the lex-min (t, face)
// of the rest.  Pallas's "min face among equal t in a window, strict <
// across ascending windows" is the same because pairs sort by (cell,
// face).  Outputs t = 3e38 and face = 2^31-1 where nothing is admitted.
//
// What bounds it on the H100: latency per work item — staging each
// window (8 KB, mostly from L2), two barriers and the item decode for
// ~20 admitted rows per warp, ~55 instructions each without FMA
// contraction.  Two properties of the inputs shape the design (flagship
// frame):
// - the ranges are skewed: 1.43 windows per ray block on average, 85 at
//   most, so one CUDA block per ray block would wait on the longest;
// - a warp's rays need only the rows of their cell keys, 1 in 6.5 of
//   the rows of their ranges.
//
// The design is K3's (shadow_sweep.cu): each ray block's range is cut
// into chunks of at most `chunk` windows, one work item each, and a
// persistent grid takes items from a device counter (decode_item,
// sweep.cuh), so no SM waits on a long range; a block takes its next
// item while it works on the current one.  Several items write one ray,
// so an item folds its rays' running (t, face) into a per-ray
// 64-bit key (bits(t) << 32) | face with one atomicMin where it found a
// hit.  An admitted t is positive, finite and below 3e38, and face ids of
// admitted rows are >= 0 (pack_tri_windows: padding rows have det 0), so
// the key orders exactly as the lex-min (t, face): the result does not
// depend on the order of the items or on `chunk`, and it is bitwise
// repeatable.  Within a window a warp runs only the rows that some
// lane's cell key admits: on the frame path a warp's 32 rays share one
// cell, and one ballot per 32 rows finds that cell's rows; otherwise a
// warp-uniform vote per row decides.  Either way the set of rows run is
// the same, and every row runs the arithmetic of _primary_body in its
// order.

#include "sweep.cuh"

namespace {

using namespace ugrt;
constexpr int kWin = 128;
// (bits(3e38) << 32) | (2^31 - 1): the key of "no hit".  The item counter
// sits after the keys and starts at the same value, so that one fill on
// the stream sets both; an item's index is the counter's rise above it.
constexpr unsigned long long kNoHitKey = 0x7f61b1e67fffffffull;

// Möller–Trumbore of one ray against triangle row c (intersectTriUV,
// trace_kernel.cu:4-45), folded into the ray's running lex-min.
__device__ __forceinline__ void test_row(const float* c, float dx, float dy,
                                         float dz, float cell, float eps,
                                         int abs_t, float& best_t,
                                         int& best_f) {
  const float tvx = c[0], tvy = c[1], tvz = c[2];
  const float e1x = c[3], e1y = c[4], e1z = c[5];
  const float e2x = c[6], e2y = c[7], e2z = c[8];
  // pvec = dir x e2
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
  if (!reject && t < kBig && (t < best_t || (t == best_t && face < best_f))) {
    best_t = t;
    best_f = face;
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kRays)
primary_sweep_kernel(const float* __restrict__ tri, int nw,
                     const float* __restrict__ rays, int nb,
                     const int* __restrict__ w_lo,
                     const int* __restrict__ w_hi,
                     const int* __restrict__ item_end, int chunk, float eps,
                     int abs_t, unsigned long long* __restrict__ keys,
                     unsigned long long* __restrict__ stats) {
  __shared__ float4 s_win[kWin * kComp / 4];
  __shared__ int s_item[3];            // ray block (-1: no work left), w0, w1
  const float* s = reinterpret_cast<const float*>(s_win);
  const int lane = threadIdx.x & 31;
  unsigned long long* counter = keys + static_cast<size_t>(nb) * kRays;
  unsigned long long tested = 0, skipped = 0;   // warp-rows, kStats only

  // Thread 0 takes each next item while the block works on the current
  // one, so the counter's latency is hidden; warp 0 decodes it.
  int item = 0;
  if (threadIdx.x == 0)
    item = static_cast<int>(atomicAdd(counter, 1ull) - kNoHitKey);
  for (;;) {
    if (threadIdx.x < 32)
      decode_item(__shfl_sync(kFull, item, 0), item_end, nb, w_lo, w_hi, nw,
                  chunk, s_item);
    // Every thread reads s_item before the window loop's first barrier,
    // so warp 0 cannot overwrite it for the next item too early.
    __syncthreads();
    const int b = s_item[0];
    if (b < 0) break;
    const int w0 = s_item[1], w1 = s_item[2];
    if (threadIdx.x == 0)
      item = static_cast<int>(atomicAdd(counter, 1ull) - kNoHitKey);

    const size_t ray = static_cast<size_t>(b) * kRays + threadIdx.x;
    const float4 r = *reinterpret_cast<const float4*>(rays + ray * 8);
    const float dx = r.x, dy = r.y, dz = r.z, cell = r.w;
    // On the frame path a warp's 32 rays (half an 8x8 tile) share a cell.
    const bool one_cell =
        __all_sync(kFull, cell == __shfl_sync(kFull, cell, 0));
    float best_t = kBig;
    int best_f = kMaxI;
    for (int w = w0; w <= w1; ++w) {
      // Doubles as the fence before this window overwrites s_win.
      __syncthreads();
      stage(s_win,
            reinterpret_cast<const float4*>(tri + static_cast<size_t>(w) *
                                                      kWin * kComp),
            kWin * kComp / 4);
      __syncthreads();
      if (one_cell) {
        // The warp's rows are those with its cell's key: lane l checks
        // rows l, l + 32, ..., one ballot per 32 rows, and the warp runs
        // the set bits in ascending order.
        for (int j = 0; j < kWin; j += 32) {
          unsigned rows =
              __ballot_sync(kFull, s[(j + lane) * kComp + 9] == cell);
          if (kStats) {
            tested += __popc(rows);
            skipped += 32 - __popc(rows);
          }
          while (rows) {
            const int q = j + __ffs(rows) - 1;
            rows &= rows - 1;
            test_row(s + q * kComp, dx, dy, dz, cell, eps, abs_t, best_t,
                     best_f);
          }
        }
        continue;
      }
      for (int q = 0; q < kWin; ++q) {
        const float* c = s + q * kComp;
        // Every lane runs the same rows, so the vote is warp-uniform.
        if (!__any_sync(kFull, c[9] == cell)) {
          if (kStats) ++skipped;
          continue;
        }
        if (kStats) ++tested;
        test_row(c, dx, dy, dz, cell, eps, abs_t, best_t, best_f);
      }
    }
    if (best_t < kBig)
      atomicMin(keys + ray,
                (static_cast<unsigned long long>(__float_as_uint(best_t))
                 << 32) |
                    static_cast<unsigned>(best_f));
  }
  if (kStats && lane == 0) {
    atomicAdd(stats, tested * 32);
    atomicAdd(stats + 1, skipped * 32);
  }
}

template <bool kStats>
int launch(const void* tri, int nw, const void* rays, int nb,
           const void* w_lo, const void* w_hi, const void* item_end,
           int chunk, float eps, int abs_t, void* keys, void* stats,
           cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err =
      persistent_grid(primary_sweep_kernel<kStats>, kRays, 0, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  primary_sweep_kernel<kStats><<<grid, kRays, 0, stream>>>(
      static_cast<const float*>(tri), nw, static_cast<const float*>(rays), nb,
      static_cast<const int*>(w_lo), static_cast<const int*>(w_hi),
      static_cast<const int*>(item_end), chunk, eps, abs_t,
      static_cast<unsigned long long*>(keys),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream` as a persistent grid over the items of
// `item_end` (int32 [nb]).  `keys` is int64 [nb * 128 + 1]: the per-ray
// keys, then the item counter, all set to the no-hit key on `stream`
// before the launch.  With `stats` (int64 [2], zeroed) non-null it also
// counts the (ray, row) tests that warps ran and skipped.
extern "C" int ugrt_primary_sweep(const void* tri, int nw, const void* rays,
                                  int nb, const void* w_lo, const void* w_hi,
                                  const void* item_end, int chunk, float eps,
                                  int abs_t, void* keys, void* stats,
                                  void* stream) {
  if (nb == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return stats ? launch<true>(tri, nw, rays, nb, w_lo, w_hi, item_end, chunk,
                              eps, abs_t, keys, stats, s)
               : launch<false>(tri, nw, rays, nb, w_lo, w_hi, item_end,
                               chunk, eps, abs_t, keys, stats, s);
}
