// S2 — a windowed sweep cut into its parts: the copy of each item's
// triangle tile and ray tile, the math, or both, as a probe of whether a
// 128-row window sweep is bound by the copy or by the math.
//
// Replaces the Pallas probe `kern` in `make` of scripts/pallas_micro.py:29
// (launched at :63), with compute_block (:19-26).  Item k reads the
// 128 x 128 f32 tile tri[offs[k] : offs[k] + 128] and the ray tile
// rays[tiles[k]] (f32 [8, 128]); each ray column n runs over the 128
// tile rows r:
//
//   acc = T[r][0] * R[0][n]
//   for i in 1..8:  acc = |(acc + T[r][i] * R[i % 8][n]) * 1.0001 - 0.5|
//
// and writes min_r acc and the first r that attains it (jnp.argmin's
// tie rule) to t[k][n], i[k][n].  Variants: `dma` copies every item's
// whole tiles and writes zeros, `compute` runs the math on zero-filled
// buffers and copies nothing (the TPU version read uninitialised VMEM;
// here the output is defined), `full` does both.  A block takes `wchunk`
// consecutive items; offs and tiles are clamped into range.  `full` and
// `compute` are bitwise equal to the plain version (-fmad=false, the op
// order of :21-25).
//
// What bounds it on the H100: `full` reads 20480 x 68 KB = 1.39 GB from
// random offsets into a 292 MB table (past the 50 MB L2): >= 0.42 ms at
// 3.35 TB/s.  The math is 41 f32 operations per (row, ray), none of
// which pair into an FMA: 13.8 G operations, >= 0.41 ms at the 33.5 T
// single operations/s of the CUDA cores (half the FMA-counted 67
// TFLOP/s).  The two floors are about equal, so `full` is fast only where
// the copy and the math overlap completely.  The design:
// - the copies are TMA bulk copies (cp.async.bulk), issued by one lane of
//   a producer warp and completed on an mbarrier per stage, so they cost
//   the math warps no instructions;
// - a stage is a 32-row chunk of a tile (16 KB); a ring of 6 chunks and
//   2 ray tiles (112 KB with the merge buffer) lets two blocks share an
//   SM, so one block's math runs while the other waits for its first
//   item;
// - 8 math warps: warp pair p takes rows 32p..32p+31 of every item (one
//   chunk), each thread two ray columns (n and n + 64), and walks its
//   rows four at a time: 8 independent chains per thread hide the f32
//   latency of the dependent 33-instruction chain;
// - the four row slices merge per column by one rule, smaller value
//   first, then smaller row: the first argmin.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;    // tile rows (B)
constexpr int kCols = 128;    // tile columns (COLS)
constexpr int kRayN = 128;    // rays per tile (R)
constexpr int kRayC = 8;      // ray tile rows
constexpr int kChunkRows = 32;                       // rows per stage
constexpr int kChunks = kRows / kChunkRows;          // 4 per item
constexpr int kChunkF = kChunkRows * kCols;          // 4096 floats, 16 KB
constexpr int kRayF = kRayC * kRayN;                 // 1024 floats, 4 KB
constexpr int kSlots = 6;                            // chunk ring
constexpr int kRaySlots = 2;                         // ray tile ring
constexpr int kMath = kChunks * 64;                  // 256 math threads
constexpr int kThreads = kMath + 32;                 // + the producer warp

enum Variant { kDma = 0, kCompute = 1, kFull = 2 };

struct Smem {
  float chunk[kSlots][kChunkF];
  float ray[kRaySlots][kRayF];
  float part_t[2][kChunks][kRayN];     // per item parity: each slice's
  int part_i[2][kChunks][kRayN];       // min and argmin per column
  unsigned long long full[kSlots], empty[kSlots];
  unsigned long long ray_full[kRaySlots], ray_empty[kRaySlots];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One thread: copy `bytes` from global `src` to shared `dst` by TMA and
// count them on `bar` (one arrival).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The chain of one tile row against one ray column (compute_block).
__device__ __forceinline__ float chain(const float* row, const float* ray) {
  float acc = row[0] * ray[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    acc = acc + row[i] * ray[i % 8];
    acc = acc * 1.0001f - 0.5f;
    acc = fabsf(acc);
  }
  return acc;
}

// Rows [0, 32) of one chunk (tile rows row0 + r) against the thread's two
// ray columns: the first minimum of each, in (best, arg).
__device__ __forceinline__ void chunk_min(const float* chunk, int row0,
                                          const float (&ray)[2][kRayC],
                                          float (&best)[2], int (&arg)[2]) {
#pragma unroll 4
  for (int r = 0; r < kChunkRows; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(chunk + r * kCols);
    const float4 b = *reinterpret_cast<const float4*>(chunk + r * kCols + 4);
    const float row[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                          chunk[r * kCols + 8]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float acc = chain(row, ray[h]);
      if (r == 0 || acc < best[h]) {
        best[h] = acc;
        arg[h] = row0 + r;
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
tile_sweep_kernel(const int* __restrict__ offs, const int* __restrict__ tiles,
                  int n_items, const float* __restrict__ tri, int n_rows,
                  const float* __restrict__ rays, int n_tiles, int wchunk,
                  float* __restrict__ t_out, int* __restrict__ i_out) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int first = blockIdx.x * wchunk;
  const int n = min(wchunk, n_items - first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (V == kCompute) {
    // The math reads chunk slot p and ray slot 0 for every item.
    for (int j = threadIdx.x; j < kChunks * kChunkF; j += kThreads)
      sm.chunk[j / kChunkF][j % kChunkF] = 0.0f;
    for (int j = threadIdx.x; j < kRayF; j += kThreads) sm.ray[0][j] = 0.0f;
  } else if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 2);                 // the pair's two warps
    }
    for (int s = 0; s < kRaySlots; ++s) {
      bar_init(&sm.ray_full[s], 1);
      bar_init(&sm.ray_empty[s], kMath / 32);    // every math warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kMath / 32) {
    // The producer warp: lane 0 issues item k's ray tile, then its four
    // chunks, each into a slot its consumers have released.
    if (V == kCompute) return;
    for (int k = 0; k < n; ++k) {
      if (lane == 0) {
        const int off = min(max(offs[first + k], 0), n_rows - kRows);
        const int tile = min(max(tiles[first + k], 0), n_tiles - 1);
        const int rs = k % kRaySlots, ru = k / kRaySlots;
        bar_wait(&sm.ray_empty[rs], (ru & 1) ^ 1);
        bulk_load(sm.ray[rs], rays + static_cast<size_t>(tile) * kRayF,
                  kRayF * 4, &sm.ray_full[rs]);
        for (int c = 0; c < kChunks; ++c) {
          const int g = k * kChunks + c, s = g % kSlots, u = g / kSlots;
          bar_wait(&sm.empty[s], (u & 1) ^ 1);
          bulk_load(sm.chunk[s],
                    tri + (static_cast<size_t>(off) + c * kChunkRows) * kCols,
                    kChunkF * 4, &sm.full[s]);
        }
      }
      __syncwarp();
    }
    return;
  }

  // The math warps: pair p = warp / 2 takes chunk p of every item, thread
  // u of the pair ray columns u and u + 64.  Slot s holds chunks s, s + 6,
  // ..., which belong to different pairs, so the pairs must not drift
  // apart by an item (a pair two items ahead would wait on a parity that
  // aliases an older phase): the merge barrier below keeps them in step,
  // in every variant.
  const int p = warp >> 1, u = threadIdx.x & 63;
  for (int k = 0; k < n; ++k) {
    const int rs = k % kRaySlots, ru = k / kRaySlots;
    const int g = k * kChunks + p, s = g % kSlots, su = g / kSlots;
    float ray[2][kRayC];
    float best[2] = {0.0f, 0.0f};
    int arg[2] = {0, 0};
    if (V != kCompute) bar_wait(&sm.ray_full[rs], ru & 1);
    if (V != kDma) {
      const float* ray_slot = sm.ray[V == kCompute ? 0 : rs];
#pragma unroll
      for (int c = 0; c < kRayC; ++c) {
        ray[0][c] = ray_slot[c * kRayN + u];
        ray[1][c] = ray_slot[c * kRayN + u + 64];
      }
    }
    if (V != kCompute) {
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.ray_empty[rs]);
      bar_wait(&sm.full[s], su & 1);
    }
    if (V != kDma) chunk_min(sm.chunk[V == kCompute ? p : s], p * kChunkRows,
                             ray, best, arg);
    if (V != kCompute) {
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);
    }
    const int par = k & 1;
    sm.part_t[par][p][u] = best[0];
    sm.part_i[par][p][u] = arg[0];
    sm.part_t[par][p][u + 64] = best[1];
    sm.part_i[par][p][u + 64] = arg[1];
    // Named barrier 1 over the math warps only.  Item k + 1 writes the
    // other parity; item k + 2 writes this one after the next barrier,
    // which every reader of this one has passed.
    asm volatile("bar.sync 1, %0;\n" :: "n"(kMath) : "memory");
    if (threadIdx.x < kRayN) {
      // The slices in row order: smaller value first, then smaller row.
      const int col = threadIdx.x;
      float t = sm.part_t[par][0][col];
      int i = sm.part_i[par][0][col];
#pragma unroll
      for (int q = 1; q < kChunks; ++q) {
        const float tq = sm.part_t[par][q][col];
        const int iq = sm.part_i[par][q][col];
        if (tq < t || (tq == t && iq < i)) {
          t = tq;
          i = iq;
        }
      }
      const size_t o = static_cast<size_t>(first + k) * kRayN + col;
      t_out[o] = t;
      i_out[o] = i;
    }
  }
}

template <int V>
cudaError_t launch(const int* offs, const int* tiles, int n_items,
                   const float* tri, int n_rows, const float* rays,
                   int n_tiles, int wchunk, float* t_out, int* i_out,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      tile_sweep_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_sweep_kernel<V>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  tile_sweep_kernel<V><<<(n_items + wchunk - 1) / wchunk, kThreads, smem,
                         stream>>>(offs, tiles, n_items, tri, n_rows, rays,
                                   n_tiles, wchunk, t_out, i_out);
  return cudaGetLastError();
}

}  // namespace

// offs, tiles int32 [n_items]; tri f32 [n_rows, 128] (n_rows >= 128);
// rays f32 [n_tiles, 8, 128]; variant 0 dma, 1 compute, 2 full; wchunk
// >= 1 items per block.  Writes t f32 and i int32 [n_items, 128] on
// `stream`.  tri and rays must be 16-byte aligned (TMA).
extern "C" int ugrt_tile_sweep(const void* offs, const void* tiles,
                               int n_items, const void* tri, int n_rows,
                               const void* rays, int n_tiles, int variant,
                               int wchunk, void* t_out, void* i_out,
                               void* stream) {
  if (n_items == 0) return 0;
  if (wchunk < 1 || n_rows < kRows || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* o = static_cast<const int*>(offs);
  const auto* tl = static_cast<const int*>(tiles);
  const auto* tr = static_cast<const float*>(tri);
  const auto* ry = static_cast<const float*>(rays);
  auto* t = static_cast<float*>(t_out);
  auto* i = static_cast<int*>(i_out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDma: return static_cast<int>(launch<kDma>(
        o, tl, n_items, tr, n_rows, ry, n_tiles, wchunk, t, i, st));
    case kCompute: return static_cast<int>(launch<kCompute>(
        o, tl, n_items, tr, n_rows, ry, n_tiles, wchunk, t, i, st));
    case kFull: return static_cast<int>(launch<kFull>(
        o, tl, n_items, tr, n_rows, ry, n_tiles, wchunk, t, i, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
