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
// tie rule) to t[k][n], i[k][n].  Variants: `dma` copies and writes
// zeros, `compute` runs the math on zero-filled buffers and copies
// nothing (the TPU version read uninitialised VMEM; here the output is
// defined), `full` does both.  One block of 128 threads (a thread per ray
// column) takes `wchunk` consecutive items; the copies are double-
// buffered with 16-byte cp.async, so item k + 1 loads while item k
// computes: 2 x (64 KB + 4 KB) = 136 KB of dynamic shared memory, opted
// in with cudaFuncSetAttribute.  offs and tiles are clamped into range.
// `full` and `compute` are bitwise equal to the plain version
// (-fmad=false, the op order of :21-25).
//
// What bounds it on the H100: `full` reads 20480 x 68 KB = 1.39 GB from
// random offsets into a 292 MB table (past the 50 MB L2): >= 0.42 ms at
// 3.35 TB/s.  The math is 41 f32 operations per (row, ray), none of
// which pair into an FMA: 13.8 G operations, >= 0.41 ms at the 33.5 T
// single operations/s of the CUDA cores (half the FMA-counted 67
// TFLOP/s).  The two floors are about equal, so the three variants show
// which one binds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;    // tile rows (B)
constexpr int kCols = 128;    // tile columns (COLS)
constexpr int kRayN = 128;    // rays per tile (R): one thread each
constexpr int kRayC = 8;      // ray tile rows
constexpr int kTileF = kRows * kCols;            // floats per tri tile
constexpr int kStageF = kTileF + kRayC * kRayN;  // floats per stage
constexpr int kStageBytes = kStageF * 4;         // 69,632

enum Variant { kDma = 0, kCompute = 1, kFull = 2 };

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start the copies of item k's tri tile and ray tile into one stage.
__device__ __forceinline__ void start_item(float* stage, const float* tri,
                                           int off, const float* rays,
                                           int tile) {
  const float* t = tri + static_cast<size_t>(off) * kCols;
  const float* r = rays + static_cast<size_t>(tile) * kRayC * kRayN;
  for (int j = threadIdx.x; j < kTileF / 4; j += kRayN)
    cp_async16(stage + 4 * j, t + 4 * j);
  for (int j = threadIdx.x; j < kRayC * kRayN / 4; j += kRayN)
    cp_async16(stage + kTileF + 4 * j, r + 4 * j);
  cp_async_commit();
}

// compute_block for ray column threadIdx.x of one stage.
__device__ __forceinline__ void compute_column(const float* stage,
                                               float* t_min, int* i_min) {
  const int n = threadIdx.x;
  float ray[kRayC];
#pragma unroll
  for (int c = 0; c < kRayC; ++c) ray[c] = stage[kTileF + c * kRayN + n];
  float best = 0.0f;
  int arg = 0;
  for (int r = 0; r < kRows; ++r) {
    const float* row = stage + r * kCols;        // broadcast reads
    float acc = row[0] * ray[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      acc = acc + row[i] * ray[i % 8];
      acc = acc * 1.0001f - 0.5f;
      acc = fabsf(acc);
    }
    if (r == 0 || acc < best) {
      best = acc;
      arg = r;
    }
  }
  *t_min = best;
  *i_min = arg;
}

template <int V>
__global__ void __launch_bounds__(kRayN)
tile_sweep_kernel(const int* __restrict__ offs, const int* __restrict__ tiles,
                  int n_items, const float* __restrict__ tri, int n_rows,
                  const float* __restrict__ rays, int n_tiles, int wchunk,
                  float* __restrict__ t_out, int* __restrict__ i_out) {
  extern __shared__ float4 smem4[];
  float* const stages = reinterpret_cast<float*>(smem4);   // 2 x kStageF
  const int first = blockIdx.x * wchunk;
  const int n = min(wchunk, n_items - first);
  auto off_of = [&](int k) {
    return min(max(offs[first + k], 0), n_rows - kRows);
  };
  auto tile_of = [&](int k) {
    return min(max(tiles[first + k], 0), n_tiles - 1);
  };

  if (V == kCompute) {
    for (int j = threadIdx.x; j < 2 * kStageF / 4; j += kRayN)
      smem4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  } else {
    start_item(stages, tri, off_of(0), rays, tile_of(0));
  }
  for (int k = 0; k < n; ++k) {
    const float* cur = stages + (k & 1) * kStageF;
    if (V != kCompute) {
      if (k + 1 < n) {
        start_item(stages + ((k + 1) & 1) * kStageF, tri, off_of(k + 1),
                   rays, tile_of(k + 1));
        cp_async_wait<1>();                        // item k has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    float t = 0.0f;
    int i = 0;
    if (V != kDma) compute_column(cur, &t, &i);
    const size_t o = static_cast<size_t>(first + k) * kRayN + threadIdx.x;
    t_out[o] = t;
    i_out[o] = i;
    // Every thread is done with `cur` before item k + 2 overwrites it.
    if (V != kCompute) __syncthreads();
  }
}

template <int V>
cudaError_t launch(const int* offs, const int* tiles, int n_items,
                   const float* tri, int n_rows, const float* rays,
                   int n_tiles, int wchunk, float* t_out, int* i_out,
                   cudaStream_t stream) {
  const int smem = 2 * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sweep_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  tile_sweep_kernel<V><<<(n_items + wchunk - 1) / wchunk, kRayN, smem,
                         stream>>>(offs, tiles, n_items, tri, n_rows, rays,
                                   n_tiles, wchunk, t_out, i_out);
  return cudaGetLastError();
}

}  // namespace

// offs, tiles int32 [n_items]; tri f32 [n_rows, 128] (n_rows >= 128);
// rays f32 [n_tiles, 8, 128]; variant 0 dma, 1 compute, 2 full; wchunk
// >= 1 items per block.  Writes t f32 and i int32 [n_items, 128] on
// `stream`.  tri and rays must be 16-byte aligned.
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
