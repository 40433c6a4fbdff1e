// G1 — the fixed-point segment sum behind gather_rows's backward:
// out[r, c] = sum of values[i, c] over idx[i] == r, with the bits of
// core/gather.py's plain version (kernels/segment_sum.py,
// segment_sum_plain) in any order of summation.
//
// Replaces ugrt's transposes of its row gathers (ugrt/diff/fastgrad.py):
// _face_corners_bwd (:129-156, a sort by face, a prefix sum and CSR
// differences, twice) for the corner gather of trace/refine.py, and
// _rows_bwd (:172-183, a one-hot dot_general at HIGHEST precision) for
// the material gather of shade/shaders.py.  Neither is a Pallas kernel.
// On the flagship step the corner gather sums [3,145,728, 3] into
// 39,030 vertices and the material gather [1,048,576, 6] into 5 rows.
//
// The contract (core/gather.py's docstring):
// - total = sum |v| in f64; exp from frexp(total) (total < 2^exp);
//   shift = 62 - exp;
// - each value becomes round(ldexp((double)v, shift)), half to even, an
//   int64 (__double2ll_rn: the scaling by a power of two is exact);
// - the int64 values are summed per (row, column);
// - out = (float)ldexp((double)acc, -shift): int64 -> f64 rounds to
//   nearest even, the scaling is exact, f64 -> f32 rounds to nearest
//   even; out is NaN (0x7fc00000) everywhere when total is not finite.
// A contribution that rounds to 0 adds nothing, so it may be skipped.
//
// Why the atomics below are exact.  |round(v 2^shift)| <= |v| 2^shift
// + 1/2, and sum |v| 2^shift = total 2^shift < 2^exp 2^(62 - exp) =
// 2^62, so the sum of the magnitudes of all N contributions is below
// 2^62 + N/2 < 2^63: every partial sum of any subset, in any order,
// lies in [-2^63, 2^63), the range of int64.  The kernel adds the
// two's-complement bit patterns as unsigned 64-bit integers, that is
// modulo 2^64; addition modulo 2^64 is associative and commutative, and
// the true sum of each row is an int64, so its residue read back as
// two's complement is that sum whatever the order of the atomics.  The
// same argument covers the warp sums: a lane's pattern is cut into
// unsigned pieces of 22, 22 and 20 bits, 32 lanes sum each piece
// without carry out of 32 bits (32 (2^22 - 1) < 2^27), and a + b 2^22 +
// h 2^44 modulo 2^64 is the sum of the patterns modulo 2^64.
//
// The scale's sum is the one sum in floating point, and its order is
// fixed so that two identical calls pick the same exp: the scale pass's
// grid depends on N * C alone, each thread sums its grid-stride share of
// chunks of 4 values in order (one 16-byte load a chunk where the values
// are 16-byte aligned, four scalar loads where they are not: the same
// partition and the same order either way), then the last N * C mod 4
// values, each block sums its threads by a fixed shuffle tree, and
// the last block to finish (a completion counter) sums the block
// partials by the same tree, whichever block is last.  No f64 atomics.
// It differs from the plain version's torch.sum in order, so the two
// differ only when total lies within its rounding of a power of two.
//
// Bound (the least time on this card): bytes.  Values read once, idx
// once, the output written once: 63.4 MB (0.019 ms at 3.35 TB/s) for the
// corners, 33.6 MB (0.010 ms) for the materials; the operations (a
// product, a conversion and a few integer ops a value) are far below.
//
// Design, three launches after the wrapper's zero fill of the scratch:
// 1. segment_scale_kernel: 16-byte loads of the values (scalar ones if
//    unaligned), f64 |v| sums, block partials, the last block's total.
// 2. segment_accumulate_kernel: each warp walks its own span of
//    consecutive elements, 32 a step, lane i element i, and loads the
//    next 32 (the row and up to kColBlock values a lane) while it sums
//    the current ones.  __match_any_sync groups the lanes that hold the
//    same row (neighbouring pixels share a face, hence its vertices, and
//    mostly a material: 3.17 and 1.03 distinct rows a step on the
//    flagship); each group sums its fixed-point values with
//    __reduce_add_sync on the three pieces, and its leader adds one sum
//    per column that is not zero (the zero Ka columns and the miss
//    pixels' zero cotangents add none) into a table in shared memory:
//    every row when rows * columns fits kSharedEntries (the materials'
//    5 x 6), else a hash table of rows (512 slots at 3 columns in
//    kHashBytes; the flagship's corners touch 96 of 39,030 vertices),
//    whose misses after kProbes slots go to the global accumulator.  A
//    shared addition is two native 32-bit atomics with a carry
//    (add_shared): a 64-bit atomicAdd on shared memory compiles to a
//    compare-and-swap loop for sm_90a (ATOMS.CAST.SPIN.64), which spins
//    when the warps of a block meet the same rows.  At its end each block adds its table into the global
//    accumulator, one 64-bit atomic per non-zero entry.  The second read
//    of the values comes from the 50 MB L2.
// 3. segment_finish_kernel: the accumulator to f32, with the NaN rule.
// What bounds it now (PERF.md §6): the accumulate pass, at 4x the
// bytes' time at the corners: per step a warp's match, 3 reductions a
// column and its leaders' shared atomics, which the warps of a block
// issue on the same few rows.  Global atomics alone (kGlobal, which the
// kernel takes only when fewer than 32 hash slots of the columns fit)
// were 2x slower there (PERF.md §6): 827,610 group sums onto 288
// addresses serialize at the L2.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks of the scale pass at most; also the partials in the scratch
// (kernels/segment_sum.py, PARTIALS).
constexpr int kPartials = 1024;
// rows * columns up to this accumulate in a shared table of every row
// (32 KB); kernels/segment_sum.py, SHARED_ENTRIES.  Larger tables take
// a hash table of at most kHashBytes.
constexpr int kSharedEntries = 4096;
constexpr int kHashBytes = 24 * 1024;
// Values of an element a lane loads beside its row, ahead of its sums.
constexpr int kColBlock = 6;
constexpr int kFracBits = 62;
// Float4 loads per thread of the scale pass, at least (sets its grid).
constexpr int kLoadsPerThread = 4;

// Sum of x over the block by a fixed tree; the result is in thread 0.
__device__ double block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// total = sum |v| over the m values, in the fixed order above.
__global__ void __launch_bounds__(kThreads)
segment_scale_kernel(const float* __restrict__ v, long long m,
                     double* __restrict__ partials,
                     unsigned* __restrict__ counter,
                     double* __restrict__ total) {
  __shared__ double red[kWarps];
  __shared__ bool last;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  double s = 0.0;
  const long long m4 = m / 4;
  if ((reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (long long i = t; i < m4; i += stride) {
      const float4 q = __ldg(v4 + i);
      s += fabs(static_cast<double>(q.x));
      s += fabs(static_cast<double>(q.y));
      s += fabs(static_cast<double>(q.z));
      s += fabs(static_cast<double>(q.w));
    }
  } else {
    for (long long i = t; i < m4; i += stride) {
      s += fabs(static_cast<double>(__ldg(v + 4 * i)));
      s += fabs(static_cast<double>(__ldg(v + 4 * i + 1)));
      s += fabs(static_cast<double>(__ldg(v + 4 * i + 2)));
      s += fabs(static_cast<double>(__ldg(v + 4 * i + 3)));
    }
  }
  for (long long i = m4 * 4 + t; i < m; i += stride)
    s += fabs(static_cast<double>(__ldg(v + i)));
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double p = 0.0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    p += __ldcg(partials + i);
  p = block_sum(p, red);
  if (threadIdx.x == 0) *total = p;
}

// Where segment_accumulate_kernel's warp leaders add their group sums,
// picked from the shapes by ugrt_segment_sum: a table of rows * cols in
// shared memory (kDirect, rows * cols <= kSharedEntries), a hash table of
// `slots` rows in shared memory, keyed by row, whose misses go to the
// global accumulator (kHashed), or, for rows too wide for 32 hash slots
// (more than 95 columns), the global accumulator alone (kGlobal).  The
// shared tables are added into the global one when the block ends.
enum Mode { kDirect = 0, kHashed = 1, kGlobal = 2 };
constexpr unsigned kEmpty = 0xffffffffu;   // a free hash slot
constexpr int kProbes = 8;                 // slots tried before global

// A lane's element: its row (-1 past the end) and its first kColBlock
// values (0 past `cols`).
struct Element {
  long long r;
  float x[kColBlock];
};

__device__ __forceinline__ Element load_element(
    const float* __restrict__ v, const long long* __restrict__ idx,
    long long n, int cols, long long i) {
  Element e;
  const bool in = i < n;
  e.r = in ? __ldg(idx + i) : -1;
#pragma unroll
  for (int k = 0; k < kColBlock; ++k)
    e.x[k] = in && k < cols ? __ldg(v + i * cols + k) : 0.0f;
  return e;
}

// The group sum of one column: the lanes of `group` add their
// fixed-point values, as unsigned pieces of 22, 22 and 20 bits.
__device__ __forceinline__ unsigned long long group_sum(unsigned group,
                                                        bool ok, float x,
                                                        double scale) {
  const unsigned long long u = static_cast<unsigned long long>(
      ok ? __double2ll_rn(static_cast<double>(x) * scale) : 0ll);
  const unsigned a = __reduce_add_sync(group,
                                       static_cast<unsigned>(u & 0x3fffff));
  const unsigned b = __reduce_add_sync(
      group, static_cast<unsigned>((u >> 22) & 0x3fffff));
  const unsigned h = __reduce_add_sync(group, static_cast<unsigned>(u >> 44));
  return a + (static_cast<unsigned long long>(b) << 22) +
         (static_cast<unsigned long long>(h) << 44);
}

// *p += s modulo 2^64 for a word of shared memory, by two native 32-bit
// atomics: the low word's atomic returns its old value, which shows
// whether this addition carried out of it, and the carry goes into the
// high word with s's own high half.  Every carry out of the low word is
// seen by the one atomic that made it, so the two words hold the sum
// modulo 2^64 once all have been added.  (A 64-bit atomicAdd on shared
// memory is a compare-and-swap loop, which spins when the warps of a
// block add to the same rows.)
__device__ __forceinline__ void add_shared(unsigned long long* p,
                                           unsigned long long s) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(s);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = static_cast<unsigned>(s >> 32) + (old + lo < old);
  if (hi != 0) atomicAdd(w + 1, hi);
}

// *p += s modulo 2^64, in shared memory or in the global accumulator.
__device__ __forceinline__ void add(unsigned long long* p,
                                    unsigned long long s, bool shared) {
  if (shared)
    add_shared(p, s);
  else
    atomicAdd(p, s);
}

// The fixed-point values of n elements of `cols` columns summed into
// acc[rows * cols] (unsigned patterns of int64).  Each warp walks its
// own span of consecutive elements, 32 a step (neighbouring pixels: the
// warps of a block meet other rows), and loads its next 32 elements
// while it sums the current ones.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
segment_accumulate_kernel(const float* __restrict__ v,
                          const long long* __restrict__ idx, long long n,
                          int rows, int cols, int slots,
                          const double* __restrict__ total,
                          unsigned long long* __restrict__ acc) {
  // Static, not dynamic, shared memory: each table's most.
  __shared__ unsigned long long table[kMode == kDirect   ? kSharedEntries
                                      : kMode == kHashed ? kHashBytes / 8
                                                         : 1];
  unsigned* keys = reinterpret_cast<unsigned*>(table + slots * cols);
  const double tot = *total;
  if (!isfinite(tot)) return;        // segment_finish_kernel writes NaN
  int exp;
  frexp(tot, &exp);
  const double scale = ldexp(1.0, kFracBits - exp);
  const int entries = (kMode == kDirect ? rows : slots) * cols;
  if (kMode != kGlobal) {
    for (int e = threadIdx.x; e < entries; e += kThreads) table[e] = 0;
    if (kMode == kHashed)
      for (int e = threadIdx.x; e < slots; e += kThreads) keys[e] = kEmpty;
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long span = (n + warps * 32 - 1) / (warps * 32) * 32;
  long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * span;
  const long long end = base + span < n ? base + span : n;
  Element cur = load_element(v, idx, end, cols, base + lane);
  for (; base < end; base += 32) {
    const Element next = load_element(v, idx, end, cols, base + 32 + lane);
    const long long i = base + lane, r = cur.r;
    const bool ok = r >= 0 && r < rows;
    const unsigned group = __match_any_sync(
        0xffffffffu, ok ? static_cast<unsigned long long>(r) : ~0ull);
    const bool leader = __ffs(group) - 1 == lane;
    unsigned long long* dst = acc + r * cols;
    bool shared = kMode == kDirect;
    if (kMode == kDirect) dst = table + r * cols;
    if (kMode == kHashed && leader && ok) {
      unsigned s = static_cast<unsigned>(r) & (slots - 1);
      for (int p = 0; p < kProbes; ++p) {
        const unsigned old = atomicCAS(keys + s, kEmpty,
                                       static_cast<unsigned>(r));
        if (old == kEmpty || old == static_cast<unsigned>(r)) {
          dst = table + s * cols;
          shared = true;
          break;
        }
        s = (s + 1) & (slots - 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) {
      if (k >= cols) break;
      const unsigned long long sum = group_sum(group, ok, cur.x[k], scale);
      if (leader && ok && sum != 0) add(dst + k, sum, shared);
    }
    // Columns past the first kColBlock: loaded here, one at a time.
    for (int c = kColBlock; c < cols; ++c) {
      const float x = i < end ? __ldg(v + i * cols + c) : 0.0f;
      const unsigned long long sum = group_sum(group, ok, x, scale);
      if (leader && ok && sum != 0) add(dst + c, sum, shared);
    }
    cur = next;
  }
  if (kMode != kGlobal) {
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += kThreads) {
      if (table[e] == 0) continue;
      const long long row = kMode == kDirect ? e / cols : keys[e / cols];
      atomicAdd(acc + row * cols + e % cols, table[e]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_finish_kernel(const long long* __restrict__ acc, int entries,
                      const double* __restrict__ total,
                      float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= entries) return;
  const double tot = *total;
  if (!isfinite(tot)) {
    out[e] = __int_as_float(0x7fc00000);
    return;
  }
  int exp;
  frexp(tot, &exp);
  out[e] = __double2float_rn(__ll2double_rn(acc[e]) *
                             ldexp(1.0, exp - kFracBits));
}

}  // namespace

// values [n, cols] f32, idx [n] int64 (rows outside [0, rows) add
// nothing), out [rows, cols] f32; scratch: rows * cols + 2 + kPartials
// int64, zeroed (the accumulator, the completion counter, the total,
// the block partials).  `grid`: the accumulate pass's blocks.
extern "C" int ugrt_segment_sum(const void* values, const void* idx,
                                long long n, int rows, int cols,
                                void* scratch, void* out, int grid,
                                void* stream) {
  const int entries = rows * cols;
  if (entries == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* base = static_cast<long long*>(scratch);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(base);
  unsigned* counter = reinterpret_cast<unsigned*>(base + entries);
  double* total = reinterpret_cast<double*>(base + entries + 1);
  double* partials = reinterpret_cast<double*>(base + entries + 2);
  const float* v = static_cast<const float*>(values);
  const long long* ix = static_cast<const long long*>(idx);
  const long long m = n * cols;
  const long long per_block = static_cast<long long>(kThreads) * 4 *
                              kLoadsPerThread;
  long long blocks = (m + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > kPartials ? kPartials : blocks);
  segment_scale_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      v, m, partials, counter, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The hash table: the most slots (a power of two) within kHashBytes.
  int slots = 1;
  while (slots * 2 * (8 * cols + 4) <= kHashBytes) slots *= 2;
  const Mode mode = entries <= kSharedEntries ? kDirect
                    : slots >= 32            ? kHashed
                                             : kGlobal;
  if (grid < 1) grid = 1;
  if (mode == kDirect) {
    segment_accumulate_kernel<kDirect><<<grid, kThreads, 0, s>>>(
        v, ix, n, rows, cols, 0, total, acc);
  } else if (mode == kHashed) {
    segment_accumulate_kernel<kHashed><<<grid, kThreads, 0, s>>>(
        v, ix, n, rows, cols, slots, total, acc);
  } else {
    segment_accumulate_kernel<kGlobal><<<grid, kThreads, 0, s>>>(
        v, ix, n, rows, cols, 0, total, acc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_finish_kernel<<<(entries + kThreads - 1) / kThreads, kThreads, 0,
                          s>>>(base, entries, total,
                               static_cast<float*>(out));
  return cudaGetLastError();
}
