// G1 — the fixed-point segment sums behind the step's gathers, with the
// bits of core/gather.py's plain versions (kernels/segment_sum.py) in
// any order of summation:
// - ugrt_face_corner_sum, the backward of gather_face_corners /
//   gather_face_data (trace/refine.py): out[v, c] = the sum over pixels
//   p and corners j with faces[fid[p], j] == v of values[p, 3 j + c];
// - ugrt_segment_sum, the backward of gather_rows (the material gather
//   of shade/shaders.py): out[r, c] = sum of values[i, c] over
//   idx[i] == r.
//
// Replaces ugrt's transposes of its gathers (ugrt/diff/fastgrad.py):
// _face_corners_bwd (:129-156, a sort by face, a prefix sum and CSR
// differences, then the same at 3F rows onto the vertices) and
// _rows_bwd (:172-183, a one-hot dot_general at HIGHEST precision).
// Neither is a Pallas kernel.  On the flagship step the corner sum takes
// [1,048,576, 9] cotangents keyed by face into 39,030 vertices, the
// material sum [1,048,576, 6] into 5 rows.
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
// The face-keyed sum is the row sum of values.reshape(-1, 3) keyed by
// faces[fid].reshape(-1): the same multiset of rounded values reaches
// each (vertex, column), so the same integer sum, whatever the grouping.
//
// Why the sums below are exact.  |round(v 2^shift)| <= |v| 2^shift +
// 1/2, and sum |v| 2^shift = total 2^shift < 2^exp 2^(62 - exp) = 2^62,
// so the sum of the magnitudes of all N contributions is below 2^62 +
// N/2 < 2^63: the true sum of each (row, column) is an int64.  The
// kernel adds two's-complement bit patterns as unsigned 64-bit integers,
// that is modulo 2^64, in registers, in warp reductions, in shared
// tables and in the global accumulator; addition modulo 2^64 is
// associative and commutative, so each row's residue read back as two's
// complement is its true sum whatever the order and the grouping.  A
// lane's carried sum is itself such a pattern.  The warp reductions cut
// a pattern into unsigned pieces of 22, 22 and 20 bits; 32 lanes sum
// each piece without carry out of 32 bits (32 (2^22 - 1) < 2^27), and a
// + b 2^22 + h 2^44 modulo 2^64 is the sum of the patterns modulo 2^64.
//
// The scale's sum is the one sum in floating point, and its order is
// fixed so that two identical calls pick the same exp: the scale pass's
// grid depends on N * C alone, each thread sums its grid-stride share of
// chunks of 4 values in order (one 16-byte load a chunk where the values
// are 16-byte aligned, four scalar loads where they are not: the same
// partition and the same order either way), then the last N * C mod 4
// values, and each block sums its threads by a fixed shuffle tree into
// its partial.  Every block of the accumulate pass then sums the same
// partials by the same tree (block_total), so each block holds the same
// total's bits; its block 0 stores it for the finish pass.  No f64
// atomics.  It differs from the plain version's torch.sum in order, so
// the two differ only when total lies within its rounding of a power of
// two.
//
// Bound (the least time on this card): bytes.  Values read once, the
// keys once (and the vertex ids of the faces that occur: 141 faces,
// 1.7 KB, on the flagship step), the output written once: 37.75 + 4.19
// + 0.47 MB = 42.4 MB (0.0127 ms at 3.35 TB/s) at the corners, 25.2 +
// 4.19 MB = 29.4 MB (0.0088 ms) at the materials; the operations (a
// product, a conversion and a few integer ops a value) are far below.
//
// Design, three launches, no fill:
// 1. segment_scale_kernel: 16-byte loads of the values (scalar ones if
//    unaligned), f64 |v| sums, one partial a block; its threads also
//    zero the accumulator.
// 2. face_accumulate_kernel / row_accumulate_kernel: each warp walks its
//    own span of consecutive elements (pixels), 32 a step, lane i
//    element i.  A step's keys and values come into a ring of kStages
//    slots in shared memory by 4-byte cp.async copies, kStages - 1 steps
//    ahead (the warp's rows are contiguous, so the copies are
//    coalesced); the first ones go out before the block has its total.
//    A warp carries a key (face, or row) from step to step: the lanes
//    that hold it add their fixed-point values to their own registers,
//    with no communication and no atomic.  Neighbouring pixels share a
//    face for long runs, so most steps end there.  A step with another
//    key moves the carry to its last lane's key (the key most likely to
//    go on into the next step): the old carry is reduce-scattered over
//    the warp by 64-bit shuffles (12 for a face's 9 columns; three
//    __reduce_add_sync a column were 2x slower at the corners), so that
//    each column's total lands in one lane, and those lanes add them
//    into the block's table in shared memory, in the slot lane 0 finds.
//    The lanes of any third key are grouped by a 32-bit
//    __match_any_sync and each group's sums (__reduce_add_sync on
//    pieces) are added at once, one column a lane.  Shared atomics
//    happen at flushes only (two native 32-bit atomics with a carry,
//    add_shared).  Rows of 9 (faces) and 6 (materials) columns take
//    kernels built for their width; others a generic one.  The table
//    is keyed by the carried key, dynamic shared memory of the size the
//    shapes need: every key when keys * columns fits kSharedEntries (the
//    materials' 5 x 6), else a hash table of keys (128 face slots of 9
//    columns in kHashBytes), whose misses after kProbes slots go
//    straight to the global accumulator.  At its end each block adds its
//    table into the global accumulator, one 64-bit atomic per non-zero
//    entry; a face's entry goes to its three vertices (a degenerate face
//    that repeats a vertex adds into that row more than once, still
//    exact).  The second read of the values comes from the 50 MB L2.
// 3. segment_finish_kernel: the accumulator to f32, with the NaN rule.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks of the accumulate pass an SM, all resident at once
// (kernels/segment_sum.py, BLOCKS_PER_SM): 128 registers a thread, so
// that a lane's carry and its step's values never spill.
constexpr int kBlocksPerSM = 2;
// Blocks of the scale pass at most; also the partials in the scratch
// (kernels/segment_sum.py, PARTIALS).
constexpr int kPartials = 1024;
// keys * columns up to this accumulate in a shared table of every key
// (16 KB at most); kernels/segment_sum.py, SHARED_ENTRIES.  Larger tables
// take a hash table of at most kHashBytes.  Both are dynamic shared
// memory of the size the shapes need, beside the warps' rings (30 KB):
// under 48 KB a block.
constexpr int kSharedEntries = 2048;
constexpr int kHashBytes = 16 * 1024;
// Steps a warp has in flight: its ring of cp.async slots.
constexpr int kStages = 3;
// Columns a lane carries in registers (a face's 9); wider rows go in
// blocks of kMaxCols columns, one walk of the span each.  Rows of
// kMaxCols (the faces) and of kMaterialCols (the materials) take kernels
// built for their width.
constexpr int kMaxCols = 9;
constexpr int kMaterialCols = 6;
constexpr int kFracBits = 62;
// Float4 loads per thread of the scale pass, at least (sets its grid).
constexpr int kLoadsPerThread = 4;
constexpr unsigned kFull = 0xffffffffu;

// Sum of x over the block by a fixed tree; the result is in thread 0.
__device__ double block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  }
  return x;
}

// total = sum |v| over the m values, in the fixed order above: one
// partial a block.  The threads also zero acc[entries].
__global__ void __launch_bounds__(kThreads)
segment_scale_kernel(const float* __restrict__ v, long long m,
                     double* __restrict__ partials,
                     unsigned long long* __restrict__ acc, int entries) {
  __shared__ double red[kWarps];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (long long e = t; e < entries; e += stride) acc[e] = 0;
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
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// The sum of the scale pass's partials by the same tree in every block:
// every thread gets the same bits.
__device__ double block_total(const double* __restrict__ partials,
                              int count, double* red, double* out) {
  double p = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) p += partials[i];
  p = block_sum(p, red);
  if (threadIdx.x == 0) *out = p;
  __syncthreads();
  return *out;
}

// Where a flush adds a key's sums: a table of every key (kDirect, keys *
// cols <= kSharedEntries), a hash table of `slots` keys whose misses go
// to the global accumulator (kHashed), or, for rows too wide for 32
// hash slots (more than kWideCols columns), the global accumulator
// alone (kGlobal).  Picked from the shapes by run().  The tables are
// dynamic shared memory of the size they need (run()'s `bytes`).
enum Mode { kDirect = 0, kHashed = 1, kGlobal = 2 };
constexpr unsigned kEmpty = 0xffffffffu;   // a free hash slot
constexpr int kProbes = 8;                 // slots tried before global
// The widest rows that have 32 hash slots in kHashBytes (run()'s
// sizing); only the generic kernel takes wider ones, so only it is
// built for kGlobal.
constexpr int kWideCols = 63;
static_assert(32 * (8 * kWideCols + 4) <= kHashBytes &&
                  32 * (8 * (kWideCols + 1) + 4) > kHashBytes,
              "kWideCols is the widest row with 32 hash slots");
static_assert(kMaxCols <= kWideCols && kMaterialCols <= kWideCols,
              "the face and material kernels are built without kGlobal");

// *p += s modulo 2^64 for a word of shared memory, by two native 32-bit
// atomics: the low word's atomic returns its old value, which shows
// whether this addition carried out of it, and the carry goes into the
// high word with s's own high half.  Every carry out of the low word is
// seen by the one atomic that made it, so the two words hold the sum
// modulo 2^64 once all have been added.  (A 64-bit atomicAdd on shared
// memory is a compare-and-swap loop for sm_90a.)
__device__ __forceinline__ void add_shared(unsigned long long* p,
                                           unsigned long long s) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(s);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = static_cast<unsigned>(s >> 32) + (old + lo < old);
  if (hi != 0) atomicAdd(w + 1, hi);
}

// The sum over `group` of one column's patterns, as unsigned pieces of
// 22, 22 and 20 bits.
__device__ __forceinline__ unsigned long long group_sum(
    unsigned group, unsigned long long u) {
  const unsigned a = __reduce_add_sync(group,
                                       static_cast<unsigned>(u & 0x3fffff));
  const unsigned b = __reduce_add_sync(
      group, static_cast<unsigned>((u >> 22) & 0x3fffff));
  const unsigned h = __reduce_add_sync(group, static_cast<unsigned>(u >> 44));
  return a + (static_cast<unsigned long long>(b) << 22) +
         (static_cast<unsigned long long>(h) << 44);
}

// The keyed sums of one kernel: rows of `cols` columns keyed by idx
// (kFace false), or pixels of 9 columns keyed by face, each face's
// column 3 j + c bound for vertex faces[3 f + j], column c (kFace true).
template <bool kFace>
struct Keyed {
  const float* v;
  const int* key;                  // idx or fid
  const int* faces;                // kFace: [keys, 3]
  long long n;
  int cols;                        // columns of a value row
  int keys;                        // rows, or faces
  int rows;                        // rows of the output
  unsigned long long* acc;

  // The global entry of column c of key k, or -1 (a face's vertex
  // outside [0, rows) adds nothing).
  __device__ __forceinline__ long long dest(int k, int c) const {
    if (!kFace) return static_cast<long long>(k) * cols + c;
    const int vtx = __ldg(faces + 3 * k + c / 3);
    return vtx >= 0 && vtx < rows ? static_cast<long long>(vtx) * 3 + c % 3
                                  : -1;
  }
};

// A 4-byte cp.async (global -> shared, through L1), zero-filled when
// `ok` is false (then nothing is read).
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most kStages - 1 groups of this thread are in flight.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// One slot of a warp's ring: a step's keys and its values, kMaxCols
// words an element at most.
struct Slot {
  int key[32];
  float v[32 * kMaxCols];
};

// Issues the copies of step `b` (elements b .. b + 31, columns c0 .. c0 +
// kb) into `slot`; element e's column t lands at e * kb + t.  With the
// width kCols known at compile time (or `whole`, cols <= kMaxCols) the
// 32 rows are contiguous and lane j copies words t 32 + j of them
// (coalesced); a full step needs no bounds.  Wider rows (kCols 0, cols
// > kMaxCols): lane j copies its own element's kb values.
template <int kCols, bool kFace>
__device__ __forceinline__ void issue_step(const Keyed<kFace>& s, Slot* slot,
                                           long long end, bool whole, int c0,
                                           int kb, long long b, int lane) {
  if constexpr (kCols > 0) {
    const float* src = s.v + b * kCols;
    const int* ksrc = s.key + b;
    if (b + 32 <= end) {
      copy4(slot->key + lane, ksrc + lane, true);
#pragma unroll
      for (int t = 0; t < kCols; ++t)
        copy4(slot->v + 32 * t + lane, src + 32 * t + lane, true);
    } else {
      const int m = b < end ? static_cast<int>(end - b) : 0;
      copy4(slot->key + lane, lane < m ? ksrc + lane : s.key, lane < m);
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int w = 32 * t + lane;
        copy4(slot->v + w, w < m * kCols ? src + w : s.v, w < m * kCols);
      }
    }
  } else {
    const long long i = b + lane;
    copy4(slot->key + lane, i < end ? s.key + i : s.key, i < end);
    if (whole) {
      const long long first = b * s.cols, last = end * s.cols;
#pragma unroll
      for (int t = 0; t < kMaxCols; ++t) {
        const long long e = first + 32 * t + lane;
        if (t < s.cols)
          copy4(slot->v + 32 * t + lane, e < last ? s.v + e : s.v, e < last);
      }
    } else {
#pragma unroll
      for (int t = 0; t < kMaxCols; ++t)
        if (t < kb)
          copy4(slot->v + lane * kb + t,
                i < end ? s.v + i * s.cols + c0 + t : s.v, i < end);
    }
  }
  copy_commit();
}

// Lane value x of column t as its fixed-point pattern (0 for a lane
// without a key and past the kb columns of the block).
__device__ __forceinline__ unsigned long long fixed(int k, int t, int kb,
                                                    float x, double scale) {
  return static_cast<unsigned long long>(
      k >= 0 && t < kb ? __double2ll_rn(static_cast<double>(x) * scale)
                       : 0ll);
}

// The slot of key k in the block's table (kDirect: the key itself;
// kHashed: found by probing `hkeys`, claimed if free), or -1: a hash
// miss after kProbes slots, or kGlobal.
template <int kMode>
__device__ __forceinline__ int table_slot(unsigned* hkeys, int slots,
                                          int k) {
  if (kMode == kDirect) return k;
  if (kMode == kHashed) {
    unsigned slot = static_cast<unsigned>(k) & (slots - 1);
    for (int p = 0; p < kProbes; ++p) {
      const unsigned old = atomicCAS(hkeys + slot, kEmpty,
                                     static_cast<unsigned>(k));
      if (old == kEmpty || old == static_cast<unsigned>(k))
        return static_cast<int>(slot);
      slot = (slot + 1) & (slots - 1);
    }
  }
  return -1;
}

// Flushes key k's sums over `group` (the lanes' patterns a, columns c0
// .. c0 + kb of the kW a lane holds) into the block's table, or for a miss into the global
// accumulator.  Every lane of the warp calls it with its own group; a
// group of key -1 adds nothing.  The leader (the group's lowest lane)
// finds the slot, and the group's lanes share the columns' additions:
// the lane of rank r in a group of g adds columns r, r + g, ...
template <bool kFace, int kMode, int kW>
__device__ __forceinline__ void flush_group(const Keyed<kFace>& s,
                                            unsigned long long* table,
                                            unsigned* hkeys, int slots,
                                            unsigned group, int k, int c0,
                                            int kb,
                                            const unsigned long long* a,
                                            int lane) {
  unsigned long long sums[kW];
#pragma unroll
  for (int t = 0; t < kW; ++t)
    sums[t] = t < kb ? group_sum(group, a[t]) : 0ull;
  const int leader = __ffs(group) - 1;
  int slot = -1;
  if (k >= 0 && lane == leader) slot = table_slot<kMode>(hkeys, slots, k);
  slot = __shfl_sync(group, slot, leader);
  if (k < 0) return;
  const int g = __popc(group);
  const int rank = __popc(group & ((1u << lane) - 1));
  int owner = 0;                       // the rank that adds column t
#pragma unroll
  for (int t = 0; t < kW; ++t) {
    if (t < kb && owner == rank && sums[t] != 0) {
      if (slot >= 0) {
        add_shared(table + static_cast<long long>(slot) * s.cols + c0 + t,
                   sums[t]);
      } else {
        const long long d = s.dest(k, c0 + t);
        if (d >= 0) atomicAdd(s.acc + d, sums[t]);
      }
    }
    owner = owner + 1 == g ? 0 : owner + 1;
  }
}

// One step of the warp's reduce-scatter over lane bit kM: the kN slots
// of w split in two halves, the lanes with the bit clear keep the first
// ceil(kN / 2) and the others the rest (moved down to slot 0), and each
// lane adds its partner's copy of the half it keeps (a 64-bit shuffle
// each; addition modulo 2^64).  An odd split leaves the upper lanes a
// last slot that stands for no column, and it holds 0.
template <int kN, int kM>
__device__ __forceinline__ void halve(unsigned long long* w, int lane) {
  constexpr int kN1 = (kN + 1) / 2, kN2 = kN - kN1;
  const bool up = (lane & kM) != 0;
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const unsigned long long high = i < kN2 ? w[kN1 + i] : 0ull;
    const unsigned long long send = up ? w[i] : high;
    const unsigned long long keep = up ? high : w[i];
    w[i] = keep + __shfl_xor_sync(kFull, send, kM);
  }
}

// The sums over the warp of each lane's kW patterns w, reduce-scattered:
// after five halvings (8 slot-shuffles for kW = 6, 12 for kW = 9) one
// lane holds column c's total in w[0] for each c < kW; returns this
// lane's column, or -1.
template <int kW>
__device__ __forceinline__ int reduce_scatter(unsigned long long* w,
                                              int lane) {
  constexpr int kN1 = (kW + 1) / 2, kN2 = (kN1 + 1) / 2,
                kN3 = (kN2 + 1) / 2, kN4 = (kN3 + 1) / 2;
  halve<kW, 16>(w, lane);
  halve<kN1, 8>(w, lane);
  halve<kN2, 4>(w, lane);
  halve<kN3, 2>(w, lane);
  halve<kN4, 1>(w, lane);
  int col = 0, real = kW, n = kW;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const int n1 = (n + 1) / 2;
    if (lane & m) {
      col += n1;
      real = real > n1 ? real - n1 : 0;
    } else {
      real = real < n1 ? real : n1;
    }
    n = n1;
  }
  return real > 0 ? col : -1;
}

// Flushes the warp's carried key k: the lanes' kW patterns a (columns c0
// .. c0 + kb) reduce-scattered over the warp, lane 0 finds the key's
// slot, and each column's lane adds its total.  Clobbers a.
template <bool kFace, int kMode, int kW>
__device__ __forceinline__ void flush_carry(const Keyed<kFace>& s,
                                            unsigned long long* table,
                                            unsigned* hkeys, int slots, int k,
                                            int c0, int kb,
                                            unsigned long long* a, int lane) {
  const int col = reduce_scatter<kW>(a, lane);
  int slot = lane == 0 ? table_slot<kMode>(hkeys, slots, k) : 0;
  slot = __shfl_sync(kFull, slot, 0);
  if (col < 0 || col >= kb || a[0] == 0) return;
  if (slot >= 0) {
    add_shared(table + static_cast<long long>(slot) * s.cols + c0 + col,
               a[0]);
  } else {
    const long long d = s.dest(k, c0 + col);
    if (d >= 0) atomicAdd(s.acc + d, a[0]);
  }
}

// The accumulate pass (the design above).  Every block sums the scale
// pass's partials itself; block 0 stores the total for the finish pass.
// kCols: the row width when known at compile time (the corners' 9, the
// materials' 6), else 0, and then rows wider than kMaxCols go in blocks
// of kMaxCols columns, one walk of the span each.
template <bool kFace, int kMode, int kCols>
__device__ __forceinline__ void accumulate(const Keyed<kFace>& s, int slots,
                                           const double* __restrict__ partials,
                                           int nparts,
                                           double* __restrict__ total) {
  extern __shared__ unsigned long long table[];
  __shared__ Slot ring[kWarps][kStages];
  __shared__ double red[kWarps];
  __shared__ double tot_s;
  unsigned* hkeys = reinterpret_cast<unsigned*>(table + slots * s.cols);
  const int lane = threadIdx.x % 32;
  Slot* const mine = ring[threadIdx.x / 32];
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long span = (s.n + warps * 32 - 1) / (warps * 32) * 32;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
      span;
  const long long end = base + span < s.n ? base + span : s.n;
  constexpr int kW = kCols > 0 ? kCols : kMaxCols;   // values a lane holds
  const int cols = kCols > 0 ? kCols : s.cols;
  const bool whole = cols <= kMaxCols;
  // The first steps' copies go out before the total is known.
  int kb = cols < kW ? cols : kW;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    issue_step<kCols>(s, mine + p, end, whole, 0, kb, base + 32 * p, lane);
  const double tot = block_total(partials, nparts, red, &tot_s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = tot;
  if (!isfinite(tot)) {            // segment_finish_kernel writes NaN
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  int exp;
  frexp(tot, &exp);
  const double scale = ldexp(1.0, kFracBits - exp);
  const int entries = (kMode == kDirect ? s.keys : slots) * cols;
  if (kMode != kGlobal) {
    for (int e = threadIdx.x; e < entries; e += kThreads) table[e] = 0;
    if (kMode == kHashed)
      for (int e = threadIdx.x; e < slots; e += kThreads) hkeys[e] = kEmpty;
    __syncthreads();
  }
  for (int c0 = 0; c0 < cols; c0 += kW) {
    kb = kCols > 0 ? kCols : (cols - c0 < kW ? cols - c0 : kW);
    if (c0 > 0) {
#pragma unroll
      for (int p = 0; p < kStages - 1; ++p)
        issue_step<kCols>(s, mine + p, end, whole, c0, kb, base + 32 * p,
                          lane);
    }
    int cur = -1;                          // the carried key (warp-wide)
    unsigned long long a[kW] = {};         // this lane's carried sums
    int step = 0;
    for (long long b = base; b < end; b += 32, ++step) {
      issue_step<kCols>(s, mine + (step + kStages - 1) % kStages, end,
                        whole, c0, kb, b + 32 * (kStages - 1), lane);
      copy_wait();
      __syncwarp();
      const Slot* slot = mine + step % kStages;
      int k = b + lane < end ? slot->key[lane] : -1;
      if (k >= s.keys) k = -1;
      const float* x = slot->v + lane * kb;
      unsigned long long q[kW];
#pragma unroll
      for (int t = 0; t < kW; ++t)
        q[t] = fixed(k, t, kb, t < kb ? x[t] : 0.0f, scale);
      __syncwarp();
      // The lanes on the carried key add to the carry.
      const bool on = k == cur && cur >= 0;
#pragma unroll
      for (int t = 0; t < kW; ++t) a[t] += on ? q[t] : 0ull;
      if (__all_sync(kFull, on || k < 0)) continue;
      // Another key: the carry moves to the last lane's key, after a
      // flush of the old one; the lanes of any third key flush their
      // group at once.
      const unsigned valid = __ballot_sync(kFull, k >= 0);
      const int last = __shfl_sync(kFull, k, 31 - __clz(valid));
      if (last != cur) {
        if (cur >= 0)
          flush_carry<kFace, kMode, kW>(s, table, hkeys, slots, cur, c0, kb,
                                        a, lane);
#pragma unroll
        for (int t = 0; t < kW; ++t) a[t] = k == last ? q[t] : 0ull;
      }
      const bool rest = k >= 0 && !on && k != last;
      cur = last;
      if (__any_sync(kFull, rest)) {
        const unsigned group = __match_any_sync(kFull, rest ? k : -1);
#pragma unroll
        for (int t = 0; t < kW; ++t) q[t] = rest ? q[t] : 0ull;
        flush_group<kFace, kMode, kW>(s, table, hkeys, slots, group,
                                  rest ? k : -1, c0, kb, q, lane);
      }
    }
    if (cur >= 0)
      flush_carry<kFace, kMode, kW>(s, table, hkeys, slots, cur, c0, kb, a,
                                    lane);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
  }
  if (kMode != kGlobal) {
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += kThreads) {
      if (table[e] == 0) continue;
      const int k = kMode == kDirect ? e / cols
                                     : static_cast<int>(hkeys[e / cols]);
      const long long d = s.dest(k, e % cols);
      if (d >= 0) atomicAdd(s.acc + d, table[e]);
    }
  }
}

template <int kMode, int kCols>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
row_accumulate_kernel(Keyed<false> s, int slots,
                      const double* __restrict__ partials, int nparts,
                      double* __restrict__ total) {
  accumulate<false, kMode, kCols>(s, slots, partials, nparts, total);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
face_accumulate_kernel(Keyed<true> s, int slots,
                       const double* __restrict__ partials, int nparts,
                       double* __restrict__ total) {
  accumulate<true, kMode, kMaxCols>(s, slots, partials, nparts, total);
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

// The three passes of one keyed sum into out[rows, out_cols]; scratch:
// rows * out_cols + 1 + kPartials int64 (the accumulator, the total,
// the partials), no fill needed.
template <bool kFace>
int run(Keyed<kFace> s, int out_cols, void* scratch, void* out, int grid,
        cudaStream_t stream) {
  const int entries = s.rows * out_cols;
  if (entries == 0) return 0;
  long long* base = static_cast<long long*>(scratch);
  s.acc = reinterpret_cast<unsigned long long*>(base);
  double* total = reinterpret_cast<double*>(base + entries);
  double* partials = reinterpret_cast<double*>(base + entries + 1);
  const long long m = s.n * s.cols;
  const long long per_block = static_cast<long long>(kThreads) * 4 *
                              kLoadsPerThread;
  long long blocks = (m + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > kPartials ? kPartials : blocks);
  segment_scale_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      s.v, m, partials, s.acc, entries);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The hash table: the most slots (a power of two) within kHashBytes.
  int slots = 1;
  while (slots * 2 * (8 * s.cols + 4) <= kHashBytes) slots *= 2;
  const Mode mode = s.keys * s.cols <= kSharedEntries ? kDirect
                    : slots >= 32                    ? kHashed
                                                     : kGlobal;
  const size_t bytes = mode == kDirect   ? 8ull * s.keys * s.cols
                       : mode == kHashed ? (8ull * s.cols + 4) * slots
                                         : 0;
  const int nparts = static_cast<int>(blocks);
  if (grid < 1) grid = 1;
  if constexpr (kFace) {
    // 9 and 6 columns always have hash slots (kWideCols): no kGlobal.
    if (mode == kDirect)
      face_accumulate_kernel<kDirect><<<grid, kThreads, bytes, stream>>>(
          s, 0, partials, nparts, total);
    else
      face_accumulate_kernel<kHashed><<<grid, kThreads, bytes, stream>>>(
          s, slots, partials, nparts, total);
  } else if (s.cols == kMaterialCols) {
    if (mode == kDirect)
      row_accumulate_kernel<kDirect, kMaterialCols>
          <<<grid, kThreads, bytes, stream>>>(s, 0, partials, nparts, total);
    else
      row_accumulate_kernel<kHashed, kMaterialCols>
          <<<grid, kThreads, bytes, stream>>>(s, slots, partials, nparts,
                                              total);
  } else {
    if (mode == kDirect)
      row_accumulate_kernel<kDirect, 0><<<grid, kThreads, bytes, stream>>>(
          s, 0, partials, nparts, total);
    else if (mode == kHashed)
      row_accumulate_kernel<kHashed, 0><<<grid, kThreads, bytes, stream>>>(
          s, slots, partials, nparts, total);
    else
      row_accumulate_kernel<kGlobal, 0><<<grid, kThreads, bytes, stream>>>(
          s, 0, partials, nparts, total);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_finish_kernel<<<(entries + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(base, entries, total,
                                    static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// values [n, cols] f32, idx [n] int32 (rows outside [0, rows) add
// nothing), out [rows, cols] f32; scratch: rows * cols + 1 + kPartials
// int64.  `grid`: the accumulate pass's blocks.
extern "C" int ugrt_segment_sum(const void* values, const void* idx,
                                long long n, int rows, int cols,
                                void* scratch, void* out, int grid,
                                void* stream) {
  Keyed<false> s{static_cast<const float*>(values),
                 static_cast<const int*>(idx), nullptr, n, cols, rows, rows,
                 nullptr};
  return run(s, cols, scratch, out, grid, static_cast<cudaStream_t>(stream));
}

// values [n, 9] f32 (pixel p's corner j, column c at 3 j + c), fid [n]
// int32 (faces outside [0, num_faces) add nothing), faces [num_faces, 3]
// int32 (vertices outside [0, rows) add nothing), out [rows, 3] f32;
// scratch: rows * 3 + 1 + kPartials int64.  `grid`: the accumulate
// pass's blocks.
extern "C" int ugrt_face_corner_sum(const void* values, const void* fid,
                                    const void* faces, long long n,
                                    int num_faces, int rows, void* scratch,
                                    void* out, int grid, void* stream) {
  Keyed<true> s{static_cast<const float*>(values),
                static_cast<const int*>(fid),
                static_cast<const int*>(faces), n, 9, num_faces, rows,
                nullptr};
  return run(s, 3, scratch, out, grid, static_cast<cudaStream_t>(stream));
}
