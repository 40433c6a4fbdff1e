// B1 — the ray side of the shadow pass: bin every shadow ray into its
// light cell, sort the rays stably by cell, lay out K3's ray rows and
// each 128-ray block's cell bounds, and scatter the blocks' flags back
// to pixel order; and, in the windowed light-grid mode, the per-ray
// signed angles and their bounds (light_window).
//
// Replaces no Pallas kernel.  ugrt runs this side as XLA ops around its
// Pallas shadow sweep (ugrt/trace/shadow.py: light_window, the ray->cell
// map of grid/binning.py, a jax.lax.sort with the hit point as payload,
// the row assembly, _unpermute); the port ran it as ~100 torch ops on
// 1M-element tensors (kernels/shadow_bin.py's plain versions), bound by
// launches and round trips through device memory.
//
// The contract (the plain versions, bit for bit):
// - hit point p = eye + t * dir; d = normalize(p - L), normalize as a
//   multiply by 1 / sqrt(dot); products summed left to right
//   (core/vecmath.py); sqrt and acos in f64, rounded once to f32;
// - reference and extent modes: the light cell of grid/binning.py's
//   block_x / block_y (ray_light_cells), with the y_forward_dot_typo
//   quirk; windowed mode: the signed angles (signed_xy_coords) mapped
//   through the window (ray_light_cells_windowed); the sentinel
//   grid_x * grid_y outside the grid and, windowed, for NaN angles;
//   float->int as _trunc_int / _floor_int: NaN -> 0, saturating;
// - the stable order of the keys (torch.sort(stable=True)), which is
//   unique, with int32 ray ids;
// - K3's ray rows [NB, 128, 8]: direction 0:3, light-to-point distance
//   3, cell key 4 (slab 0: key * num_slabs, -1 for the sentinel), the
//   cell's (gx, gy) 5:6, 0 at 7; pad rows 0 but for key -1 and the
//   sentinel's cell; first_cell / last_real of each block;
// - the unpermute: out[perm[j]] = flags[j];
// - the window: min and max of sx and of sy over the rays where they
//   are not NaN (4 and -4 where none is); min and max are exact in any
//   order, so the bounds are too.
// Built with -fmad=false and IEEE division and square root
// (kernels/_build.py), each product, sum and quotient rounds as the
// plain versions' elementwise torch ops round them.
//
// What bounds it on the H100: bytes, and those are few.  The flagship
// frame's 1,048,576 rays read t and dir (16 B a ray) twice, the keys
// and ray ids move through two radix passes (4 x 8 B a ray), the rows
// (32 B) and the flags are written once: ~100 MB, 0.03 ms at 3.35 TB/s.
// The per-ray arithmetic (three f64 square roots and two f64 arccos) is
// far below the f64 peak.  The launches are the cost to keep small:
// seven on a frame's path (bin, two passes of scan and scatter, the
// second pass's histogram, rows), two for the window, one unpermute.
//
// The sort: keys use bit_length(grid_x * grid_y) bits (15 on a 128^2
// grid), sorted least significant digit first in passes of 8 bits; each
// pass is stable, so the result is the stable order of the whole key.
// A pass cuts the keys into tiles of kTile, in order; each tile counts
// its digits (the bin kernel counts pass 0's as it writes the keys), a
// scan gives every (digit, tile) its first slot in digit-major order,
// and the tile's scatter places its keys there in order.  Inside a tile
// each warp owns kWarpSpan consecutive keys, taken 32 a step in order;
// the lanes of a step that share a digit find each other with
// __match_any_sync and take consecutive slots after the warp's running
// count of that digit.  No atomic counts a digit across warps: on the
// reference frame 7 light cells hold every ray, and a histogram of
// per-ray atomics would serialise on them.  A counting sort over the
// 16,385 keys at once would need a count per (key, tile): 33.6 MB at
// 2,048-key tiles, and a count per (key, warp) in shared memory that no
// block has.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // keys a thread in a tile
constexpr int kTile = kThreads * kItems;   // 2,048 keys
constexpr int kWarpSpan = 32 * kItems;     // a warp's consecutive keys
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kBlockRays = 128;            // K3's ray block
static_assert(kThreads == kRadix, "one thread a digit in the scans");

enum Mode { kPoints = 0, kWindowPoints = 1, kWindowAngles = 2 };

struct Light {
  float x, y, z;     // position: camcoords[0:3]
  float r[3];        // right, up, forward rows of the modelview rotation
  float u[3];        // (camcoords[16:32], binning.mv_basis)
  float f[3];
};

struct BinArgs {
  const float* t;      // [n] primary t
  const float* dir;    // [n, 3] primary ray directions
  const float* eye;    // [3]
  const float* cc;     // the light's camcoords
  int n;
  int grid_x, grid_y;
  int y_typo;
  const float* x_max_p;  // extent mode's 0-d tensors, else null ...
  const float* y_max_p;
  float x_max, y_max;    // ... and the reference mode's values
  const float* win;      // windowed: x0, x1, y0, y1 (four 0-d tensors)
  const float* win1;
  const float* win2;
  const float* win3;
  const float* sx;       // windowed, from the window launch: [n] angles
  const float* sy;
  int* keys;             // [n] out
  int* counts;           // [kRadix, ntiles] out: pass 0's digit counts
  int ntiles;
};

__device__ __forceinline__ Light load_light(const float* cc) {
  const float* mv = cc + 16;
  Light L;
  L.x = cc[0];
  L.y = cc[1];
  L.z = cc[2];
  for (int k = 0; k < 3; ++k) {
    L.r[k] = mv[4 * k];
    L.u[k] = mv[4 * k + 1];
    L.f[k] = mv[4 * k + 2];
  }
  return L;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, const float* b) {
  return a.x * b[0] + a.y * b[1] + a.z * b[2];
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// vecmath.sqrt / acos: f64, rounded once.
__device__ __forceinline__ float sqrt_f64(float x) {
  return static_cast<float>(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ float acos_f64(float x) {
  return static_cast<float>(acos(static_cast<double>(x)));
}

// _trunc_int / _floor_int: NaN -> 0, then saturate to int32.
__device__ __forceinline__ int sat_int(float x) {
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}

__device__ __forceinline__ int trunc_int(float x) {
  return x != x ? 0 : sat_int(truncf(x));
}

__device__ __forceinline__ int floor_int(float x) {
  return x != x ? 0 : sat_int(floorf(x));
}

// p - L for ray i, p = eye + t * dir (trace/shadow.py's hit points).
__device__ __forceinline__ V3 light_to_point(const float* t, const float* dir,
                                             const float* eye, const Light& L,
                                             int i) {
  const float ti = t[i];
  const float* di = dir + 3 * static_cast<long long>(i);
  return V3{(eye[0] + ti * di[0]) - L.x, (eye[1] + ti * di[1]) - L.y,
            (eye[2] + ti * di[2]) - L.z};
}

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}

// v - (v . axis) axis, divided by its magnitude (binning's tmp).
__device__ __forceinline__ V3 reject_normalized(V3 v, const float* axis) {
  const float k = dot3(v, axis);
  V3 w{v.x - k * axis[0], v.y - k * axis[1], v.z - k * axis[2]};
  const float m = sqrt_f64(dot3(w, w));
  return V3{w.x / m, w.y / m, w.z / m};
}

__device__ __forceinline__ float clamp_unit(float x) {
  // torch.clamp(x, -1, 1): NaN stays NaN.
  return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
}

// binning.signed_xy_coords of the unit direction d.
__device__ __forceinline__ void signed_angles(V3 d, const Light& L, float* sx,
                                             float* sy) {
  const V3 tx = reject_normalized(d, L.u);
  const float xa = acos_f64(clamp_unit(dot3(tx, L.f)));
  *sx = dot3(tx, L.r) > 0.0f ? xa : -xa;
  const V3 ty = reject_normalized(d, L.r);
  const float ya = acos_f64(clamp_unit(dot3(ty, L.f)));
  *sy = dot3(ty, L.u) > 0.0f ? ya : -ya;
}

// binning.ray_light_cells: block_x and block_y of d.
__device__ __forceinline__ int reference_cell(V3 d, const Light& L, int gx,
                                              int gy, float x_max, float y_max,
                                              bool typo) {
  const V3 tx = reject_normalized(d, L.u);
  const float xa = acos_f64(dot3(tx, L.f));
  const int half_x = gx / 2;
  const int step_x =
      trunc_int((xa / x_max) * static_cast<float>(half_x));
  // int32 sums wrap as torch's do.
  const int bx = dot3(tx, L.r) > 0.0f
                     ? static_cast<int>(static_cast<unsigned>(half_x) +
                                        static_cast<unsigned>(step_x))
                     : static_cast<int>(static_cast<unsigned>(half_x) -
                                        static_cast<unsigned>(step_x));
  const V3 ty = reject_normalized(d, L.r);
  const float up = dot3(ty, L.u);
  const float fwd = typo ? ty.x * L.f[0] + ty.y * L.f[1] * ty.z * L.f[2]
                         : dot3(ty, L.f);
  const float ya = acos_f64(fwd);
  const float half_y = static_cast<float>(gy / 2);
  const float step_y = (ya / y_max) * half_y;
  const int by = trunc_int(up > 0.0f ? half_y + step_y : half_y - step_y);
  const bool inside = bx >= 0 && bx < gx && by >= 0 && by < gy;
  return inside ? bx * gy + by : gx * gy;
}

// binning.window_cells (the windowed map of ray_light_cells_windowed).
__device__ __forceinline__ int window_cell(float sx, float sy, float x0,
                                           float x1, float y0, float y1,
                                           int gx, int gy) {
  const int bx = floor_int((sx - x0) / (x1 - x0) * static_cast<float>(gx));
  const int by = floor_int((sy - y0) / (y1 - y0) * static_cast<float>(gy));
  const bool inside = bx >= 0 && bx < gx && by >= 0 && by < gy &&
                      sx == sx && sy == sy;
  return inside ? bx * gy + by : gx * gy;
}

__device__ __forceinline__ V3 unit(V3 a) {
  return scale(a, 1.0f / sqrt_f64(dot3(a, a)));
}

template <int kMode>
__device__ __forceinline__ int ray_key(const BinArgs& a, const Light& L,
                                       int i) {
  if constexpr (kMode == kPoints) {
    const float xm = a.x_max_p ? *a.x_max_p : a.x_max;
    const float ym = a.y_max_p ? *a.y_max_p : a.y_max;
    const V3 d = unit(light_to_point(a.t, a.dir, a.eye, L, i));
    return reference_cell(d, L, a.grid_x, a.grid_y, xm, ym, a.y_typo != 0);
  }
  float sx, sy;
  if constexpr (kMode == kWindowAngles) {
    sx = a.sx[i];
    sy = a.sy[i];
  } else {
    signed_angles(unit(light_to_point(a.t, a.dir, a.eye, L, i)), L, &sx,
                  &sy);
  }
  return window_cell(sx, sy, *a.win, *a.win1, *a.win2, *a.win3, a.grid_x,
                     a.grid_y);
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Tile slot e of a thread: warp w's keys [w kWarpSpan, (w + 1) kWarpSpan)
// of the tile, item k at lane + 32 k.
__device__ __forceinline__ int tile_index(int tile, int item) {
  return tile * kTile + (threadIdx.x >> 5) * kWarpSpan + item * 32 +
         (threadIdx.x & 31);
}

// Add a step's digits (kRadix for no key) into the block's counts: one
// shared add per distinct digit of the warp.
__device__ __forceinline__ void count_digit(int digit, int* hist) {
  const unsigned peers = __match_any_sync(kFull, digit);
  if (digit < kRadix && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[digit], __popc(peers));
}

__device__ __forceinline__ void zero_hist(int* hist) {
  hist[threadIdx.x] = 0;
  __syncthreads();
}

__device__ __forceinline__ void store_hist(const int* hist, int* counts,
                                           int ntiles) {
  __syncthreads();
  counts[threadIdx.x * ntiles + blockIdx.x] = hist[threadIdx.x];
}

// Step 1: a tile's keys, and pass 0's digit counts of the tile.
template <int kMode>
__global__ void __launch_bounds__(kThreads) bin_kernel(BinArgs a) {
  __shared__ int hist[kRadix];
  zero_hist(hist);
  const Light L = load_light(a.cc);
  for (int k = 0; k < kItems; ++k) {
    const int i = tile_index(blockIdx.x, k);
    int digit = kRadix;
    if (i < a.n) {
      const int key = ray_key<kMode>(a, L, i);
      a.keys[i] = key;
      digit = key & (kRadix - 1);
    }
    count_digit(digit, hist);
  }
  store_hist(hist, a.counts, a.ntiles);
}

// A later pass's digit counts of each tile.
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* keys, int n, int shift, int* counts, int ntiles) {
  __shared__ int hist[kRadix];
  zero_hist(hist);
  for (int k = 0; k < kItems; ++k) {
    const int i = tile_index(blockIdx.x, k);
    count_digit(i < n ? (keys[i] >> shift) & (kRadix - 1) : kRadix, hist);
  }
  store_hist(hist, counts, ntiles);
}

// Exclusive sum over the block's threads (in thread order); *total gets
// the block's sum.
__device__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return x - v + before;
}

// Block d: the exclusive prefix of digit d's counts over the tiles, in
// place, and the digit's total.
__global__ void __launch_bounds__(kThreads)
    scan_kernel(int* counts, int ntiles, int* totals) {
  int* row = counts + blockIdx.x * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    int sum;
    const int excl = block_exclusive_sum(v, &sum);
    if (i < ntiles) row[i] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// A pass's scatter of one tile: each key (and its ray id; pass 0's ids
// are the keys' indices) to its slot in the pass's stable order.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* keys_in, const int* ids_in, int n, int shift,
                   const int* counts, const int* totals, int ntiles,
                   int* keys_out, int* ids_out) {
  __shared__ int next[kWarps][kRadix];  // a warp's next slot of a digit
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = threadIdx.x;
  int all;
  const int tile_start = block_exclusive_sum(totals[d], &all) +
                         counts[d * ntiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) next[w][d] = 0;
  int key[kItems], id[kItems], digit[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = tile_index(blockIdx.x, k);
    const bool valid = i < n;
    key[k] = valid ? keys_in[i] : 0;
    id[k] = kFirst ? i : (valid ? ids_in[i] : 0);
    digit[k] = valid ? (key[k] >> shift) & (kRadix - 1) : kRadix;
  }
  __syncthreads();
  // The warp's count of each digit.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned peers = __match_any_sync(kFull, digit[k]);
    if (digit[k] < kRadix && lane == __ffs(peers) - 1)
      next[warp][digit[k]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Digit d's first slot for each warp: the tile's, then warp by warp.
  int run = tile_start;
  for (int w = 0; w < kWarps; ++w) {
    const int c = next[w][d];
    next[w][d] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned peers = __match_any_sync(kFull, digit[k]);
    if (digit[k] < kRadix) {
      const int slot = next[warp][digit[k]] + __popc(peers & lanes_below());
      keys_out[slot] = key[k];
      ids_out[slot] = id[k];
    }
    __syncwarp();
    if (digit[k] < kRadix && lane == __ffs(peers) - 1)
      next[warp][digit[k]] += __popc(peers);
    __syncwarp();
  }
}

struct RowArgs {
  const float* t;
  const float* dir;
  const float* eye;
  const float* cc;
  const int* perm;     // [n]
  int* scells;         // [n_pad]: sorted keys; the pad is written here
  int n;
  int grid_y;
  int sentinel;
  int num_slabs;
  float* rows;         // [n_pad, 8]
  int* first_cell;     // [NB]
  int* last_real;      // [NB]
};

// Step 3: slot j's row (one thread a slot, one block a ray block).
__global__ void __launch_bounds__(kBlockRays) rows_kernel(RowArgs a) {
  const int j = blockIdx.x * kBlockRays + threadIdx.x;
  const int key = j < a.n ? a.scells[j] : a.sentinel;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j < a.n) {
    const Light L = load_light(a.cc);
    const V3 delta = light_to_point(a.t, a.dir, a.eye, L, a.perm[j]);
    const float s = sqrt_f64(dot3(delta, delta));
    const V3 d = scale(delta, 1.0f / s);
    lo = make_float4(d.x, d.y, d.z, s);
  } else {
    a.scells[j] = a.sentinel;
  }
  const bool real = key < a.sentinel;
  const float4 hi = make_float4(
      real ? static_cast<float>(key * a.num_slabs) : -1.0f,
      static_cast<float>(key / a.grid_y), static_cast<float>(key % a.grid_y),
      0.0f);
  float4* row = reinterpret_cast<float4*>(a.rows) + 2 * static_cast<long long>(j);
  row[0] = lo;
  row[1] = hi;
  // The block's cells: sorted, so its first key is the least, and its
  // last real key is the one before a sentinel or the block's end.
  if (threadIdx.x == 0) {
    a.first_cell[blockIdx.x] = key;
    if (!real) a.last_real[blockIdx.x] = -1;
  }
  if (real) {
    const int next = j + 1 < a.n ? a.scells[j + 1] : a.sentinel;
    if (threadIdx.x == kBlockRays - 1 || next >= a.sentinel)
      a.last_real[blockIdx.x] = key;
  }
}

// Step 4: out[perm[j]] = flags[j].
__global__ void unpermute_kernel(const int* flags, const int* perm, int n,
                                 int* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) out[perm[j]] = flags[j];
}

// The block's (min, max, min, max) of its threads' b into out[0:4].
__device__ void store_bounds(float* b, float* out) {
  __shared__ float part[kWarps][4];
  for (int o = 16; o > 0; o >>= 1) {
    b[0] = fminf(b[0], __shfl_xor_sync(kFull, b[0], o));
    b[1] = fmaxf(b[1], __shfl_xor_sync(kFull, b[1], o));
    b[2] = fminf(b[2], __shfl_xor_sync(kFull, b[2], o));
    b[3] = fmaxf(b[3], __shfl_xor_sync(kFull, b[3], o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < 4; ++c) part[warp][c] = b[c];
  __syncthreads();
  if (threadIdx.x < 4) {
    const int c = threadIdx.x;
    float v = part[0][c];
    for (int w = 1; w < kWarps; ++w)
      v = (c & 1) ? fmaxf(v, part[w][c]) : fminf(v, part[w][c]);
    out[c] = v;
  }
}

// The window: each ray's signed angles, and each tile's min and max of
// them over the rays where they are not NaN.
__global__ void __launch_bounds__(kThreads)
    window_kernel(const float* t, const float* dir, const float* eye,
                  const float* cc, int n, float* sx_out, float* sy_out,
                  float* partials) {
  const Light L = load_light(cc);
  float b[4] = {4.0f, -4.0f, 4.0f, -4.0f};
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (i >= n) break;
    float sx, sy;
    signed_angles(unit(light_to_point(t, dir, eye, L, i)), L, &sx, &sy);
    sx_out[i] = sx;
    sy_out[i] = sy;
    if (sx == sx) {
      b[0] = fminf(b[0], sx);
      b[1] = fmaxf(b[1], sx);
    }
    if (sy == sy) {
      b[2] = fminf(b[2], sy);
      b[3] = fmaxf(b[3], sy);
    }
  }
  store_bounds(b, partials + 4 * blockIdx.x);
}

// The tiles' bounds into (x0, x1, y0, y1): one block.
__global__ void __launch_bounds__(kThreads)
    window_reduce_kernel(const float* partials, int nparts, float* out) {
  float b[4] = {4.0f, -4.0f, 4.0f, -4.0f};
  for (int p = threadIdx.x; p < nparts; p += kThreads) {
    b[0] = fminf(b[0], partials[4 * p]);
    b[1] = fmaxf(b[1], partials[4 * p + 1]);
    b[2] = fminf(b[2], partials[4 * p + 2]);
    b[3] = fmaxf(b[3], partials[4 * p + 3]);
  }
  store_bounds(b, out);
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Steps 1-3.  t [n], dir [n, 3], eye [3], cc the light's camcoords (f32);
// extent mode: x_max_p / y_max_p 0-d f32, else null and x_max / y_max
// the values; windowed: win0..3 the window's 0-d (x0, x1, y0, y1), and
// sx / sy [n] the rays' angles from ugrt_shadow_window or null.
// scratch: 4 n + kRadix (ceil(n / kTile) + 1) int32.  Out: scells
// [n_pad] int32, perm [n] int32, rows [n_pad, 8] f32, first_cell /
// last_real [n_pad / 128] int32.

extern "C" int ugrt_shadow_rays(
    const void* t, const void* dir, const void* eye, const void* cc, int n,
    int grid_x, int grid_y, int num_slabs, int y_typo, const void* x_max_p,
    const void* y_max_p, float x_max, float y_max, const void* win0,
    const void* win1, const void* win2, const void* win3, const void* sx,
    const void* sy, void* scratch, void* scells, void* perm, void* rows,
    void* first_cell, void* last_real, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = tiles(n);
  int* keys_a = static_cast<int*>(scratch);
  int* ids_a = keys_a + n;
  int* keys_b = ids_a + n;
  int* ids_b = keys_b + n;
  int* counts = ids_b + n;
  int* totals = counts + static_cast<long long>(kRadix) * ntiles;
  const int sentinel = grid_x * grid_y;
  int bits = 1;
  while ((sentinel >> bits) != 0) ++bits;   // bit_length(sentinel)

  BinArgs a{static_cast<const float*>(t), static_cast<const float*>(dir),
            static_cast<const float*>(eye), static_cast<const float*>(cc),
            n, grid_x, grid_y, y_typo,
            static_cast<const float*>(x_max_p),
            static_cast<const float*>(y_max_p), x_max, y_max,
            static_cast<const float*>(win0), static_cast<const float*>(win1),
            static_cast<const float*>(win2), static_cast<const float*>(win3),
            static_cast<const float*>(sx), static_cast<const float*>(sy),
            keys_a, counts, ntiles};
  if (!win0)
    bin_kernel<kPoints><<<ntiles, kThreads, 0, s>>>(a);
  else if (!sx)
    bin_kernel<kWindowPoints><<<ntiles, kThreads, 0, s>>>(a);
  else
    bin_kernel<kWindowAngles><<<ntiles, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int* keys_in = keys_a;
  const int* ids_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    if (p > 0)
      hist_kernel<<<ntiles, kThreads, 0, s>>>(keys_in, n, shift, counts,
                                              ntiles);
    scan_kernel<<<kRadix, kThreads, 0, s>>>(counts, ntiles, totals);
    const bool last = p == passes - 1;
    int* keys_out = last ? static_cast<int*>(scells)
                         : (p % 2 == 0 ? keys_b : keys_a);
    int* ids_out = last ? static_cast<int*>(perm) : (p % 2 == 0 ? ids_b : ids_a);
    if (p == 0)
      scatter_kernel<true><<<ntiles, kThreads, 0, s>>>(
          keys_in, ids_in, n, shift, counts, totals, ntiles, keys_out,
          ids_out);
    else
      scatter_kernel<false><<<ntiles, kThreads, 0, s>>>(
          keys_in, ids_in, n, shift, counts, totals, ntiles, keys_out,
          ids_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    keys_in = keys_out;
    ids_in = ids_out;
  }

  const int nb = (n + kBlockRays - 1) / kBlockRays;
  RowArgs r{static_cast<const float*>(t), static_cast<const float*>(dir),
            static_cast<const float*>(eye), static_cast<const float*>(cc),
            static_cast<const int*>(perm), static_cast<int*>(scells), n,
            grid_y, sentinel, num_slabs, static_cast<float*>(rows),
            static_cast<int*>(first_cell), static_cast<int*>(last_real)};
  rows_kernel<<<nb, kBlockRays, 0, s>>>(r);
  return cudaGetLastError();
}

// Step 4.  flags [n] int32 in sorted order, perm [n] int32, out [n] int32.
extern "C" int ugrt_shadow_unpermute(const void* flags, const void* perm,
                                     int n, void* out, void* stream) {
  unpermute_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), static_cast<const int*>(perm), n,
      static_cast<int*>(out));
  return cudaGetLastError();
}

// Step 5.  t, dir, eye, cc as ugrt_shadow_rays; out: sx, sy [n] f32 and
// bounds [4] f32 (x0, x1, y0, y1, before any margin); partials:
// 4 ceil(n / kTile) f32.

extern "C" int ugrt_shadow_window(const void* t, const void* dir,
                                  const void* eye, const void* cc, int n,
                                  void* sx, void* sy, void* partials,
                                  void* bounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = tiles(n);
  window_kernel<<<parts, kThreads, 0, s>>>(
      static_cast<const float*>(t), static_cast<const float*>(dir),
      static_cast<const float*>(eye), static_cast<const float*>(cc), n,
      static_cast<float*>(sx), static_cast<float*>(sy),
      static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  window_reduce_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partials), parts, static_cast<float*>(bounds));
  return cudaGetLastError();
}
