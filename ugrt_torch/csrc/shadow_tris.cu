// B2 — the triangle side of the shadow pass: K3's coefficient rows of the
// light grid's pairs (cell-key site) and of its heavy list (box site),
// and each 128-ray block's inclusive window ranges at both sites.
//
// Replaces no Pallas kernel.  ugrt runs this side as XLA ops around its
// Pallas shadow sweep (ugrt/trace/shadow.py: pack_tri_windows_coeff,
// window_span, heavy_coeffs, spatial_reorder_heavy,
// pack_heavy_coeff_windows, heavy_window_rects,
// heavy_block_window_range of ugrt/trace/pallas_tracer.py); the port ran
// it as ~90 torch ops (kernels/shadow_tris.py's plain version): per-face
// coefficients, a gather to the pair capacity, a 16-column cat, the
// heavy side's sort, rows and rects, and each block's gathers.
//
// The contract (the plain version, bit for bit):
// - per face f (vertices v0, v1, v2; the light L): tvec = L - v0,
//   e1 = v1 - v0, e2 = v2 - v0; a = e2 x e1, b = e2 x tvec,
//   c = tvec x e1, k = e2 . c, each cross product and dot product in
//   core/vecmath.py's order (products summed left to right);
// - cell-key rows [NW, 256, 16]: pair p's face's a 0:3, b 3:6, c 6:9,
//   k 9, its cell key 10 (as f32), the empty box (1, 0, 1, 0) 11:15,
//   0 at 15; padding pairs (face < 0) 0 at 0:10; the rows past the
//   capacity 0 but for the box's 1s;
// - each block's key-site range per slab: the pair span
//   [cell_offset[k1], cell_offset[k2] + cell_count[k2]) of its first
//   and last real cell (k = clamp(cell, 0, sentinel - 1) * NS + slab;
//   [0, 0) for a block of sentinel rays), as inclusive windows
//   [lo / 256, (hi - 1) / 256], empty (hi = lo - 1) for an empty span;
// - heavy slot s (live: s < heavy_count): its stable rank by the key
//   cx * 1024 + cy (cx, cy the floor halves of its footprint's x and y
//   sums), dead slots keyed 2^30; sorted row r holds the slot of rank r:
//   a, b, c, k (0 for a dead slot), key -2 at 10, the footprint as f32
//   at 11:15 (dead: the empty box), 0 at 15; rows past the capacity 0
//   but for -2 at 10 and the empty box's 1s;
// - window w's footprint union: the min of x0 / y0 and the max of x1 /
//   y1 over its live rows (10^6 and -1 where none is);
// - each block's heavy range: the first and last window whose union
//   its cell rectangle touches (the block's column range, and its row
//   range if it spans one column, else every row); empty (nwh, -1) for a
//   block of sentinel rays;
// - int32 sums and products wrap as torch's do; divisions floor.
// Built with -fmad=false (kernels/_build.py), each product and sum rounds
// as the plain version's elementwise torch ops round them.
//
// What bounds it on the H100: bytes.  The flagship light grid's 590,592
// pair slots read their face and key (8 B a slot) and write their 64 B
// row: 42.5 MB, 0.0127 ms at 3.35 TB/s; the faces' vertices (2.7 MB)
// stay in L2.  The heavy side is 2,048 slots: its stable rank (every
// slot against every other: 4.2M comparisons over 256 warps) and
// 131 KB of rows; the ranges read two cells of each of the 8,192 ray
// blocks.  Two launches: the rows of both sites (the heavy blocks first,
// so their ranks overlap the key rows' writes), then the ranges.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeyWin = 256;          // kernels/shadow_tris.py SWIN
constexpr int kHeavyWin = 128;        // kernels/shadow_tris.py HWIN
constexpr int kHeavySlots = 64;       // heavy slots a block ranks
constexpr int kRankParts = kThreads / kHeavySlots;   // threads a slot
constexpr int kRankTile = 2048;       // keys a block stages at once
constexpr int kDeadKey = 1 << 30;
constexpr int kBig = 1000000;         // heavy_window_rects' empty min
static_assert(kHeavySlots % 32 == 0, "a warp ranks one part of its slots");

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  return a - floor_div(a, b) * b;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

// vecmath.cross.
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 load_v3(const float* p) {
  return V3{p[0], p[1], p[2]};
}

// The 10 coefficients (a, b, c, k) of face f against the light L.
struct Coeffs {
  V3 a, b, c;
  float k;
};

__device__ __forceinline__ Coeffs face_coeffs(const float* vertices,
                                              const int* faces, int f,
                                              V3 L) {
  const int* fv = faces + 3 * static_cast<long long>(f);
  const V3 v0 = load_v3(vertices + 3 * static_cast<long long>(fv[0]));
  const V3 v1 = load_v3(vertices + 3 * static_cast<long long>(fv[1]));
  const V3 v2 = load_v3(vertices + 3 * static_cast<long long>(fv[2]));
  const V3 tvec = sub(L, v0);
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  Coeffs co;
  co.c = cross(tvec, e1);
  co.a = cross(e2, e1);
  co.b = cross(e2, tvec);
  co.k = e2.x * co.c.x + e2.y * co.c.y + e2.z * co.c.z;
  return co;
}

__device__ __forceinline__ void store_row(float* rows, long long r,
                                          const Coeffs& co, float key,
                                          float4 box) {
  float4* row = reinterpret_cast<float4*>(rows) + 4 * r;
  row[0] = make_float4(co.a.x, co.a.y, co.a.z, co.b.x);
  row[1] = make_float4(co.b.y, co.b.z, co.c.x, co.c.y);
  row[2] = make_float4(co.c.z, co.k, key, box.x);
  row[3] = make_float4(box.y, box.z, box.w, 0.0f);
}

struct RowArgs {
  const float* vertices;
  const int* faces;
  int num_faces;
  const float* light;        // the light's camcoords: position at [0:3]
  const int* sorted_faces;   // [cap]
  const int* sorted_keys;    // [cap]
  int cap;
  int rows;                  // NW * 256
  float* tri_w;              // [NW, 256, 16]
  const int* heavy_faces;    // [H]
  const int* heavy_count;    // 0-d
  const int4* heavy_ranges;  // [H]
  int heavy_cap;
  int heavy_rows;            // NWH * 128
  int heavy_blocks;
  float* tri_hw;             // [NWH, 128, 16]
  int4* sorted_ranges;       // [H] the ranks' footprints, empty-filled
};

__device__ __forceinline__ V3 light_pos(const float* light) {
  return V3{light[0], light[1], light[2]};
}

__device__ __forceinline__ float4 empty_box() {
  return make_float4(1.0f, 0.0f, 1.0f, 0.0f);
}

__device__ __forceinline__ Coeffs zero_coeffs() {
  Coeffs co;
  co.a = co.b = co.c = V3{0.0f, 0.0f, 0.0f};
  co.k = 0.0f;
  return co;
}

__device__ __forceinline__ int clamp_face(int f, int num_faces) {
  return f < 0 ? 0 : (f > num_faces - 1 ? num_faces - 1 : f);
}

// Heavy slot s's sort key: the footprint centre, dead slots last.
__device__ __forceinline__ int heavy_key(int4 r, bool live) {
  if (!live) return kDeadKey;
  const int cx = floor_div(wrap_add(r.x, r.y), 2);
  const int cy = floor_div(wrap_add(r.z, r.w), 2);
  return wrap_add(wrap_mul(cx, 1024), cy);
}

// (key, slot) as one unsigned 64-bit value: unique, ordered as the
// stable sort orders the slots.
__device__ __forceinline__ unsigned long long rank_code(int key, int s) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned>(s);
}

// A heavy block: kHeavySlots slots, each ranked by kRankParts threads
// over the whole list, then written at its rank; slots past the capacity
// write the padding rows.
__device__ void heavy_block(const RowArgs& a, int hb) {
  __shared__ unsigned long long codes[kRankTile];
  __shared__ int partial[kRankParts][kHeavySlots];
  const int slot_in = threadIdx.x % kHeavySlots;
  const int part = threadIdx.x / kHeavySlots;
  const int s = hb * kHeavySlots + slot_in;
  const int count = *a.heavy_count;
  const int H = a.heavy_cap;
  unsigned long long mine = 0;
  int4 r = make_int4(1, 0, 1, 0);
  if (s < H) {
    r = a.heavy_ranges[s];
    mine = rank_code(heavy_key(r, s < count), s);
  }
  int below = 0;
  for (int base = 0; base < H; base += kRankTile) {
    const int n = min(kRankTile, H - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads)
      codes[j] = rank_code(heavy_key(a.heavy_ranges[base + j],
                                     base + j < count),
                           base + j);
    __syncthreads();
    // Part p counts keys j = p, p + kRankParts, ...: a warp's lanes share
    // a part and read one key at a time (a broadcast).
    if (s < H)
      for (int j = part; j < n; j += kRankParts) below += codes[j] < mine;
  }
  partial[part][slot_in] = below;
  __syncthreads();
  if (part != 0 || s >= a.heavy_rows) return;
  if (s >= H) {   // a padding row
    float4* row = reinterpret_cast<float4*>(a.tri_hw) + 4LL * s;
    row[0] = row[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[2] = make_float4(0.0f, 0.0f, -2.0f, 1.0f);
    row[3] = make_float4(0.0f, 1.0f, 0.0f, 0.0f);
    return;
  }
  int rank = 0;
  for (int p = 0; p < kRankParts; ++p) rank += partial[p][slot_in];
  const bool live = s < count;
  Coeffs co = zero_coeffs();
  float4 box = empty_box();
  int4 fp = make_int4(kBig, -1, kBig, -1);
  if (live) {
    co = face_coeffs(a.vertices, a.faces,
                     clamp_face(a.heavy_faces[s], a.num_faces),
                     light_pos(a.light));
    box = make_float4(static_cast<float>(r.x), static_cast<float>(r.y),
                      static_cast<float>(r.z), static_cast<float>(r.w));
    fp = r;
  }
  store_row(a.tri_hw, rank, co, -2.0f, box);
  a.sorted_ranges[rank] = fp;
}

// Launch 1: the heavy blocks, then one key-site row a thread.
__global__ void __launch_bounds__(kThreads) rows_kernel(RowArgs a) {
  if (static_cast<int>(blockIdx.x) < a.heavy_blocks) {
    heavy_block(a, blockIdx.x);
    return;
  }
  const long long p =
      static_cast<long long>(blockIdx.x - a.heavy_blocks) * kThreads +
      threadIdx.x;
  if (p >= a.rows) return;
  Coeffs co = zero_coeffs();
  float key = 0.0f;
  if (p < a.cap) {
    const int f = a.sorted_faces[p];
    key = static_cast<float>(a.sorted_keys[p]);
    if (f >= 0)
      co = face_coeffs(a.vertices, a.faces, clamp_face(f, a.num_faces),
                       light_pos(a.light));
  }
  store_row(a.tri_w, p, co, key, empty_box());
}

struct RangeArgs {
  const int* cell_offset;      // [sentinel * NS]
  const int* cell_count;
  const int* first_cell;       // [nb]
  const int* last_real;        // [nb]
  int nb;
  int num_slabs;
  int grid_y;
  int sentinel;
  const int4* sorted_ranges;   // [H]
  int heavy_cap;
  int nwh;
  int* spans;                  // [2, NS, nb]: w_lo, then w_hi
  int* heavy;                  // [2, nb]: hlo, then hhi
};

// Launch 2: each block's window ranges at both sites, one block a
// thread; the block's warps first reduce every heavy window's union.
__global__ void __launch_bounds__(kThreads) ranges_kernel(RangeArgs a) {
  extern __shared__ int4 rects[];   // [nwh]: x0, x1, y0, y1
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < a.nwh; w += kThreads / 32) {
    int4 u = make_int4(kBig, -1, kBig, -1);
    for (int q = lane; q < kHeavyWin; q += 32) {
      const int s = w * kHeavyWin + q;
      if (s < a.heavy_cap) {
        const int4 r = a.sorted_ranges[s];
        u = make_int4(min(u.x, r.x), max(u.y, r.y), min(u.z, r.z),
                      max(u.w, r.w));
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      u.x = min(u.x, __shfl_xor_sync(0xffffffffu, u.x, o));
      u.y = max(u.y, __shfl_xor_sync(0xffffffffu, u.y, o));
      u.z = min(u.z, __shfl_xor_sync(0xffffffffu, u.z, o));
      u.w = max(u.w, __shfl_xor_sync(0xffffffffu, u.w, o));
    }
    if (lane == 0) rects[w] = u;
  }
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.nb) return;
  const int first = a.first_cell[b];
  const int last_cell = a.last_real[b];
  const bool live = last_cell >= 0;
  const int top = a.sentinel - 1;
  const long long k1 =
      static_cast<long long>(first < 0 ? 0 : (first > top ? top : first)) *
      a.num_slabs;
  const long long k2 =
      static_cast<long long>(last_cell < 0 ? 0
                             : (last_cell > top ? top : last_cell)) *
      a.num_slabs;
  for (int slab = 0; slab < a.num_slabs; ++slab) {
    int lo = 0, hi = 0;
    if (live) {
      lo = a.cell_offset[k1 + slab];
      hi = wrap_add(a.cell_offset[k2 + slab], a.cell_count[k2 + slab]);
    }
    const int w_lo = floor_div(lo, kKeyWin);
    const int w_hi = hi > lo ? floor_div(wrap_add(hi, -1), kKeyWin)
                             : wrap_add(w_lo, -1);
    a.spans[slab * a.nb + b] = w_lo;
    a.spans[(a.num_slabs + slab) * a.nb + b] = w_hi;
  }
  // The block's cell rectangle (heavy_block_window_range).
  const int last = last_cell < 0 ? 0 : last_cell;
  const int bx_lo = floor_div(first, a.grid_y);
  const int bx_hi = floor_div(last, a.grid_y);
  const bool one_row = bx_lo == bx_hi;
  const int by_lo = one_row ? floor_mod(first, a.grid_y) : 0;
  const int by_hi = one_row ? floor_mod(last, a.grid_y) : a.grid_y - 1;
  int hlo = a.nwh, hhi = -1;
  if (live)
    for (int w = 0; w < a.nwh; ++w) {
      const int4 u = rects[w];
      if (bx_lo <= u.y && bx_hi >= u.x && by_lo <= u.w && by_hi >= u.z) {
        hlo = min(hlo, w);
        hhi = w;
      }
    }
  a.heavy[b] = hlo;
  a.heavy[a.nb + b] = hhi;
}

}  // namespace

// vertices [V, 3] f32, faces [F, 3] int32, light the light's camcoords
// (f32, position at [0:3]); the light grid's sorted_faces / sorted_keys
// [cap], cell_offset / cell_count [sentinel * num_slabs], heavy_faces
// [H], heavy_count 0-d, heavy_ranges [H, 4] (int32); B1's first_cell /
// last_real [nb] int32.  Out: tri_w [nw, 256, 16] f32 (nw = ceil(cap /
// 256)), spans [2, num_slabs, nb] int32 (w_lo, w_hi), tri_hw [nwh, 128,
// 16] f32 (nwh = ceil(H / 128)), heavy [2, nb] int32 (hlo, hhi);
// scratch: sorted_ranges [H, 4] int32.

extern "C" int ugrt_shadow_tris(
    const void* vertices, const void* faces, int num_faces,
    const void* light, const void* sorted_faces, const void* sorted_keys,
    int cap, int nw, const void* cell_offset, const void* cell_count,
    const void* first_cell, const void* last_real, int nb, int num_slabs,
    int grid_y, int sentinel, const void* heavy_faces,
    const void* heavy_count, const void* heavy_ranges, int heavy_cap,
    int nwh, void* tri_w, void* spans, void* tri_hw, void* sorted_ranges,
    void* heavy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int heavy_rows = nwh * kHeavyWin;
  const int heavy_blocks = (heavy_rows + kHeavySlots - 1) / kHeavySlots;
  const int rows = nw * kKeyWin;
  RowArgs r{static_cast<const float*>(vertices),
            static_cast<const int*>(faces),
            num_faces,
            static_cast<const float*>(light),
            static_cast<const int*>(sorted_faces),
            static_cast<const int*>(sorted_keys),
            cap,
            rows,
            static_cast<float*>(tri_w),
            static_cast<const int*>(heavy_faces),
            static_cast<const int*>(heavy_count),
            static_cast<const int4*>(heavy_ranges),
            heavy_cap,
            heavy_rows,
            heavy_blocks,
            static_cast<float*>(tri_hw),
            static_cast<int4*>(sorted_ranges)};
  rows_kernel<<<heavy_blocks + (rows + kThreads - 1) / kThreads, kThreads, 0,
                s>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nb == 0) return cudaSuccess;
  RangeArgs g{static_cast<const int*>(cell_offset),
              static_cast<const int*>(cell_count),
              static_cast<const int*>(first_cell),
              static_cast<const int*>(last_real),
              nb,
              num_slabs,
              grid_y,
              sentinel,
              static_cast<const int4*>(sorted_ranges),
              heavy_cap,
              nwh,
              static_cast<int*>(spans),
              static_cast<int*>(heavy)};
  ranges_kernel<<<(nb + kThreads - 1) / kThreads, kThreads,
                  nwh * sizeof(int4), s>>>(g);
  return cudaGetLastError();
}
