// D1 — the uniform-grid DDA of the reflection rays, one thread per ray,
// the cell's faces staged and tested by the warp together.
//
// Replaces ugrt's trace_uniform_dda (ugrt/trace/reflect.py:56-250).  That
// is not a Pallas kernel but XLA control flow: a lax.map over ray chunks,
// a lax.while_loop per chunk, a lax.fori_loop of empty-cell skips and a
// lax.cond per triangle batch.  Its contract, per ray (the op order of
// kernels/uniform_dda.py's plain version, which this kernel reproduces
// bit for bit):
// - slab entry into the grid's AABB: inv_d = 1 / (|d| < 1e-20 ? 1e-20 : d),
//   t1, t2, t_near = max of the per-axis min, t_far = min of the max,
//   t_enter = max(t_near, 0) + eps; the ray is traced when
//   t_far > t_enter and it is active;
// - start cell int((o + t_enter d - lo) / cell_size), clamped; step, t_max,
//   t_delta as Amanatides-Woo;
// - at most gx + gy + gz iterations while the ray is alive: skip up to
//   skip_k empty cells, t_exit = min(t_max), test the cell's faces in
//   batches of B up to max_batches batches (while count > b * B), each a
//   direct-form Moller-Trumbore with signed t; a face is rejected at
//   t <= eps and when it is the ray's own face; a batch keeps its first
//   lane at the minimum and replaces the best only on a strictly smaller
//   t; the ray is done once best_t <= t_exit + eps; else one DDA step
//   (the axis of the smallest t_max, the first on ties), and the ray dies
//   when it leaves the grid;
// - t (-1 on a miss) and face (-2), an overflow flag when an alive ray's
//   cell holds more than max_batches * B faces, and the most iterations
//   any ray began.
// A ray's result depends on that ray alone, so the kernel runs with no
// host read and the frame around it can be captured as one CUDA graph.
//
// Numerics: built with -fmad=false and IEEE division (kernels/_build.py),
// so each product, sum, quotient and reciprocal rounds as PyTorch's
// elementwise CUDA ops round them; Python-float constants are f32;
// min, max and argmin propagate NaN and take the first index as torch's
// do; the float-to-int cast truncates toward zero.
//
// What bounds it on the H100: operations.  Per (ray, face) test 46 f32
// operations and one IEEE reciprocal; the bytes that must move (the
// rays, the grid, the face table, the outputs) take less time than the
// needed tests at the f32 peak, and -fmad=false issues every product and
// sum on its own, so half that peak is the floor (chip_smoke phase 8a
// prints both).  The per-ray version of this kernel ran at 12% of the
// bound: each lane fetched its cell's faces itself, a serial chain of
// dependent gathers (face index, then its 36-byte row as nine scalar
// loads) per test, although the 32 lanes of a warp mostly stand in the
// same cell (neighbouring mirror rays walk nearly the same cells).
//
// The design:
// - The face table is [F, 12] f32 (v0, e1, e2, 3 pad): a row is three
//   aligned 16-byte loads.
// - The warp runs its rays in rounds, while any lane's ray is running.
//   In a round each running lane skips its empty cells and finds its
//   cell (count, offset, t_exit); then the warp serves its distinct
//   cells one after another, the lowest pending lane's cell first, its
//   lanes found by a ballot on the cell id.  For each batch of that cell
//   the warp's lanes load up to 32 faces at once, lane j face j (its
//   index, then its row), into the warp's slice of shared memory, the
//   face id in the row's pad; a batch wider than 32 is staged in chunks
//   of 32.  The lanes of that cell then test the staged faces in order,
//   reading each row as a broadcast.  So a cell's gathers go out once a
//   warp, in parallel, instead of once a lane in series.
// - A test computes det and u first; when every lane of the cell rejects
//   the face there (|det|, u outside [0, 1]), the lanes skip v and t: the
//   face's t is 0 for all of them, as the full test gives.
// - After its cells, each lane takes its done test and its DDA step.
// - The thread -> ray map takes 8x4 pixel tiles when the wrapper passes
//   the image width (rays in row-major pixel order), so a warp's rays lie
//   closer together; otherwise 32 consecutive rays.  A persistent grid
//   (blocks of 256, at least 4 an SM: at most 64 registers) hands the
//   tiles out from a counter, so warps whose rays walk far do not leave
//   SMs idle at the end.
// Only the loads are shared: every lane tests its own ray, in the same
// order as the per-ray contract, so each ray's result is unchanged.
// On the flagship reflective frame this takes the kernel from 0.34 to
// 0.23 ms; a test then issues ~60 instructions, most of them the
// contract's (PERF.md lists the builds measured beside this one and
// dropped).

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;     // "no hit" t (kernels/_plain.py BIG)

// torch.minimum / maximum / amin / amax on CUDA: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}

// torch's min / argmin over a dim: NaN counts as smallest, ties keep
// the first index.  True when a later candidate v replaces best.
__device__ __forceinline__ bool replaces(float v, float best) {
  return isnan(v) ? !isnan(best) : v < best;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// moller_trumbore_t (trace/primary.py) with abs_t=False for one staged
// face (a, b, c) = (v0.xyz e1.x | e1.yz e2.xy | e2.z id . .), in two
// stages: test_u gives 1/det, u and whether det or u rejects the face;
// test_t then 0 for a reject, else the signed t.  Products and sums in
// core/vecmath.py's order: cross componentwise, dot left-associated.
struct Test {
  float4 a, b, c;
  float inv, u;
  bool reject;
};

__device__ __forceinline__ void test_u(Test& x, const float o[3],
                                       const float d[3], float det_eps) {
  const float e1[3] = {x.a.w, x.b.x, x.b.y};
  const float e2[3] = {x.b.z, x.b.w, x.c.x};
  const float tv[3] = {o[0] - x.a.x, o[1] - x.a.y, o[2] - x.a.z};
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  x.inv = 1.0f / det;
  x.u = (tv[0] * px + tv[1] * py + tv[2] * pz) * x.inv;
  x.reject = fabsf(det) < det_eps || x.u < 0.0f || x.u > 1.0f;
}

__device__ __forceinline__ float test_t(const Test& x, const float o[3],
                                        const float d[3]) {
  const float e1[3] = {x.a.w, x.b.x, x.b.y};
  const float e2[3] = {x.b.z, x.b.w, x.c.x};
  const float tv[3] = {o[0] - x.a.x, o[1] - x.a.y, o[2] - x.a.z};
  const float qx = tv[1] * e1[2] - tv[2] * e1[1];
  const float qy = tv[2] * e1[0] - tv[0] * e1[2];
  const float qz = tv[0] * e1[1] - tv[1] * e1[0];
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * x.inv;
  const float t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * x.inv;
  return x.reject || v < 0.0f || x.u + v > 1.0f ? 0.0f : t;
}

// One staged face tested for this lane's ray, into the batch's (tmin,
// kface): a face is rejected at t <= eps and as the ray's own face; a
// later face replaces only a smaller t (NaN counts as smallest).  Every
// lane of ``group`` calls it for the same face; v and t are skipped when
// all of them reject the face at det or u (its t is then 0 for each, as
// test_t gives).
__device__ __forceinline__ void test_face(const float4* row,
                                          const float o[3],
                                          const float d[3], float eps,
                                          float det_eps, int excl,
                                          unsigned group, float& tmin,
                                          int& kface) {
  Test x;
  x.a = row[0];
  x.b = row[1];
  x.c = row[2];
  test_u(x, o, d, det_eps);
  const float t = __any_sync(group, !x.reject) ? test_t(x, o, d) : 0.0f;
  const int f = __float_as_int(x.c.y);
  if (t <= eps || f == excl) return;
  if (replaces(t, tmin)) {
    tmin = t;
    kface = f;
  }
}

// One DDA step (kernels/uniform_dda.py _advance): the axis of the smallest
// t_max (the first on ties) moves one cell the way d points; t_max +
// onehot * t_delta on every axis, as the plain version's one-hot update;
// a ray that leaves the grid dies, its cell clamped.
__device__ __forceinline__ void advance(int cell[3], float t_max[3],
                                        const float t_delta[3],
                                        const float d[3], const int dims[3],
                                        bool& alive) {
  int axis = 0;
  float m = t_max[0];
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    if (replaces(t_max[a], m)) {
      m = t_max[a];
      axis = a;
    }
  }
  bool out = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int hot = a == axis ? 1 : 0;
    const int c = cell[a] + hot * (d[a] >= 0.0f ? 1 : -1);  // the step
    t_max[a] = t_max[a] + static_cast<float>(hot) * t_delta[a];
    out = out || c < 0 || c >= dims[a];
    cell[a] = clampi(c, 0, dims[a] - 1);
  }
  if (out) alive = false;
}

struct Args {
  const float4* ftab;       // [F, 12] as [F, 3] float4
  int num_faces;
  const int* cell_count;
  const int* cell_offset;
  const int* sorted_faces;
  int cap;
  const float* origins;
  const float* dirs;
  const unsigned char* active;
  const int* exclude;
  const float* lo;
  const float* hi;
  int n, width, gx, gy, gz, batch, max_batches, skip_k;
  float eps, det_eps;
  float* t_out;
  int* face_out;
  int* flags;               // (overflow, most iterations, next tile)
  int* ray_tests;           // [n] or null (counting build)
  long long* warp_work;     // [warps, 3] or null (counting build)
};

// Threads a block, and the blocks an SM the register use must allow.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

// The flags a warp reports once it is done: the most iterations its rays
// began and whether any overflowed.
struct WarpFlags {
  int iters = 0;
  bool overflow = false;
};

// Trace the 32 rays of ``tile`` with this warp; ``staged`` is the warp's
// slice of shared memory.  kCount: the counting build (each ray's
// tests, and the tile's lane slots, cells served and rounds with tests).
template <bool kCount>
__device__ __forceinline__ void trace_tile(const Args& p, int tile,
                                           float4 (*staged)[3],
                                           WarpFlags& wf) {
  const int lane = threadIdx.x & 31;
  int i;
  if (p.width > 0) {
    // 8x4 pixel tiles of a row-major image p.width wide (the wrapper
    // checks that the tiles cover the rays exactly).
    const int tiles_x = p.width >> 3;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    i = (ty * 4 + (lane >> 3)) * p.width + tx * 8 + (lane & 7);
  } else {
    i = tile * 32 + lane;
  }
  const bool valid = i < p.n;
  const int dims[3] = {p.gx, p.gy, p.gz};
  const int num_cells = p.gx * p.gy * p.gz;
  const int max_steps = p.gx + p.gy + p.gz;
  int tests = 0;
  float o[3], d[3];
  float best_t = kBig;
  int best_f = -2;
  int excl = -1;
  int cell[3] = {0, 0, 0};
  float t_max[3] = {0.f, 0.f, 0.f}, t_delta[3] = {0.f, 0.f, 0.f};
  bool running = false;
  if (valid) {
    float lo[3], hi[3], cs[3], inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __ldg(p.lo + a);
      hi[a] = __ldg(p.hi + a);
      cs[a] = (hi[a] - lo[a]) / static_cast<float>(dims[a]);
      o[a] = __ldg(p.origins + 3 * i + a);
      d[a] = __ldg(p.dirs + 3 * i + a);
      inv[a] = 1.0f / (fabsf(d[a]) < 1e-20f ? 1e-20f : d[a]);
    }
    // Slab entry.
    float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t1 = (lo[a] - o[a]) * inv[a];
      const float t2 = (hi[a] - o[a]) * inv[a];
      const float mn = nan_min(t1, t2), mx = nan_max(t1, t2);
      t_near = a == 0 ? mn : nan_max(t_near, mn);
      t_far = a == 0 ? mx : nan_min(t_far, mx);
    }
    const float t_enter =
        (isnan(t_near) ? t_near : (t_near < 0.0f ? 0.0f : t_near)) + p.eps;
    running = t_far > t_enter && __ldg(p.active + i) != 0;
    if (running) {
      excl = __ldg(p.exclude + i);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float p0 = o[a] + t_enter * d[a];
        cell[a] = clampi(static_cast<int>((p0 - lo[a]) / cs[a]), 0,
                         dims[a] - 1);
        const float bound =
            lo[a] + static_cast<float>(cell[a] + (d[a] >= 0.0f ? 1 : 0)) *
                        cs[a];
        t_max[a] = (bound - o[a]) * inv[a];
        t_delta[a] = fabsf(cs[a] * inv[a]);
      }
    }
  }

  long long slots = 0;
  int cells_served = 0, rounds = 0;
  int it = 0;
  while (__any_sync(kFull, running)) {
    // This lane's cell: up to skip_k empty cells skipped first.
    int cid = 0, cnt = 0, off = 0;
    float t_exit = 0.0f;
    if (running) {
      wf.iters = max(wf.iters, it + 1);
      bool alive = true;
      cid = clampi((cell[0] * p.gy + cell[1]) * p.gz + cell[2], 0,
                   num_cells - 1);
      int count = __ldg(p.cell_count + cid);
      for (int s = 0; s < p.skip_k && count == 0; ++s) {
        advance(cell, t_max, t_delta, d, dims, alive);
        if (!alive) break;
        cid = clampi((cell[0] * p.gy + cell[1]) * p.gz + cell[2], 0,
                     num_cells - 1);
        count = __ldg(p.cell_count + cid);
      }
      if (alive) {
        cnt = count;
        off = __ldg(p.cell_offset + cid);
        t_exit = t_max[0];
#pragma unroll
        for (int a = 1; a < 3; ++a) t_exit = nan_min(t_exit, t_max[a]);
        wf.overflow = wf.overflow || cnt > p.max_batches * p.batch;
      } else {
        running = false;
      }
    }

    // The warp's distinct cells, one after another.
    unsigned pending = __ballot_sync(kFull, running && cnt > 0);
    if (kCount && pending) ++rounds;
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const int lcid = __shfl_sync(kFull, cid, leader);
      const int lcnt = __shfl_sync(kFull, cnt, leader);
      const int loff = __shfl_sync(kFull, off, leader);
      const bool mine = ((pending >> lane) & 1u) && cid == lcid;
      const unsigned group = __ballot_sync(kFull, mine);
      pending &= ~group;
      if (kCount) ++cells_served;
      for (int b = 0; b < p.max_batches && b * p.batch < lcnt; ++b) {
        const int lanes = min(p.batch, lcnt - b * p.batch);
        float tmin = kBig;
        int kface = -2;
        for (int c0 = 0; c0 < lanes; c0 += 32) {
          const int chunk = min(32, lanes - c0);
          __syncwarp();  // the last chunk's rows are read
          if (lane < chunk) {
            const int idx = clampi(loff + b * p.batch + c0 + lane, 0,
                                   p.cap - 1);
            const int f =
                clampi(__ldg(p.sorted_faces + idx), 0, p.num_faces - 1);
            const float4* row = p.ftab + 3 * static_cast<size_t>(f);
            const float4 c = __ldg(row + 2);
            staged[lane][0] = __ldg(row);
            staged[lane][1] = __ldg(row + 1);
            staged[lane][2] =
                make_float4(c.x, __int_as_float(f), 0.0f, 0.0f);
          }
          __syncwarp();
          if (kCount) slots += 32 * chunk;
          if (mine) {
            for (int j = 0; j < chunk; ++j) {
              test_face(staged[j], o, d, p.eps, p.det_eps, excl, group,
                        tmin, kface);
            }
            if (kCount) tests += chunk;
          }
        }
        if (mine && tmin < best_t) {
          best_t = tmin;
          best_f = kface;
        }
      }
    }

    // Cells come in increasing t: done once the best hit lies before
    // this cell's exit; else one DDA step.
    if (running) {
      if (best_t <= t_exit + p.eps) {
        running = false;
      } else {
        bool alive = true;
        advance(cell, t_max, t_delta, d, dims, alive);
        ++it;
        running = alive && it < max_steps;
      }
    }
  }

  if (valid) {
    const bool hit = best_t < kBig;
    p.t_out[i] = hit ? best_t : -1.0f;
    p.face_out[i] = hit ? best_f : -2;
    if (kCount) p.ray_tests[i] = tests;
  }
  if (kCount && lane == 0) {
    p.warp_work[3 * tile] = slots;
    p.warp_work[3 * tile + 1] = cells_served;
    p.warp_work[3 * tile + 2] = rounds;
  }
}

// A grid that fills the card: each warp takes its next tile of 32 rays
// from a counter (flags[2]) until none are left.
template <bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    uniform_dda_kernel(const Args p) {
  constexpr int kWarps = kThreads / 32;
  // Each warp's staged faces: 32 rows of three float4.
  __shared__ float4 staged[kWarps][32][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (p.n + 31) / 32;
  WarpFlags wf;
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(p.flags + 2, 1);
    tile = __shfl_sync(kFull, tile, 0);
    if (tile >= tiles) break;
    trace_tile<kCount>(p, tile, staged[warp], wf);
  }
  // One atomic per warp for the flags (every lane reaches here).
  const int most = __reduce_max_sync(kFull, wf.iters);
  const bool any_overflow = __any_sync(kFull, wf.overflow);
  if (lane == 0) {
    if (most > 0) atomicMax(p.flags + 1, most);
    if (any_overflow) atomicOr(p.flags, 1);
  }
}

cudaError_t launch(const Args& a, bool count, cudaStream_t stream) {
  const int tiles = (a.n + 31) / 32;
  constexpr int kWarps = kThreads / 32;
  // The grid that fills the card, asked once per card (the occupancy
  // query costs more host time than the rest of the launch).
  constexpr int kCards = 16;
  static int grids[2][kCards] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int local = 0;
  int& grid = device < kCards ? grids[count][device] : local;
  if (grid == 0) {
    err = ugrt::persistent_grid(count ? uniform_dda_kernel<true>
                                      : uniform_dda_kernel<false>,
                                kThreads, 0, &grid);
    if (err != cudaSuccess) return err;
  }
  const int blocks = min((tiles + kWarps - 1) / kWarps, grid);
  if (count) {
    uniform_dda_kernel<true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    uniform_dda_kernel<false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// ftab [F, 12] f32, 16-byte aligned; cell_count, cell_offset [gx*gy*gz]
// i32; sorted_faces [cap] i32; origins, dirs [n, 3] f32;
// active [n] u8 (bool); exclude [n] i32; lo, hi [3] f32 (device);
// width: the image width of rays in row-major pixel order, for 8x4
// tiles (a multiple of 8 that divides n into rows of tiles 4 high), or 0
// for 32 consecutive rays a warp; out: t [n] f32, face [n] i32, flags
// [3] i32 zeroed by the caller (overflow, most iterations, the tile
// counter); ray_tests [n] i32 and warp_work [ceil(n / 32), 3] i64, both
// null or both set (the counting build: each ray's face tests; each
// tile's lane slots, cells served, rounds with tests).
extern "C" int ugrt_uniform_dda(const void* ftab, int num_faces,
                                const void* cell_count,
                                const void* cell_offset,
                                const void* sorted_faces, int cap,
                                const void* origins, const void* dirs,
                                const void* active, const void* exclude,
                                const void* lo, const void* hi, int n,
                                int width, int gx, int gy, int gz, int batch,
                                int max_batches, int skip_k, float eps,
                                float det_eps, void* t_out, void* face_out,
                                void* flags, void* ray_tests,
                                void* warp_work, void* stream) {
  if (n == 0) return 0;
  Args a;
  a.ftab = static_cast<const float4*>(ftab);
  a.num_faces = num_faces;
  a.cell_count = static_cast<const int*>(cell_count);
  a.cell_offset = static_cast<const int*>(cell_offset);
  a.sorted_faces = static_cast<const int*>(sorted_faces);
  a.cap = cap;
  a.origins = static_cast<const float*>(origins);
  a.dirs = static_cast<const float*>(dirs);
  a.active = static_cast<const unsigned char*>(active);
  a.exclude = static_cast<const int*>(exclude);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.n = n;
  a.width = width;
  a.gx = gx;
  a.gy = gy;
  a.gz = gz;
  a.batch = batch;
  a.max_batches = max_batches;
  a.skip_k = skip_k;
  a.eps = eps;
  a.det_eps = det_eps;
  a.t_out = static_cast<float*>(t_out);
  a.face_out = static_cast<int*>(face_out);
  a.flags = static_cast<int*>(flags);
  a.ray_tests = static_cast<int*>(ray_tests);
  a.warp_work = static_cast<long long*>(warp_work);
  return static_cast<int>(launch(a, ray_tests != nullptr,
                                 static_cast<cudaStream_t>(stream)));
}
