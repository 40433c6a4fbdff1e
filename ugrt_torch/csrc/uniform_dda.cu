// D1 — the uniform-grid DDA of the reflection rays, one thread per ray.
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
//
// ugrt's chunking and the plain version's compaction only decide which
// rays share a step; a ray's result depends on that ray alone, so one
// thread runs its whole loop in registers with no host read, and the
// frame around it can be captured as one CUDA graph.
//
// Numerics: built with -fmad=false and IEEE division (kernels/_build.py),
// so each product, sum, quotient and reciprocal rounds as PyTorch's
// elementwise CUDA ops round them; Python-float constants are f32;
// min, max and argmin propagate NaN and take the first index as torch's
// do; the float-to-int cast truncates toward zero.
//
// What bounds it on the H100: operations.  Per (ray, face) test ~46 f32
// operations and one IEEE reciprocal on a gather of 36 bytes from the
// [F, 9] face table (2.7 MB at the flagship) through a CSR index, all of
// which stay in the 50 MB L2; the bytes that must move (the rays, the
// grid, the table, the outputs) take less time than the needed tests at
// the f32 peak (chip_smoke phase 8a prints both).  What costs above that
// is divergence (the lanes of a warp walk different numbers of cells and
// faces) and the latency of the dependent gathers (cell count -> offset
// -> face -> row).  This first version is simple and right: rays in
// pixel order, so a warp holds 32 neighbouring reflection rays, whose
// mirror rays walk nearly the same cells; __ldg reads, no shared memory.
// Warp-cooperative batches and ray sorting are left to a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

// moller_trumbore_t (trace/primary.py) with abs_t=False for one face row
// (v0, e1, e2): 0 for a reject, else the signed t.  Products and sums in
// core/vecmath.py's order: cross componentwise, dot left-associated.
__device__ __forceinline__ float face_t(const float* __restrict__ row,
                                        const float o[3], const float d[3],
                                        float det_eps) {
  float v0[3], e1[3], e2[3], tv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v0[a] = __ldg(row + a);
    e1[a] = __ldg(row + 3 + a);
    e2[a] = __ldg(row + 6 + a);
    tv[a] = o[a] - v0[a];
  }
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  const float inv = 1.0f / det;
  const float u = (tv[0] * px + tv[1] * py + tv[2] * pz) * inv;
  const float qx = tv[1] * e1[2] - tv[2] * e1[1];
  const float qy = tv[2] * e1[0] - tv[0] * e1[2];
  const float qz = tv[0] * e1[1] - tv[1] * e1[0];
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
  const float t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv;
  const bool reject = fabsf(det) < det_eps || u < 0.0f || u > 1.0f ||
                      v < 0.0f || u + v > 1.0f;
  return reject ? 0.0f : t;
}

// One DDA step (kernels/uniform_dda.py _advance): the axis of the smallest
// t_max (the first on ties) moves one cell; t_max + onehot * t_delta on
// every axis, as the plain version's one-hot update; a ray that leaves
// the grid dies, its cell clamped.
__device__ __forceinline__ void advance(int cell[3], float t_max[3],
                                        const float t_delta[3],
                                        const int step[3], const int dims[3],
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
    const int c = cell[a] + hot * step[a];
    t_max[a] = t_max[a] + static_cast<float>(hot) * t_delta[a];
    out = out || c < 0 || c >= dims[a];
    cell[a] = clampi(c, 0, dims[a] - 1);
  }
  if (out) alive = false;
}

__global__ void __launch_bounds__(kThreads) uniform_dda_kernel(
    const float* __restrict__ ftab, int num_faces,
    const int* __restrict__ cell_count, const int* __restrict__ cell_offset,
    const int* __restrict__ sorted_faces, int cap,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const unsigned char* __restrict__ active,
    const int* __restrict__ exclude, const float* __restrict__ lo_p,
    const float* __restrict__ hi_p, int n, int gx, int gy, int gz,
    int batch, int max_batches, int skip_k, float eps, float det_eps,
    float* __restrict__ t_out, int* __restrict__ face_out,
    int* __restrict__ flags, int* __restrict__ ray_tests) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int dims[3] = {gx, gy, gz};
  const int num_cells = gx * gy * gz;
  int iters = 0;
  bool overflow = false;
  if (i < n) {
    float lo[3], hi[3], cs[3], o[3], d[3], inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __ldg(lo_p + a);
      hi[a] = __ldg(hi_p + a);
      cs[a] = (hi[a] - lo[a]) / static_cast<float>(dims[a]);
      o[a] = __ldg(origins + 3 * i + a);
      d[a] = __ldg(dirs + 3 * i + a);
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
        (isnan(t_near) ? t_near : (t_near < 0.0f ? 0.0f : t_near)) + eps;
    const bool inside = t_far > t_enter && __ldg(active + i) != 0;

    float best_t = kBig;
    int best_f = -2;
    int tests = 0;
    if (inside) {
      const int excl = __ldg(exclude + i);
      int cell[3], step[3];
      float t_max[3], t_delta[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float p0 = o[a] + t_enter * d[a];
        cell[a] = clampi(static_cast<int>((p0 - lo[a]) / cs[a]), 0,
                         dims[a] - 1);
        step[a] = d[a] >= 0.0f ? 1 : -1;
        const float bound =
            lo[a] + static_cast<float>(cell[a] + (step[a] > 0 ? 1 : 0)) *
                        cs[a];
        t_max[a] = (bound - o[a]) * inv[a];
        t_delta[a] = fabsf(cs[a] * inv[a]);
      }
      bool alive = true;
      const int max_steps = gx + gy + gz;
      for (int it = 0; it < max_steps && alive; ++it) {
        iters = it + 1;
        // Empty-space skipping: up to skip_k empty cells.
        for (int s = 0; s < skip_k && alive; ++s) {
          const int cid =
              clampi((cell[0] * gy + cell[1]) * gz + cell[2], 0,
                     num_cells - 1);
          if (__ldg(cell_count + cid) != 0) break;
          advance(cell, t_max, t_delta, step, dims, alive);
        }
        if (!alive) break;
        float t_exit = t_max[0];
#pragma unroll
        for (int a = 1; a < 3; ++a) t_exit = nan_min(t_exit, t_max[a]);
        const int cid = clampi((cell[0] * gy + cell[1]) * gz + cell[2], 0,
                               num_cells - 1);
        const int cnt = __ldg(cell_count + cid);
        const int off = __ldg(cell_offset + cid);
        overflow = overflow || cnt > max_batches * batch;
        for (int b = 0; b < max_batches && b * batch < cnt; ++b) {
          const int lanes = min(batch, cnt - b * batch);
          float tmin = kBig;
          int kface = -2;
          for (int j = 0; j < lanes; ++j) {
            const int idx = clampi(off + b * batch + j, 0, cap - 1);
            const int f = clampi(__ldg(sorted_faces + idx), 0, num_faces - 1);
            const float t = face_t(ftab + 9 * static_cast<size_t>(f), o, d,
                                   det_eps);
            ++tests;
            if (t <= eps || f == excl) continue;
            if (replaces(t, tmin)) {
              tmin = t;
              kface = f;
            }
          }
          if (tmin < best_t) {
            best_t = tmin;
            best_f = kface;
          }
        }
        // Cells come in increasing t: done once the best hit lies before
        // this cell's exit.
        if (best_t <= t_exit + eps) break;
        advance(cell, t_max, t_delta, step, dims, alive);
      }
    }
    const bool hit = best_t < kBig;
    t_out[i] = hit ? best_t : -1.0f;
    face_out[i] = hit ? best_f : -2;
    if (ray_tests != nullptr) ray_tests[i] = tests;
  }
  // One atomic per warp for the flags (every lane reaches here).
  const int most = __reduce_max_sync(0xffffffffu, iters);
  const bool any_overflow = __any_sync(0xffffffffu, overflow);
  if ((threadIdx.x & 31) == 0) {
    if (most > 0) atomicMax(flags + 1, most);
    if (any_overflow) atomicOr(flags, 1);
  }
}

}  // namespace

// ftab [F, 9] f32; cell_count, cell_offset [gx*gy*gz] i32; sorted_faces
// [cap] i32; origins, dirs [n, 3] f32; active [n] u8 (bool); exclude [n]
// i32; lo, hi [3] f32 (device); out: t [n] f32, face [n] i32, flags [2]
// i32 zeroed by the caller (overflow, most iterations); ray_tests [n] i32
// or null (each ray's face tests, for measurement).
extern "C" int ugrt_uniform_dda(const void* ftab, int num_faces,
                                const void* cell_count,
                                const void* cell_offset,
                                const void* sorted_faces, int cap,
                                const void* origins, const void* dirs,
                                const void* active, const void* exclude,
                                const void* lo, const void* hi, int n, int gx,
                                int gy, int gz, int batch, int max_batches,
                                int skip_k, float eps, float det_eps,
                                void* t_out, void* face_out, void* flags,
                                void* ray_tests, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  uniform_dda_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), num_faces,
      static_cast<const int*>(cell_count),
      static_cast<const int*>(cell_offset),
      static_cast<const int*>(sorted_faces), cap,
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const unsigned char*>(active),
      static_cast<const int*>(exclude), static_cast<const float*>(lo),
      static_cast<const float*>(hi), n, gx, gy, gz, batch, max_batches,
      skip_k, eps, det_eps, static_cast<float*>(t_out),
      static_cast<int*>(face_out), static_cast<int*>(flags),
      static_cast<int*>(ray_tests));
  return static_cast<int>(cudaGetLastError());
}
