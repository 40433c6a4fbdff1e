// K3 — shadow sweep (occlusion), one kernel for both call sites.
//
// Replaces the Pallas kernel _shadow_kernel + _shadow_body
// (ugrt/trace/pallas_tracer.py:390-472), launched from
// ugrt/trace/shadow.py:455 over 256-wide windows of the light grid's
// sorted pair array (admission by cell key) and from :481 with box=True
// over 128-wide heavy windows (admission when the ray's light cell
// (gx, gy) lies in the face's footprint box).
//
// Coefficient-form test per (ray, triangle): det = d.a, inv = 1/det,
// u = (d.b)*inv, v = (d.c)*inv, t = k*inv; reject |det| < eps, u < 0,
// u > 1, v < 0, u + v > 1 or not admitted; a hit needs t != 0 and
// t < 999999.9 (negative t accepted under the shadow_accept_negative_t
// quirk); the ray is shadowed if |t*d| + shadow_eps < dist_pt.  Rays
// combine by OR, so window order does not matter.
//
// What bounds it on the H100: ~30 flops, an IEEE division and a square
// root per (ray, row), some 60 instructions, on rows staged in shared
// memory and read by all 128 rays of a block: instruction throughput,
// not bytes (the inputs are ~75 MB).  Two things made the first port
// (one CUDA block per ray block walking its own range) 20x slower than
// the work needs on the flagship windowed frame (16.6 ms):
// - the ranges are skewed: the mean is 1.2 windows of 256 rows, the
//   longest 389, and that one block, alone on its SM, was the time;
// - most tested rows cannot matter: a ray needs only the rows of its own
//   cell (key site) or of footprints that hold its cell (box site), 1 in
//   46 (key) and 1 in 5 (box) of the rows its block walks.
//
// The design cuts every block's range into chunks of at most `chunk`
// windows; a chunk is one work item (ray block, first window, last
// window).  A persistent grid (as many blocks as fit on every SM) takes
// items from a device counter with atomicAdd, so an SM that finishes
// early takes the next item and no SM waits on a long range.  A thread
// block's first warp finds an item's ray block by a 32-way search over
// `item_end` (decode_item, sweep.cuh), the inclusive prefix sum of the
// chunk counts, whose last entry is the number of items: nothing is
// sized on the host and no item can be dropped (no schedule, no
// capacity, no overflow such as ugrt's shadow.py:458-462, :485-486).
// Items merge by OR without atomics: the flags start zeroed and a thread
// stores 1 only where its ray is occluded, so the result is independent
// of the order of the items and bitwise repeatable.
//
// Work that cannot change an OR is skipped, so the result stays exactly
// that of every test: an item starts from the flags that other items of
// its block have already set and stops once all its rays are shadowed
// (__syncthreads_and); within a window, a warp skips the arithmetic of a
// row that none of its 32 rays both admits and still needs (a
// warp-uniform vote, so no lane diverges).  The per-row arithmetic and
// its order are those of the first port, unchanged.

#include "sweep.cuh"

namespace {

using namespace ugrt;
// intersectTri's accept bound (light_kernel.cu:43-47); 999999.9 rounds
// to 999999.875 in f32 from the decimal and from the double alike.
constexpr float kTMax = 999999.9f;

__global__ void __launch_bounds__(kRays)
shadow_sweep_kernel(const float* __restrict__ tri, int nw, int win,
                    const float* __restrict__ rays, int nb,
                    const int* __restrict__ w_lo,
                    const int* __restrict__ w_hi,
                    const int* __restrict__ item_end, int chunk, float eps,
                    float shadow_eps, int accept_negative_t, int box,
                    int* __restrict__ counter, int* sh_out) {
  extern __shared__ float4 s_win[];
  __shared__ int s_item[3];            // ray block (-1: no work left), w0, w1
  const float* s = reinterpret_cast<const float*>(s_win);
  for (;;) {
    if (threadIdx.x < 32) {
      int item = 0;
      if (threadIdx.x == 0) item = atomicAdd(counter, 1);
      decode_item(__shfl_sync(kFull, item, 0), item_end, nb, w_lo, w_hi, nw,
                  chunk, s_item);
    }
    // Every thread reads s_item before the window loop's first barrier,
    // so warp 0 cannot overwrite it for the next item too early.
    __syncthreads();
    const int b = s_item[0];
    if (b < 0) break;
    const int w0 = s_item[1], w1 = s_item[2];

    const size_t ray = static_cast<size_t>(b) * kRays + threadIdx.x;
    const float* r = rays + ray * 8;
    const float dx = r[0], dy = r[1], dz = r[2], dist_pt = r[3];
    const float cell = r[4], gx = r[5], gy = r[6];
    // Set by another item of this block: stays 1 whatever this one finds.
    const int known = __ldcg(sh_out + ray);
    int occluded = known;
    for (int w = w0; w <= w1; ++w) {
      // Doubles as the fence before this window overwrites s_win.
      if (__syncthreads_and(occluded)) break;
      stage(s_win,
            reinterpret_cast<const float4*>(tri + static_cast<size_t>(w) *
                                                      win * kComp),
            win * kComp / 4);
      __syncthreads();
      for (int q = 0; q < win; ++q) {
        const float* c = s + q * kComp;
        const bool admitted =
            box ? ((gx >= c[11]) & (gx <= c[12]) & (gy >= c[13]) &
                   (gy <= c[14]))
                : (c[10] == cell);
        // Every lane runs the same rows, so the vote is warp-uniform.
        if (!__any_sync(0xffffffffu, admitted & !occluded)) continue;
        const float det = dx * c[0] + dy * c[1] + dz * c[2];
        const float inv_det = 1.0f / det;
        const float u = (dx * c[3] + dy * c[4] + dz * c[5]) * inv_det;
        const float v = (dx * c[6] + dy * c[7] + dz * c[8]) * inv_det;
        const float t = c[9] * inv_det;
        const bool reject = (fabsf(det) < eps) | (u < 0.0f) | (u > 1.0f) |
                            (v < 0.0f) | (u + v > 1.0f) | !admitted;
        bool hit = !reject & (t != 0.0f) & (t < kTMax);
        if (!accept_negative_t) hit &= t > 0.0f;
        const float ox = t * dx;
        const float oy = t * dy;
        const float oz = t * dz;
        const float dist_occ = sqrtf(ox * ox + oy * oy + oz * oz);
        occluded |= hit & (dist_occ + shadow_eps < dist_pt);
      }
    }
    if (occluded && !known) sh_out[ray] = 1;
  }
}

}  // namespace

// Launches K3 on `stream` as a persistent grid over the items of
// `item_end` (int32 [nb], inclusive prefix sum of each ray block's chunk
// count).  `counter` (one int32) and `sh_out` (int32 [nb, 128]) must be
// zero on `stream` before the launch.  Windows are `win` rows (a
// multiple of 4; 16 * win f32 of dynamic shared memory, at most 48 KB).
extern "C" int ugrt_shadow_sweep(const void* tri, int nw, int win,
                                 const void* rays, int nb, const void* w_lo,
                                 const void* w_hi, const void* item_end,
                                 int chunk, float eps, float shadow_eps,
                                 int accept_negative_t, int box,
                                 void* counter, void* sh_out, void* stream) {
  if (nb == 0) return 0;
  const size_t smem = static_cast<size_t>(win) * ugrt::kComp * sizeof(float);
  int grid = 0;
  const cudaError_t err =
      ugrt::persistent_grid(shadow_sweep_kernel, ugrt::kRays, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  shadow_sweep_kernel<<<grid, ugrt::kRays, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri), nw, win,
      static_cast<const float*>(rays), nb, static_cast<const int*>(w_lo),
      static_cast<const int*>(w_hi), static_cast<const int*>(item_end), chunk,
      eps, shadow_eps, accept_negative_t, box, static_cast<int*>(counter),
      static_cast<int*>(sh_out));
  return static_cast<int>(cudaGetLastError());
}
