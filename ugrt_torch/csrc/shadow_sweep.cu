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
// What bounds it on the H100: ~30 flops and one sqrt per (ray,
// triangle); on the flagship the sorted shadow rays of a block share a
// few light cells, so most of a block's windows are read by all its
// rays.  The design stages one window (16 KB at 256 wide) in shared
// memory per step and keeps the ray in registers; a block stops early
// once every one of its rays is shadowed (__syncthreads_and), which
// cannot change an OR.  Each block walks its own window range, so there
// is no schedule, no work capacity and no overflow that could drop
// occlusion (ugrt's shadow.py:458-462, :485-486).

#include "sweep.cuh"

namespace {

using namespace ugrt;
// intersectTri's accept bound (light_kernel.cu:43-47); 999999.9 rounds
// to 999999.875 in f32 from the decimal and from the double alike.
constexpr float kTMax = 999999.9f;

__global__ void __launch_bounds__(kRays)
shadow_sweep_kernel(const float* __restrict__ tri, int nw, int win,
                    const float* __restrict__ rays,
                    const int* __restrict__ w_lo,
                    const int* __restrict__ w_hi, float eps,
                    float shadow_eps, int accept_negative_t, int box,
                    int* __restrict__ sh_out) {
  extern __shared__ float4 s_win[];
  const float* s = reinterpret_cast<const float*>(s_win);
  const int b = blockIdx.x;
  const size_t ray = static_cast<size_t>(b) * kRays + threadIdx.x;
  const float* r = rays + ray * 8;
  const float dx = r[0], dy = r[1], dz = r[2], dist_pt = r[3];
  const float cell = r[4], gx = r[5], gy = r[6];

  const int lo = max(w_lo[b], 0);
  const int hi = min(w_hi[b], nw - 1);
  int occluded = 0;
  for (int w = lo; w <= hi; ++w) {
    stage(s_win,
          reinterpret_cast<const float4*>(tri + static_cast<size_t>(w) *
                                                    win * kComp),
          win * kComp / 4);
    __syncthreads();
    for (int q = 0; q < win; ++q) {
      const float* c = s + q * kComp;
      const float det = dx * c[0] + dy * c[1] + dz * c[2];
      const float inv_det = 1.0f / det;
      const float u = (dx * c[3] + dy * c[4] + dz * c[5]) * inv_det;
      const float v = (dx * c[6] + dy * c[7] + dz * c[8]) * inv_det;
      const float t = c[9] * inv_det;
      const bool admitted =
          box ? ((gx >= c[11]) & (gx <= c[12]) & (gy >= c[13]) &
                 (gy <= c[14]))
              : (c[10] == cell);
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
    // Doubles as the fence before the next window overwrites s_win.
    if (__syncthreads_and(occluded)) break;
  }
  sh_out[ray] = occluded;
}

}  // namespace

// Launches K3 on `stream`: one block per 128-ray block over windows of
// `win` rows (a multiple of 4; 16 * win f32 of dynamic shared memory).
extern "C" int ugrt_shadow_sweep(const void* tri, int nw, int win,
                                 const void* rays, int nb, const void* w_lo,
                                 const void* w_hi, float eps,
                                 float shadow_eps, int accept_negative_t,
                                 int box, void* sh_out, void* stream) {
  if (nb == 0) return 0;
  const size_t smem = static_cast<size_t>(win) * ugrt::kComp * sizeof(float);
  shadow_sweep_kernel<<<nb, ugrt::kRays, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri), nw, win,
      static_cast<const float*>(rays), static_cast<const int*>(w_lo),
      static_cast<const int*>(w_hi), eps, shadow_eps, accept_negative_t, box,
      static_cast<int*>(sh_out));
  return static_cast<int>(cudaGetLastError());
}
