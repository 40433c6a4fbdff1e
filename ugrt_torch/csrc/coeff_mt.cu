// S1 — coefficient-form Möller–Trumbore as a product: tensor cores
// (mma.sync TF32) against CUDA-core FMA-free dots, as a probe of which
// unit K1-K3 should use.
//
// Replaces the Pallas probes mxu_kernel and vpu_kernel of
// scripts/micro_mxu.py:26-64 (launched at :80).  Per item i, with
// it = items[i], T = tri[it] (f32 [24, 256]: component-major rows of 256
// triangles) and D = rays[it % n_rays] (f32 [8, 128]: component-major
// rows of 128 rays), for every triangle m and ray n:
//
//   mma: det = sum_{c<8} T[c][m] D[c][n], up over T[8:16], vp over
//        T[16:24] — three [256 x 8] . [8 x 128] products;
//   fma: det = dx*T[0][m] + dy*T[1][m] + dz*T[2][m] (left-associated, no
//        FMA contraction), up over T[8:11], vp over T[16:19];
//
// then u = up * (1/det), v = vp * (1/det), written as det/u/v f32
// [n_tri, 256, 128] at row it.  The mma kernel is hand-written
// mma.sync.aligned.m16n8k8 TF32 (inline PTX): "highest" splits each
// operand x into big = tf32(x) and small = tf32(x - big) and sums
// small*big + big*small + big*big (3xTF32, ~f32 accuracy); "default"
// takes one big*big product.  fma is bitwise equal to its plain version.
//
// What bounds it on the H100: the outputs.  3 x 256 x 128 x 4 B = 384 KB
// per item against a few KFLOP of math per (tri, ray) row group: at the
// script's 4096 items, 1.61 GB of writes take >= 0.48 ms at 3.35 TB/s,
// while the math is ~1-5 GFLOP.  Both kernels stage T and D of an item
// in shared memory (28 KB) and stream det/u/v out in full 32-byte
// sectors; the tensor-core product only changes where the math runs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTri = 256;     // triangles per item (WIN)
constexpr int kRayN = 128;    // rays per item (NR)
constexpr int kTriC = 24;     // triangle components
constexpr int kRayC = 8;      // ray components
constexpr int kThreads = 256;

// Stage T (24 x 256) and D (8 x 128) of item `it` into shared memory.
__device__ __forceinline__ void stage_item(float (*ts)[kTri],
                                           float (*rs)[kRayN],
                                           const float* tri,
                                           const float* rays, int it,
                                           int n_rays) {
  const float* t = tri + static_cast<size_t>(it) * kTriC * kTri;
  const float* r = rays + static_cast<size_t>(it % n_rays) * kRayC * kRayN;
  for (int j = threadIdx.x; j < kTriC * kTri; j += kThreads)
    ts[j / kTri][j % kTri] = t[j];
  for (int j = threadIdx.x; j < kRayC * kRayN; j += kThreads)
    rs[j / kRayN][j % kRayN] = r[j];
}

__device__ __forceinline__ int item_at(const int* items, int i, int n_tri) {
  return min(max(items[i], 0), n_tri - 1);
}

__global__ void __launch_bounds__(kThreads)
coeff_mt_fma_kernel(const int* __restrict__ items, int n_tri,
                    const float* __restrict__ tri,
                    const float* __restrict__ rays, int n_rays,
                    float* __restrict__ det_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  __shared__ float ts[kTriC][kTri];
  __shared__ float rs[kRayC][kRayN];
  const int it = item_at(items, blockIdx.x, n_tri);
  stage_item(ts, rs, tri, rays, it, n_rays);
  __syncthreads();
  const size_t base = static_cast<size_t>(it) * kTri * kRayN;
  const int n = threadIdx.x % kRayN;
  const float dx = rs[0][n], dy = rs[1][n], dz = rs[2][n];
  for (int m = threadIdx.x / kRayN; m < kTri; m += kThreads / kRayN) {
    const float det = dx * ts[0][m] + dy * ts[1][m] + dz * ts[2][m];
    const float up = dx * ts[8][m] + dy * ts[9][m] + dz * ts[10][m];
    const float vp = dx * ts[16][m] + dy * ts[17][m] + dz * ts[18][m];
    const float inv = 1.0f / det;
    const size_t o = base + static_cast<size_t>(m) * kRayN + n;
    det_out[o] = det;
    u_out[o] = up * inv;
    v_out[o] = vp * inv;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~ big + small, both TF32 (small = 0 unless split).
__device__ __forceinline__ void split_tf32(float x, bool split,
                                           uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = split ? to_tf32(x - __uint_as_float(big)) : 0u;
}

// d += a . b for one m16n8k8 tile (row-major A, column-major B).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight warps per item; warp w owns triangle rows [32w, 32w + 32) as two
// m16 tiles and walks the 16 n8 tiles of rays.  Fragment layout of
// m16n8k8 TF32 (PTX ISA), lane = 4 * g + q:
//   A: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B: b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C: c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// with A[m][k] = T[8 * p + k][m] for product p (det, up, vp) and
// B[k][n] = D[k][n].
__global__ void __launch_bounds__(kThreads)
coeff_mt_mma_kernel(const int* __restrict__ items, int n_tri,
                    const float* __restrict__ tri,
                    const float* __restrict__ rays, int n_rays, int split,
                    float* __restrict__ det_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  __shared__ float ts[kTriC][kTri];
  __shared__ float rs[kRayC][kRayN];
  const int it = item_at(items, blockIdx.x, n_tri);
  stage_item(ts, rs, tri, rays, it, n_rays);
  __syncthreads();
  const size_t base = static_cast<size_t>(it) * kTri * kRayN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const bool sp = split != 0;

  for (int mt = 0; mt < 2; ++mt) {
    const int m0 = warp * 32 + mt * 16;
    uint32_t a_big[3][4], a_small[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      split_tf32(ts[8 * p + q][m0 + g], sp, a_big[p][0], a_small[p][0]);
      split_tf32(ts[8 * p + q][m0 + g + 8], sp, a_big[p][1], a_small[p][1]);
      split_tf32(ts[8 * p + q + 4][m0 + g], sp, a_big[p][2], a_small[p][2]);
      split_tf32(ts[8 * p + q + 4][m0 + g + 8], sp, a_big[p][3],
                 a_small[p][3]);
    }
    for (int nt = 0; nt < kRayN / 8; ++nt) {
      const int n0 = nt * 8;
      uint32_t b_big[2], b_small[2];
      split_tf32(rs[q][n0 + g], sp, b_big[0], b_small[0]);
      split_tf32(rs[q + 4][n0 + g], sp, b_big[1], b_small[1]);
      float acc[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;
        if (sp) {
          mma_tf32(acc[p], a_small[p], b_big);
          mma_tf32(acc[p], a_big[p], b_small);
        }
        mma_tf32(acc[p], a_big[p], b_big);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // rows g and g + 8
        const size_t o =
            base + static_cast<size_t>(m0 + g + 8 * h) * kRayN + n0 + 2 * q;
        const float det0 = acc[0][2 * h], det1 = acc[0][2 * h + 1];
        const float inv0 = 1.0f / det0, inv1 = 1.0f / det1;
        *reinterpret_cast<float2*>(det_out + o) = make_float2(det0, det1);
        *reinterpret_cast<float2*>(u_out + o) =
            make_float2(acc[1][2 * h] * inv0, acc[1][2 * h + 1] * inv1);
        *reinterpret_cast<float2*>(v_out + o) =
            make_float2(acc[2][2 * h] * inv0, acc[2][2 * h + 1] * inv1);
      }
    }
  }
}

}  // namespace

// Both entry points: items int32 [n_items] (each clamped to [0, n_tri)),
// tri f32 [n_tri, 24, 256], rays f32 [n_rays, 8, 128]; det/u/v f32
// [n_tri, 256, 128], rows not named by items left unwritten.  One block
// of 256 threads per item, on `stream`.

extern "C" int ugrt_coeff_mt_fma(const void* items, int n_items,
                                 const void* tri, int n_tri,
                                 const void* rays, int n_rays, void* det,
                                 void* u, void* v, void* stream) {
  if (n_items == 0) return 0;
  coeff_mt_fma_kernel<<<n_items, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(items), n_tri, static_cast<const float*>(tri),
      static_cast<const float*>(rays), n_rays, static_cast<float*>(det),
      static_cast<float*>(u), static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}

// split = 1: "highest" (3xTF32); split = 0: "default" (1xTF32).
extern "C" int ugrt_coeff_mt_mma(const void* items, int n_items,
                                 const void* tri, int n_tri,
                                 const void* rays, int n_rays, int split,
                                 void* det, void* u, void* v, void* stream) {
  if (n_items == 0) return 0;
  coeff_mt_mma_kernel<<<n_items, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(items), n_tri, static_cast<const float*>(tri),
      static_cast<const float*>(rays), n_rays, split,
      static_cast<float*>(det), static_cast<float*>(u),
      static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}
