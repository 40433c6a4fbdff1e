// K3 — shadow sweep (occlusion), one kernel source for its three call
// sites.
//
// Replaces the Pallas kernel _shadow_kernel + _shadow_body
// (ugrt/trace/pallas_tracer.py:390-472), launched from
// ugrt/trace/shadow.py:455 over 256-wide windows of the light grid's
// sorted pair array (admission by cell key) and from :481 with box=True
// over 128-wide heavy windows (admission when the ray's light cell
// (gx, gy) lies in the face's footprint box).
//
// The contract, unchanged since the first port: per (ray, triangle) the
// coefficient-form test det = d.a, inv = 1/det, u = (d.b)*inv,
// v = (d.c)*inv, t = k*inv; reject |det| < eps, u < 0, u > 1, v < 0,
// u + v > 1 or not admitted; a hit needs t != 0 and t < 999999.9
// (negative t accepted under the shadow_accept_negative_t quirk); the
// ray is shadowed if |t*d| + shadow_eps < dist_pt.  A ray's flag is the
// OR of its tests over the admitted rows of its block's window range, so
// the order of the tests is free, and a test that cannot set a flag
// that is still clear may be skipped: the flags stay exactly those of
// every test, and bitwise repeatable (a thread stores only 1 into flags
// that start zeroed).  Every test that runs does _shadow_body's
// operations in its order (occludes()).
//
// Work items: each ray block's range cut into chunks of at most `chunk`
// windows; a persistent grid takes them from a device counter
// (decode_item, sweep.cuh), so nothing is sized on the host and a long
// range does not hold one SM (the skew that made the first port 16.6 ms
// on the windowed frame: 1.2 windows a block on average, 389 at most).
//
// Two walks over an item, picked by the call site (kernels/shadow_sweep.py,
// `serial`; trace/shadow.py):
//
// Block walk (windowed light grid: key and box sites).  A thread block
// stages each window into shared memory and each warp runs a row
// against its 32 rays at once.  Skipped: rows that no lane of the warp
// both admits and still needs (a warp-uniform vote: on the windowed
// frame a ray needs 1 row in 46 of its block's walk at the key site),
// and the rest of an item once all its 128 rays are occluded
// (__syncthreads_and).  Neither skip drops a test that could set a
// flag still clear: the rows skipped are unadmitted or belong to
// occluded rays.
//
// Serial walk (reference and extent light grids: key site).  There the
// pi extent puts all 1,048,576 rays of the flagship frame into 7 light
// cells, so a ray admits ~1,100 rows (5.63 windows a block) and 92% of
// the rays are shadowed, but late in the walk: the first occluder sits at
// 64-86% (p10-p90) of a ray's admitted rows, so the block walk ran 99% of
// its lane slots on needed tests (PERF.md §6: the counting build on an
// NVIDIA H100 80GB HBM3 at 700 W).  What the counts found instead: 99.55%
// of the shadowed rays are occluded within the 32-row group that first
// occluded the ray before them in pixel order.  So the serial walk tests
// that group first (occluder-first order):
// - A warp takes a quarter of a ray block and its rays one after
//   another; a step tests one ray against 32 rows, lane l row l of the
//   group, its components read from a component-major copy of the rows
//   (`cols`, 128 coalesced bytes a component).
// - Pass 1: a ray first tests its hint: the group that occluded the ray
//   before it, or the group hints[] holds for its cell (another warp's
//   find; only a guess, checked to lie in the item).  On a miss it walks
//   the item's other groups in order and stops at the first that
//   occludes it, which becomes the hint.  A walk that ends without an
//   occluder (a lit ray) turns walks off until a hint occludes a ray
//   again; meanwhile the rays a hint misses go to `rest` with the group
//   they tested, so that a run of lit rays is spread over every warp in
//   pass 2 instead of keeping one warp walking alone.
// - Pass 2 (a second launch): each warp takes a ray of `rest` and walks
//   its item's groups but the one it tested, to the first that occludes.
// So every ray tests every group of its item until one occludes it: a
// stop at an occluding group drops only tests of a ray whose flag is set.
// - Within a step, a warp skips the group where no lane admits its row,
//   and the division and everything after it where the t-free test
//   (surely_rejected, proved below) clears every admitting lane.
// On the flagship reference frame the serial walk ran 5.1 M steps
// (160 M lane tests) where the block walk ran 30.4 M (964 M), on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

#include "sweep.cuh"

namespace {

using namespace ugrt;
// intersectTri's accept bound (light_kernel.cu:43-47); 999999.9 rounds
// to 999999.875 in f32 from the decimal and from the double alike.
constexpr float kTMax = 999999.9f;
constexpr int kGroup = 32;             // rows a warp step of the serial walk
constexpr int kWarps = kRays / 32;
constexpr int kHints = 1024;           // hint slots, by cell key

// The serial walk's two passes (two launches on one stream).
enum Walk { kHinted, kRest };

// Counts of a counting build (kStats), int64 each, in this order; the
// wrapper names them (kernels/shadow_sweep.py, STATS).  A warp step is
// one pass over the warp's 32 lanes: a row against 32 rays (block walk)
// or a ray against 32 rows (serial walk).
enum Stat {
  kItems,            // work items run (serial walk: warp items of pass 1)
  kUnstaged,         // block walk: windows not staged, all rays occluded
  kKnownRays,        // serial walk: rays already flagged when their item began
  kVoteSkipped,      // warp steps skipped: no lane admits a row it needs
  kExecuted,         // warp steps past that vote
  kLiveTests,        // their lanes that admit and still need the row
  kPreSkipped,       // serial walk: warp steps skipped at the t-free vote
  kDividedSteps,     // warp steps that ran the division
  kDividedTests,     // their lanes that admit, need and passed any t-free test
  kHintSteps,        // serial walk: steps on a hinted group (pass 1)
  kHintHits,         // ... that occluded the ray
  kDeferred,         // serial walk: rays that pass 2 walked
  kNumStats
};

// ---- The test, in two parts ----
//
// d.a, d.b and d.c of ray d against row c, in _shadow_body's order.
struct Dots {
  float det, up, vp;
};

__device__ __forceinline__ Dots dots(float dx, float dy, float dz,
                                     const float* c) {
  return {dx * c[0] + dy * c[1] + dz * c[2], dx * c[3] + dy * c[4] + dz * c[5],
          dx * c[6] + dy * c[7] + dz * c[8]};
}

// True only where the exact test below rejects, decided without the
// division.  With a = |det|, U and V the dot products d.b, d.c times the
// sign of det (a negation, exact), inv = RN(1/det) (RN: round to nearest
// even; u = 2^-24), u = RN(up * inv) and v = RN(vp * inv):
// - a < eps is the exact test's own first rejection.
// Every other clause needs 2^-64 <= a <= 2^64 (false for NaN and inf):
// then 1/a is a normal float, so |inv| >= (1/a)(1 - u) and inv has
// det's sign, and q = RN(a (1 + 2^-17)) >= a (1 + 2^-17)(1 - u) is normal.
// - U <= -2^-64: up * inv is negative with |up * inv| >= 2^-128 (1 - u),
//   above the least denormal 2^-149 (denormals are kept), so u < 0 (or
//   -inf): rejected.  The same for V and v < 0.
// - U >= q: u = RN(|up| |inv|) >= RN((1 + 2^-17)(1 - u)^2) > 1 (or u
//   overflows to inf): u > 1, rejected.
// - V >= q and U not NaN: v > 1 as above.  If u < 0 the test rejects;
//   otherwise u is +-0, positive or inf (up is a number), so
//   RN(u + v) >= v > 1 (RN is monotone, v a float) or u > 1: rejected.
// - U >= 0, V >= 0 (so u, v >= 0 or -0) and RN(U + V) >= q: the exact
//   U + V >= a (1 + 2^-17)(1 - u)/(1 + u) >= a (1 + 2^-18), and with the
//   absolute error 2^-150 of a denormal result, u + v >=
//   (U + V)/a (1 - u)^2 - 2^-149 > 1 + 2^-19, so RN(u + v) > 1 (or an
//   inf operand makes u > 1 or v > 1 and the sum inf): rejected.
// NaN dot products fail every comparison, so they never claim a
// rejection; -0 and +0 fall in no clause (|U| < 2^-64 < q).  The margins
// are many times what the roundings need.  So a skipped test could not
// have set a flag, and the flags stay those of every test.
__device__ __forceinline__ bool surely_rejected(const Dots& d, float eps) {
  const float a = fabsf(d.det);
  const float U = d.det < 0.0f ? -d.up : d.up;
  const float V = d.det < 0.0f ? -d.vp : d.vp;
  const float q = a * (1.0f + 0x1p-17f);
  const bool in_range = (a >= 0x1p-64f) & (a <= 0x1p64f);
  return (a < eps) |
         (in_range & ((U <= -0x1p-64f) | (V <= -0x1p-64f) | (U >= q) |
                      ((U == U) & (V >= q)) |
                      ((U >= 0.0f) & (V >= 0.0f) & (U + V >= q))));
}

// The exact test (_shadow_body's operations in its order): whether row
// c (its dots d and its k) occludes the ray (dx, dy, dz) before dist_pt.
__device__ __forceinline__ bool occludes(const Dots& d, float k,
                                         bool admitted, float dx, float dy,
                                         float dz, float dist_pt, float eps,
                                         float shadow_eps,
                                         int accept_negative_t) {
  const float inv_det = 1.0f / d.det;
  const float u = d.up * inv_det;
  const float v = d.vp * inv_det;
  const float t = k * inv_det;
  const bool reject = (fabsf(d.det) < eps) | (u < 0.0f) | (u > 1.0f) |
                      (v < 0.0f) | (u + v > 1.0f) | !admitted;
  bool hit = !reject & (t != 0.0f) & (t < kTMax);
  if (!accept_negative_t) hit &= t > 0.0f;
  const float ox = t * dx;
  const float oy = t * dy;
  const float oz = t * dz;
  const float dist_occ = sqrtf(ox * ox + oy * oy + oz * oz);
  return hit & (dist_occ + shadow_eps < dist_pt);
}

// Whether row c admits the ray: its key equals the ray's cell key, or
// (box) its footprint box holds the ray's light cell (gx, gy).
__device__ __forceinline__ bool admits(const float* c, int box, float cell,
                                       float gx, float gy) {
  return box ? ((gx >= c[11]) & (gx <= c[12]) & (gy >= c[13]) &
                (gy <= c[14]))
             : (c[10] == cell);
}

// A warp step past the admission vote: `live` lanes admit and need the
// row, `div` of them ran the division.
__device__ __forceinline__ void count_step(unsigned long long* st,
                                           unsigned live, unsigned div) {
  ++st[kExecuted];
  st[kLiveTests] += __popc(live);
  if (div)
    ++st[kDividedSteps];
  else
    ++st[kPreSkipped];
  st[kDividedTests] += __popc(div);
}

// The launch's arguments (ugrt_shadow_sweep).
struct Args {
  const float* tri;     // rows [nw, win, 16] (block walk)
  const float* cols;    // serial walk: the rows by groups, [nw * win / 32,
                        // 16, 32], component-major within a group
  int nw, win;
  const float* rays;
  int nb;
  const int* w_lo;
  const int* w_hi;
  const int* item_end;
  int chunk;
  float eps, shadow_eps;
  int accept_negative_t, box;
  int* sh_out;          // flags [nb * 128]
  int* counter;         // item counter of the walk or of pass 1
  int* rest_counter;    // serial walk: pass 2's item counter
  int* n_rest;          // serial walk: entries in `rest`
  int* hints;           // serial walk: kHints slots, group + 1 (0: none)
  int4* rest;           // serial walk: pass 2's rays {ray, r0, r1, hint}
  int rest_cap;
};

// The block walk: a thread block takes an item (a ray block, a run of
// windows), stages each window into shared memory, and each warp runs a
// row against its 32 rays at a time.  Its own kernel, with the
// arguments as scalars and restrict pointers: the vote loop that skips
// rows is a few instructions a row, and this form keeps it at its
// parent's length.
template <bool kStats>
__global__ void __launch_bounds__(kRays)
shadow_sweep_kernel(const float* __restrict__ tri, int nw, int win,
                    const float* __restrict__ rays, int nb,
                    const int* __restrict__ w_lo,
                    const int* __restrict__ w_hi,
                    const int* __restrict__ item_end, int chunk, float eps,
                    float shadow_eps, int accept_negative_t, int box,
                    int* __restrict__ counter, int* sh_out,
                    unsigned long long* __restrict__ stats) {
  extern __shared__ float4 s_win[];
  __shared__ int s_item[3];            // ray block (-1: no work left), w0, w1
  const float* s = reinterpret_cast<const float*>(s_win);
  unsigned long long st[kNumStats] = {};   // kStats only
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
    if (kStats && threadIdx.x == 0) ++st[kItems];

    const size_t ray = static_cast<size_t>(b) * kRays + threadIdx.x;
    const float* r = rays + ray * 8;
    const float dx = r[0], dy = r[1], dz = r[2], dist_pt = r[3];
    const float cell = r[4], gx = r[5], gy = r[6];
    // Set by another item of this block: stays 1 whatever this one finds.
    const int known = __ldcg(sh_out + ray);
    int occluded = known;
    for (int w = w0; w <= w1; ++w) {
      // Doubles as the fence before this window overwrites s_win.
      if (__syncthreads_and(occluded)) {
        if (kStats && threadIdx.x == 0) st[kUnstaged] += w1 - w + 1;
        break;
      }
      stage(s_win,
            reinterpret_cast<const float4*>(tri + static_cast<size_t>(w) *
                                                      win * kComp),
            win * kComp / 4);
      __syncthreads();
      for (int q = 0; q < win; ++q) {
        const float* c = s + q * kComp;
        const bool admitted = admits(c, box, cell, gx, gy);
        // Every lane runs the same rows, so the vote is warp-uniform.
        if constexpr (kStats) {
          const unsigned live = __ballot_sync(kFull, admitted & !occluded);
          if (!live) {
            ++st[kVoteSkipped];
            continue;
          }
          count_step(st, live, live);
        } else if (!__any_sync(kFull, admitted & !occluded)) {
          continue;
        }
        occluded |= occludes(dots(dx, dy, dz, c), c[9], admitted, dx, dy, dz,
                             dist_pt, eps, shadow_eps, accept_negative_t);
      }
    }
    if (occluded && !known) sh_out[ray] = 1;
  }
  if (kStats && (threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kNumStats; ++i)
      if (st[i]) atomicAdd(stats + i, st[i]);
  }
}

// The serial walk's ray, held by every lane of a warp.
struct Ray {
  float dx, dy, dz, dist_pt, cell, gx, gy;
};

// Whether the kGroup rows [g, g + kGroup) occlude the ray that all lanes
// hold: lane l tests row g + l, its components read from `cols`, each a
// coalesced 128 bytes across the warp.  A warp skips the arithmetic
// where no lane admits its row, and the division where the t-free test
// (surely_rejected) clears every lane.
template <bool kStats>
__device__ __forceinline__ bool test_group(const Args& p, int g,
                                           const Ray& y,
                                           unsigned long long* st) {
  const float* col = p.cols + static_cast<size_t>(g) * kComp +
                     (threadIdx.x & 31);
  float c[15];
  c[10] = __ldg(col + 10 * kGroup);
  if (p.box) {
#pragma unroll
    for (int k = 11; k < 15; ++k) c[k] = __ldg(col + k * kGroup);
  }
  const bool admitted = admits(c, p.box, y.cell, y.gx, y.gy);
  const unsigned live = __ballot_sync(kFull, admitted);
  if (!live) {
    if (kStats) ++st[kVoteSkipped];
    return false;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) c[k] = __ldg(col + k * kGroup);
  const Dots d = dots(y.dx, y.dy, y.dz, c);
  const unsigned div =
      __ballot_sync(kFull, admitted & !surely_rejected(d, p.eps));
  if (kStats) count_step(st, live, div);
  if (!div) return false;
  return __any_sync(kFull, occludes(d, c[9], admitted, y.dx, y.dy, y.dz,
                                    y.dist_pt, p.eps, p.shadow_eps,
                                    p.accept_negative_t));
}

// Walks the groups of rows [r0, r1) but `skip` in order; the first that
// occludes the ray, or -1.
template <bool kStats>
__device__ __forceinline__ int walk_groups(const Args& p, int r0, int r1,
                                           int skip, const Ray& y,
                                           unsigned long long* st) {
  for (int g = r0; g < r1; g += kGroup)
    if (g != skip && test_group<kStats>(p, g, y, st)) return g;
  return -1;
}

__device__ __forceinline__ int* hint_slot(const Args& p, float cell) {
  return p.hints + (static_cast<int>(cell) & (kHints - 1));
}

// The hinted group of cell key `cell` if the rows [r0, r1) hold it, or
// -1.  Slots hold group starts, multiples of kGroup as r0 is (the
// wrapper takes windows of a multiple of kGroup rows).
__device__ __forceinline__ int hint_of(const Args& p, float cell, int r0,
                                       int r1) {
  const int h = __ldcg(hint_slot(p, cell)) - 1;
  return (h >= r0) & (h < r1) ? h : -1;
}

// The serial walk, pass 1: each warp takes its own items (a quarter of a
// ray block, a run of windows) and its 32 rays one after another, 32
// rows a step.  A ray first tests one group: the group that occluded the
// ray before it, or, at the start of an item, of a new cell or while
// there is none, the group that hints[] holds for its cell.  On a miss
// the ray walks the item's other groups in order to the first that
// occludes it, which becomes the hint.  A walk that finds none (a lit
// ray) stops the walks of this item until a hint occludes a ray again:
// meanwhile the rays the hint misses go to `rest`, with the group they
// tested, for pass 2, so that a run of lit rays does not keep one warp
// walking alone.  If `rest` is full the warp walks the ray here.
template <bool kStats>
__device__ __forceinline__ void hinted_walk(const Args& p,
                                            unsigned long long* st) {
  __shared__ int s_items[kWarps][3];   // per warp: ray block, w0, w1
  int* s_item = s_items[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(p.counter, 1);
    item = __shfl_sync(kFull, item, 0);
    decode_item(item >> 2, p.item_end, p.nb, p.w_lo, p.w_hi, p.nw, p.chunk,
                s_item);
    __syncwarp();
    const int b = s_item[0];
    const int r0 = s_item[1] * p.win, r1 = (s_item[2] + 1) * p.win;
    __syncwarp();                      // read before the next decode
    if (b < 0) break;
    if (kStats && lane == 0) ++st[kItems];

    const int ray = b * kRays + (item & 3) * 32 + lane;
    const float* r = p.rays + static_cast<size_t>(ray) * 8;
    const Ray mine{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    unsigned todo = __ballot_sync(kFull, !__ldcg(p.sh_out + ray));
    if (kStats) st[kKnownRays] += 32 - __popc(todo);
    unsigned occluded = 0, rest = 0;
    int hint = -1, tested = -1;        // tested: the group this lane's ray
    float hint_cell = 0.0f;            // tested in a missed hint
    bool walks = true;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const Ray y{__shfl_sync(kFull, mine.dx, j),
                  __shfl_sync(kFull, mine.dy, j),
                  __shfl_sync(kFull, mine.dz, j),
                  __shfl_sync(kFull, mine.dist_pt, j),
                  __shfl_sync(kFull, mine.cell, j),
                  __shfl_sync(kFull, mine.gx, j),
                  __shfl_sync(kFull, mine.gy, j)};
      if (hint < 0 || y.cell != hint_cell) {
        hint = hint_of(p, y.cell, r0, r1);
        hint_cell = y.cell;
      }
      if (hint >= 0) {
        const bool occ = test_group<kStats>(p, hint, y, st);
        if (kStats) {
          ++st[kHintSteps];
          st[kHintHits] += occ;
        }
        if (occ) {
          occluded |= 1u << j;
          walks = true;
          continue;
        }
        if (lane == j) tested = hint;
      }
      if (!walks) {
        rest |= 1u << j;
        continue;
      }
      const int g = walk_groups<kStats>(p, r0, r1, hint, y, st);
      if (g < 0) {
        walks = false;
        continue;
      }
      hint = g;
      occluded |= 1u << j;
      if (lane == 0) *hint_slot(p, y.cell) = g + 1;
    }
    // The rays to walk on: one slot each in `rest`, or walked here.
    if (rest) {
      int base = 0;
      if (lane == 0) base = atomicAdd(p.n_rest, __popc(rest));
      base = __shfl_sync(kFull, base, 0);
      if (kStats) st[kDeferred] += __popc(rest);
      const bool in_rest = (rest >> lane) & 1;
      const int k = base + __popc(rest & ((1u << lane) - 1));
      if (in_rest & (k < p.rest_cap))
        p.rest[k] = make_int4(ray, r0, r1, tested);
      unsigned left = __ballot_sync(kFull, in_rest & (k >= p.rest_cap));
      while (left) {
        const int j = __ffs(left) - 1;
        left &= left - 1;
        const Ray y{__shfl_sync(kFull, mine.dx, j),
                    __shfl_sync(kFull, mine.dy, j),
                    __shfl_sync(kFull, mine.dz, j),
                    __shfl_sync(kFull, mine.dist_pt, j),
                    __shfl_sync(kFull, mine.cell, j),
                    __shfl_sync(kFull, mine.gx, j),
                    __shfl_sync(kFull, mine.gy, j)};
        const int skip = __shfl_sync(kFull, tested, j);
        if (walk_groups<kStats>(p, r0, r1, skip, y, st) >= 0)
          occluded |= 1u << j;
      }
    }
    if ((occluded >> lane) & 1) p.sh_out[ray] = 1;
  }
}

// The serial walk, pass 2: each warp takes a ray of `rest` at a time and
// walks its item's groups but the hinted one, to the first that occludes
// it.  The rays of `rest` are spread over every warp, so no warp walks a
// block's worth of unshadowed rays alone.
template <bool kStats>
__device__ __forceinline__ void rest_walk(const Args& p,
                                          unsigned long long* st) {
  const int lane = threadIdx.x & 31;
  const int n = min(*p.n_rest, p.rest_cap);
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(p.rest_counter, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n) break;
    const int4 e = p.rest[k];
    const float* r = p.rays + static_cast<size_t>(e.x) * 8;
    const Ray y{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    if (walk_groups<kStats>(p, e.y, e.z, e.w, y, st) >= 0 && lane == 0)
      p.sh_out[e.x] = 1;
  }
}

template <int kWalk, bool kStats>
__global__ void __launch_bounds__(kRays)
shadow_sweep_serial_kernel(Args p, unsigned long long* __restrict__ stats) {
  unsigned long long st[kNumStats] = {};   // kStats only
  if constexpr (kWalk == kHinted)
    hinted_walk<kStats>(p, st);
  else
    rest_walk<kStats>(p, st);
  if (kStats && (threadIdx.x & 31) == 0) {
    // Every count is warp-uniform: lane 0 adds its warp's.
#pragma unroll
    for (int i = 0; i < kNumStats; ++i)
      if (st[i]) atomicAdd(stats + i, st[i]);
  }
}

template <bool kStats>
int launch_block(const Args& p, void* stats, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.win) * kComp * sizeof(float);
  int grid = 0;
  const cudaError_t err =
      persistent_grid(shadow_sweep_kernel<kStats>, kRays, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  shadow_sweep_kernel<kStats><<<grid, kRays, smem, stream>>>(
      p.tri, p.nw, p.win, p.rays, p.nb, p.w_lo, p.w_hi, p.item_end, p.chunk,
      p.eps, p.shadow_eps, p.accept_negative_t, p.box, p.counter, p.sh_out,
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <int kWalk, bool kStats>
int launch_serial(const Args& p, void* stats, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = persistent_grid(
      shadow_sweep_serial_kernel<kWalk, kStats>, kRays, 0, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  shadow_sweep_serial_kernel<kWalk, kStats><<<grid, kRays, 0, stream>>>(
      p, static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int launch_walk(const Args& p, int serial, void* stats, cudaStream_t s) {
  if (!serial) return launch_block<kStats>(p, stats, s);
  const int err = launch_serial<kHinted, kStats>(p, stats, s);
  return err ? err : launch_serial<kRest, kStats>(p, stats, s);
}

}  // namespace

// Launches K3 on `stream`: persistent grids over the items of `item_end`
// (int32 [nb], inclusive prefix sum of each ray block's chunk count).
// `buf` (int32) must be zero on `stream` before the launch: the flags
// [nb, 128], then the item counter, then, with `serial`, pass 2's item
// counter, its ray count and the kHints hint slots.  Block walk: windows
// are `win` rows (a multiple of 4; 16 * win f32 of dynamic shared memory,
// at most 48 KB).  Serial walk (`serial` != 0; `win` a multiple of 32):
// it reads the rows from `cols` (f32 [nw * win / 32, 16, 32]: group i's
// component k of row 32 i + l at [i, k, l]), in two launches, pass 1
// and pass 2, which reads `rest` (int32 [rest_cap, 4], 16-byte aligned;
// no fill needed).  With `stats` (int64 [kNumStats], zeroed) non-null it
// launches the counting build, which also counts the work it ran (enum
// Stat).
extern "C" int ugrt_shadow_sweep(const void* tri, const void* cols, int nw,
                                 int win, const void* rays, int nb,
                                 const void* w_lo, const void* w_hi,
                                 const void* item_end, int chunk, float eps,
                                 float shadow_eps, int accept_negative_t,
                                 int box, int serial, void* buf, void* rest,
                                 int rest_cap, void* stats, void* stream) {
  if (nb == 0) return 0;
  int* flags = static_cast<int*>(buf);
  int* counter = flags + static_cast<size_t>(nb) * kRays;
  const Args p{static_cast<const float*>(tri),
               static_cast<const float*>(cols), nw, win,
               static_cast<const float*>(rays), nb,
               static_cast<const int*>(w_lo), static_cast<const int*>(w_hi),
               static_cast<const int*>(item_end), chunk, eps, shadow_eps,
               accept_negative_t, box, flags, counter, counter + 1,
               counter + 2, counter + 3, static_cast<int4*>(rest), rest_cap};
  const auto s = static_cast<cudaStream_t>(stream);
  return stats ? launch_walk<true>(p, serial, stats, s)
               : launch_walk<false>(p, serial, stats, s);
}
