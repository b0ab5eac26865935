// Kernel N: the distance of each query point to the nearest triangle of a
// mesh.
//
// Replaces the jitted program _min_dist_to_mesh
// (limap_tpu/evaluation/mesh_evaluator.py:79), a scan over chunks of 2048
// triangles of point_triangle_distance (:21-76, a branch-free barycentric
// clamp after Ericson, Real-Time Collision Detection 5.1.5) with a
// running min.  In: points [P, 3] f32 and the mesh as
// ops/mesh_distance.py::prepare_mesh lays it out; out: [P] f32.
//
// Bound: operations, of the pairs the design evaluates (some 120 fp32
// operations a (point, triangle) pair, ops/mesh_distance.py::OPS_PAIR)
// and of its box tests; every pair would be 4.8e10 pairs on the
// evaluation's 353,000 x 135,000.
//
// Numerics of a pair (pair_sq).  The region is decided first and only its
// projection is computed, each by the reference's formula: vertex a
// overrides vertex b, then c, then edge ab, then ac, then bc, then the
// face (the reference's where chain, :61-75).  Every projection is
// written as (o + s u) + q ac: the vertices with s = q = 0, edge ab (a,
// ab, t, 0), edge ac (a, ab, 0, t), edge bc (b, bc, t, 0), the face (a,
// ab, v, w); an added zero product leaves the value as the reference's.
// The guards put +1e-12 where |x| < 1e-12, also for a negative x
// (:46-58).  All arithmetic is the _rn intrinsics in the plain version's
// order (no multiply-add contraction), so a pair's squared distance is
// mesh_min_dist_plain's bit for bit on finite inputs; the minimum of a
// set does not depend on the order of its terms, and one root at the end
// (monotone, correctly rounded) gives the plain version's value.
//
// Design (mesh_cull_kernel): skip the pairs that cannot hold a point's
// minimum.  prepare_mesh sorts the well-conditioned triangles by the
// Morton code of their centroids and cuts them into clusters of at most
// 32 within the cells of an octree level (a cluster never spans a jump of
// the curve), each with its axis-aligned box, and the clusters into
// groups of at most 32 two levels up, with theirs (a group's kappa,
// lambda and m the largest of its clusters'); the other triangles form
// the "always" list.  A warp takes 32 consecutive query points (a
// segment's samples are consecutive, so they lie close together, but a
// warp may hold the ends of two segments: its points are held in two
// boxes, split after the largest step between consecutive lanes, each
// with the largest best of its lanes):
//   1. seed: every lane's best over the always list; each lane's seed,
//      the cluster nearest its point within the group nearest its point
//      (ties to the lower index); the warp scans each distinct seed once
//      for all 32 lanes, so every lane starts from a triangle near it;
//   2. sweep: the groups 32 at a time, one box test a lane against both
//      point boxes; for each surviving group (__ballot_sync) its
//      clusters, one a lane, tested the same way, the seeds left out;
//   3. each surviving cluster is tested again lane by lane (the lane's
//      point and best) and scanned for all 32 lanes if a lane needs it;
//   4. one __fsqrt_rn of each lane's best.
// The kernel counts the pairs it evaluates (live lanes x triangles), the
// clusters it scans, the lane tests of step 3 (live lanes x clusters),
// the groups and clusters step 2 tests and the seed's box distances.
//
// Well-conditioned (prepare_mesh, in float64; L the longest edge, l the
// shortest, N = ab x ac): finite, l >= 1e-2 L and |N| >= 1e-2 L^2 (no
// angle much below half a degree).  A degenerate, repeated-vertex,
// collinear or sliver triangle has no useful bound below (JAX's formula
// errs by up to 0.48 m there): it is in the always list, scanned for
// every point.
//
// The margin.  u = 2^-24.  For p and a well-conditioned triangle T in a
// cluster box B, with R = |p - farthest corner of B| + lambda (lambda the
// cluster's longest edge, so R is at least the distance to any vertex and
// at least L), the computed distance is at least dist(p, B) - delta, with
//   delta = C_FACE u R^2 kappa + 8 u m,
// kappa = max over the cluster of L^2 / (|N| l) and m the largest
// coordinate magnitude of the cluster:
//   - a vertex is exact; an edge point o + t u with t clamped to [0, 1]
//     lies within 3 u m of the edge's box (u = fl(b - a) is b - a to a
//     relative u; two roundings);
//   - the face: |d_k - D_k| <= 5 u L R and each of va, vb, vc is off by
//     at most 24 u L^2 R^2, so where the tests take the face the exact
//     projection of p lies within 24 u R^2 L^2 / (|N| l) of T beyond an
//     edge, or within 5 u R L^2 / |N| beside a vertex (a decision value
//     within its error of 0; a point between two other regions is held
//     out of the face by the same computed d in both tests).  The face
//     point v ab + w ac lies on T's plane whatever v and w are (a guard
//     too), up to 8 u R L^2 / |N| of rounding where it is within dist(p,
//     B) of p, and its distance from p is at least p's distance h from
//     the plane, h >= dist(p, B) - (the projection's distance from T).
//     In all some 40 u R^2 kappa; C_FACE = 256 leaves a factor of six.
// The computed squared distance is within 6 u of |p - q|^2 and the test's
// own float32 arithmetic (the box distance lb2, the threshold) within
// 14 u, so a cluster is skipped when
//   lb2 > (sqrt(best) (1 + 2^-18) + delta)^2 (1 + 2^-18)
// and then every pair of it computes a squared distance above best: the
// minimum, and so the result, is the plain scan's bit for bit.  lb2 and
// the far corner come from the warp's point box in step 2 and from the
// lane's point in step 3.  NaN or inf in a test keeps the cluster.
//
// mesh_min_dist_scan is the first design, kept as the yardstick of the
// time (no path launches it): one thread a point over every triangle,
// staged through shared memory in tiles of 256.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kCullThreads = 128;     // 4 warps, a warp 32 points
constexpr float kGuard = 1e-12f;

struct __align__(16) Tri {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, abz, acx, acy, acz, bcx, bcy, bcz, pad0, pad1;
};

// a cluster: its box, kappa, lambda and m (prepare_mesh's layout)
struct __align__(16) Cluster {
  float lox, loy, loz, kappa, hix, hiy, hiz, lam, mabs, pad0, pad1, pad2;
};

struct Margin {
  float face_k;   // C_FACE u
  float abs_k;    // 8 u
  float rel;      // 1 + 2^-18
};

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// (a0 b0 + a1 b1) + a2 b2, the order of the plain version's dot3
// (ops/line_ransac.py)
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < kGuard ? kGuard : x;
}

// clip to [0, 1] as jnp.clip and torch.clamp do it (a NaN stays NaN)
__device__ __forceinline__ float clip01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

__device__ __forceinline__ float pair_sq(float px, float py, float pz,
                                         const Tri& t) {
  const float apx = sub(px, t.ax), apy = sub(py, t.ay), apz = sub(pz, t.az);
  const float d1 = dot3(t.abx, t.aby, t.abz, apx, apy, apz);
  const float d2 = dot3(t.acx, t.acy, t.acz, apx, apy, apz);
  const float bpx = sub(px, t.bx), bpy = sub(py, t.by), bpz = sub(pz, t.bz);
  const float d3 = dot3(t.abx, t.aby, t.abz, bpx, bpy, bpz);
  const float d4 = dot3(t.acx, t.acy, t.acz, bpx, bpy, bpz);
  const float cpx = sub(px, t.cx), cpy = sub(py, t.cy), cpz = sub(pz, t.cz);
  const float d5 = dot3(t.abx, t.aby, t.abz, cpx, cpy, cpz);
  const float d6 = dot3(t.acx, t.acy, t.acz, cpx, cpy, cpz);
  const float va = sub(mul(d3, d6), mul(d5, d4));
  const float vb = sub(mul(d5, d2), mul(d1, d6));
  const float vc = sub(mul(d1, d4), mul(d3, d2));
  const float e43 = sub(d4, d3), e56 = sub(d5, d6);

  const bool vert_a = d1 <= 0.f && d2 <= 0.f;
  const bool vert_b = d3 >= 0.f && d4 <= d3;
  const bool vert_c = d6 >= 0.f && d5 <= d6;
  const bool on_ab = vc <= 0.f && d1 >= 0.f && d3 <= 0.f;
  const bool on_ac = vb <= 0.f && d2 >= 0.f && d6 <= 0.f;
  const bool on_bc = va <= 0.f && e43 >= 0.f && e56 >= 0.f;

  // the region, in the reference's order of precedence
  const bool vertex = vert_a || vert_b || vert_c;
  const bool ab = !vertex && on_ab;
  const bool ac = !vertex && !on_ab && on_ac;
  const bool bc = !vertex && !on_ab && !on_ac && on_bc;
  const bool face = !vertex && !on_ab && !on_ac && !on_bc;

  // s = n1 / g(m1) along u, q = n2 / g(m2) along ac; 0 / g(1) = 0
  float n1 = 0.f, m1 = 1.f, n2 = 0.f, m2 = 1.f;
  if (face) {
    const float denom = add(add(va, vb), vc);
    n1 = vb;
    m1 = denom;
    n2 = vc;
    m2 = denom;
  } else if (ab) {
    n1 = d1;
    m1 = sub(d1, d3);
  } else if (bc) {
    n1 = e43;
    m1 = add(e43, e56);
  } else if (ac) {
    n2 = d2;
    m2 = sub(d2, d6);
  }
  float s = __fdiv_rn(n1, guard(m1));
  float q = __fdiv_rn(n2, guard(m2));
  if (ab || bc) s = clip01(s);
  if (ac) q = clip01(q);

  // origin and first direction
  const bool from_b = (!vert_a && vert_b) || bc;
  const bool from_c = !vert_a && !vert_b && vert_c;
  const float ox = from_b ? t.bx : (from_c ? t.cx : t.ax);
  const float oy = from_b ? t.by : (from_c ? t.cy : t.ay);
  const float oz = from_b ? t.bz : (from_c ? t.cz : t.az);
  const float ux = bc ? t.bcx : t.abx;
  const float uy = bc ? t.bcy : t.aby;
  const float uz = bc ? t.bcz : t.abz;

  const float dx = sub(px, add(add(ox, mul(s, ux)), mul(q, t.acx)));
  const float dy = sub(py, add(add(oy, mul(s, uy)), mul(q, t.acy)));
  const float dz = sub(pz, add(add(oz, mul(s, uz)), mul(q, t.acz)));
  return add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
}

// ------------------------------------------------------------ the cull
// max(0, lo - bhi, blo - hi) on one axis
__device__ __forceinline__ float gap(float lo, float hi, float blo,
                                     float bhi) {
  return fmaxf(0.f, fmaxf(sub(lo, bhi), sub(blo, hi)));
}

__device__ __forceinline__ float far1(float lo, float hi, float blo,
                                      float bhi) {
  return fmaxf(fabsf(sub(hi, blo)), fabsf(sub(bhi, lo)));
}

// the squared distance of the box [blo, bhi] to the cluster's (or the
// group's) box
__device__ __forceinline__ float box_lb2(const Cluster& c, float bx0,
                                         float by0, float bz0, float bx1,
                                         float by1, float bz1) {
  const float gx = gap(c.lox, c.hix, bx0, bx1);
  const float gy = gap(c.loy, c.hiy, by0, by1);
  const float gz = gap(c.loz, c.hiz, bz0, bz1);
  return add(add(mul(gx, gx), mul(gy, gy)), mul(gz, gz));
}

// true where no pair of the cluster can compute a squared distance at or
// below `best` for any point of the box [b0, b1] (the header's margin)
__device__ __forceinline__ bool skip(const Cluster& c, float bx0, float by0,
                                     float bz0, float bx1, float by1,
                                     float bz1, float best, const Margin& m) {
  const float lb2 = box_lb2(c, bx0, by0, bz0, bx1, by1, bz1);
  const float fx = far1(c.lox, c.hix, bx0, bx1);
  const float fy = far1(c.loy, c.hiy, by0, by1);
  const float fz = far1(c.loz, c.hiz, bz0, bz1);
  const float r = add(__fsqrt_rn(add(add(mul(fx, fx), mul(fy, fy)),
                                     mul(fz, fz))),
                      c.lam);
  const float r2 = mul(r, r);
  const float delta = add(mul(mul(m.face_k, r2), c.kappa),
                          mul(m.abs_k, c.mabs));
  const float t = add(mul(__fsqrt_rn(best), m.rel), delta);
  return lb2 > mul(mul(t, t), m.rel);
}

// the warp's points in two boxes, a and b (see the header)
struct Boxes {
  float a0[3], a1[3], b0[3], b1[3];
};

// step 2: a group or cluster some point of either box may need
__device__ __forceinline__ bool keep2(const Cluster& c, const Boxes& w,
                                      float best_a, float best_b,
                                      const Margin& m) {
  return !skip(c, w.a0[0], w.a0[1], w.a0[2], w.a1[0], w.a1[1], w.a1[2],
               best_a, m) ||
         !skip(c, w.b0[0], w.b0[1], w.b0[2], w.b1[0], w.b1[1], w.b1[2],
               best_b, m);
}

__device__ __forceinline__ float scan_tris(const Tri* __restrict__ tris,
                                           int begin, int end, float px,
                                           float py, float pz, float best) {
  for (int k = begin; k < end; ++k) {
    const Tri t = tris[k];
    const float sq = pair_sq(px, py, pz, t);
    // torch.minimum's choice on finite values
    best = sq < best ? sq : best;
  }
  return best;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kCullThreads) mesh_cull_kernel(
    const float* __restrict__ points, long long P,
    const Tri* __restrict__ tris, const Cluster* __restrict__ clusters,
    const int* __restrict__ starts, int C,
    const Cluster* __restrict__ groups,
    const int* __restrict__ gstarts, int G, const Tri* __restrict__ always,
    int A, Margin m,
    float* __restrict__ out,
    unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long i0 =
      ((long long)blockIdx.x * kCullThreads + (threadIdx.x & ~31));
  if (i0 >= P) return;                         // the whole warp
  const long long i = i0 + lane;
  const bool live = i < P;
  const long long src = live ? i : i0;         // the warp's first point
  const float px = points[3 * src], py = points[3 * src + 1],
              pz = points[3 * src + 2];
  const int n_live = (int)min(32LL, P - i0);
  unsigned long long pairs = 0, scanned = 0, tests = 0, wtests = 0,
                     stests = 0;

  // the two boxes: lanes 0..split and split+1..31, split after the
  // largest squared step to the next lane (ties to the lower lane)
  const float qx = __shfl_down_sync(0xffffffffu, px, 1);
  const float qy = __shfl_down_sync(0xffffffffu, py, 1);
  const float qz = __shfl_down_sync(0xffffffffu, pz, 1);
  const float sx = sub(qx, px), sy = sub(qy, py), sz = sub(qz, pz);
  float jump = lane < 31 ? dot3(sx, sy, sz, sx, sy, sz) : -1.f;
  int split = lane;
  for (int o = 16; o > 0; o >>= 1) {
    const float oj = __shfl_xor_sync(0xffffffffu, jump, o);
    const int os = __shfl_xor_sync(0xffffffffu, split, o);
    if (oj > jump || (oj == jump && os < split)) {
      jump = oj;
      split = os;
    }
  }
  const bool in_a = lane <= split;
  Boxes w;
  {
    const float p[3] = {px, py, pz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w.a0[k] = warp_min(in_a ? p[k] : INFINITY);
      w.a1[k] = warp_max(in_a ? p[k] : -INFINITY);
      w.b0[k] = warp_min(in_a ? INFINITY : p[k]);
      w.b1[k] = warp_max(in_a ? -INFINITY : p[k]);
    }
  }

  // 1. seed: the always list, then each lane's nearest cluster within its
  // nearest group, each distinct one scanned once
  float best = scan_tris(always, 0, A, px, py, pz, INFINITY);
  pairs += (unsigned long long)A * n_live;
  float gd = INFINITY;
  int gs = G;
  stests += (unsigned long long)G;
  for (int g = 0; g < G; ++g) {
    const float d = box_lb2(groups[g], px, py, pz, px, py, pz);
    if (d < gd) {
      gd = d;
      gs = g;
    }
  }
  float sd = INFINITY;
  int seed = C;
  const int c_begin = gs < G ? gstarts[gs] : 0;
  const int c_end = gs < G ? gstarts[gs + 1] : 0;
  stests += (unsigned long long)(c_end - c_begin);
  for (int c = c_begin; c < c_end; ++c) {
    const float d = box_lb2(clusters[c], px, py, pz, px, py, pz);
    if (d < sd) {
      sd = d;
      seed = c;
    }
  }
  bool seeded = seed >= C;
  for (;;) {
    const unsigned pending = __ballot_sync(0xffffffffu, !seeded);
    if (!pending) break;
    const int sc = __shfl_sync(0xffffffffu, seed, __ffs(pending) - 1);
    const int b = starts[sc], e = starts[sc + 1];
    best = scan_tris(tris, b, e, px, py, pz, best);
    pairs += (unsigned long long)(e - b) * n_live;
    ++scanned;
    seeded = seeded || seed == sc;
  }

  // 2.-3. the sweep over the groups, then their clusters, then each
  // surviving cluster lane by lane
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const float ga = warp_max(in_a ? best : -INFINITY);
    const float gb = warp_max(in_a ? -INFINITY : best);
    const bool keep_g = g < G && keep2(groups[g], w, ga, gb, m);
    wtests += (unsigned long long)min(32, G - g0);
    unsigned gmask = __ballot_sync(0xffffffffu, keep_g);
    while (gmask) {
      const int gg = g0 + __ffs(gmask) - 1;
      gmask &= gmask - 1;
      const int cb = gstarts[gg], ce = gstarts[gg + 1];
      const int c = cb + lane;
      const unsigned seeds = __reduce_or_sync(
          0xffffffffu, seed >= cb && seed < cb + 32 ? 1u << (seed - cb) : 0u);
      const float ba = warp_max(in_a ? best : -INFINITY);
      const float bb = warp_max(in_a ? -INFINITY : best);
      const bool keep = c < ce && !((seeds >> lane) & 1u) &&
                        keep2(clusters[c], w, ba, bb, m);
      wtests += (unsigned long long)(ce - cb);
      unsigned mask = __ballot_sync(0xffffffffu, keep);
      while (mask) {
        const int cc = cb + __ffs(mask) - 1;
        mask &= mask - 1;
        const Cluster cl = clusters[cc];
        const bool need = !skip(cl, px, py, pz, px, py, pz, best, m);
        tests += n_live;
        if (__any_sync(0xffffffffu, need)) {
          const int b = starts[cc], e = starts[cc + 1];
          best = scan_tris(tris, b, e, px, py, pz, best);
          pairs += (unsigned long long)(e - b) * n_live;
          ++scanned;
        }
      }
    }
  }

  // 4. one root
  if (live) out[i] = __fsqrt_rn(best);
  // the seed's tests are each lane's own: summed over the live lanes
  stests = live ? stests : 0ull;
  for (int o = 16; o > 0; o >>= 1)
    stests += __shfl_xor_sync(0xffffffffu, stests, o);
  if (lane == 0) {
    atomicAdd(&counts[0], pairs);
    atomicAdd(&counts[1], scanned);
    atomicAdd(&counts[2], tests);
    atomicAdd(&counts[3], wtests);
    atomicAdd(&counts[4], stests);
  }
}

// ------------------------------------------------------------ the scan
__global__ void __launch_bounds__(kThreads) mesh_scan_kernel(
    const float* __restrict__ points, long long P,
    const float* __restrict__ tris, long long M, float* __restrict__ out) {
  __shared__ Tri tile[kTile];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < P;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = points[3 * i];
    py = points[3 * i + 1];
    pz = points[3 * i + 2];
  }
  float best = INFINITY;
  for (long long base = 0; base < M; base += kTile) {
    const int n = (int)min((long long)kTile, M - base);
    if (threadIdx.x < n) {
      const float* v = tris + 9 * (base + threadIdx.x);
      Tri t;
      t.ax = v[0]; t.ay = v[1]; t.az = v[2];
      t.bx = v[3]; t.by = v[4]; t.bz = v[5];
      t.cx = v[6]; t.cy = v[7]; t.cz = v[8];
      t.abx = sub(t.bx, t.ax); t.aby = sub(t.by, t.ay);
      t.abz = sub(t.bz, t.az);
      t.acx = sub(t.cx, t.ax); t.acy = sub(t.cy, t.ay);
      t.acz = sub(t.cz, t.az);
      t.bcx = sub(t.cx, t.bx); t.bcy = sub(t.cy, t.by);
      t.bcz = sub(t.cz, t.bz);
      t.pad0 = t.pad1 = 0.f;
      tile[threadIdx.x] = t;
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float sq = pair_sq(px, py, pz, tile[j]);
        best = sq < best ? sq : best;
      }
    }
    __syncthreads();
  }
  if (live) out[i] = __fsqrt_rn(best);
}

}  // namespace

// tris [n, 20] and always [A, 20]: prepare_mesh's triangle records;
// clusters [C, 12]; starts [C + 1]; groups [G, 12]; gstarts [G + 1];
// margin: face_k, abs_k, rel; counts [5] u64, added to: pairs evaluated,
// clusters scanned, lane tests, the sweep's tests, the seed's tests
extern "C" int mesh_min_dist_launch(const void* points, long long P,
                                    const void* tris, const void* clusters,
                                    const void* starts, int C,
                                    const void* groups,
                                    const void* gstarts, int G,
                                    const void* always, int A,
                                    const float* margin, void* out,
                                    void* counts, void* stream) {
  if (P <= 0) return 0;
  const Margin m{margin[0], margin[1], margin[2]};
  const unsigned blocks = (unsigned)((P + kCullThreads - 1) / kCullThreads);
  mesh_cull_kernel<<<blocks, kCullThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, P, (const Tri*)tris, (const Cluster*)clusters,
      (const int*)starts, C, (const Cluster*)groups, (const int*)gstarts, G,
      (const Tri*)always, A, m, (float*)out,
      (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int mesh_min_dist_scan_launch(const void* points, long long P,
                                         const void* tris, long long M,
                                         void* out, void* stream) {
  if (P <= 0) return 0;
  const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
  mesh_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, P, (const float*)tris, M, (float*)out);
  return (int)cudaGetLastError();
}
