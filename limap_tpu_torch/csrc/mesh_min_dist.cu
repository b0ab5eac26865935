// Kernel N: the distance of each query point to the nearest triangle of a
// mesh.
//
// Replaces the jitted program _min_dist_to_mesh
// (limap_tpu/evaluation/mesh_evaluator.py:79), a scan over chunks of 2048
// triangles of point_triangle_distance (:21-76, a branch-free barycentric
// clamp after Ericson, Real-Time Collision Detection 5.1.5) with a
// running min.  In: points [P, 3] f32, triangles [M, 3, 3] f32 (a, b, c);
// out: [P] f32, +inf where M = 0.
//
// Bound: operations.  Per (point, triangle) pair some 120 fp32 operations
// (ops/mesh_distance.py::OPS_PAIR counts them from this file) against 12
// bytes a point and 36 a triangle.  Design: one thread a point, 256
// points a block; the block stages a tile of triangles in shared memory
// (a, b, c, ab = b - a, ac = c - a and bc = c - b, computed once a
// triangle), every thread reads the same triangle at once (a broadcast),
// and keeps the running minimum of the SQUARED distance in a register;
// one root at the end (the root is monotone and correctly rounded, so
// the minimum equals the minimum of the norms).  The tail of M is a
// bound on the tile's loop, not padding.
//
// Numerics.  The region is decided first and only its projection is
// computed, each by the reference's formula: vertex a overrides vertex
// b, then c, then edge ab, then ac, then bc, then the face (the
// reference's where chain, :61-75).  Every projection is written as
// (o + s u) + q ac: the vertices with s = q = 0, edge ab (a, ab, t, 0),
// edge ac (a, ab, 0, t), edge bc (b, bc, t, 0), the face (a, ab, v, w);
// an added zero product leaves the value as the reference's.  The guards
// put +1e-12 where |x| < 1e-12, also for a negative x (:46-58).  All
// arithmetic is the _rn intrinsics in the plain version's order (no
// multiply-add contraction), so the kernel agrees with
// mesh_min_dist_plain bit for bit on finite inputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr float kGuard = 1e-12f;

struct __align__(16) Tri {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, abz, acx, acy, acz, bcx, bcy, bcz, pad0, pad1;
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

__global__ void __launch_bounds__(kThreads) mesh_min_dist_kernel(
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
        // torch.minimum's choice on finite values
        best = sq < best ? sq : best;
      }
    }
    __syncthreads();
  }
  if (live) out[i] = __fsqrt_rn(best);
}

}  // namespace

extern "C" int mesh_min_dist_launch(const void* points, long long P,
                                    const void* tris, long long M, void* out,
                                    void* stream) {
  const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
  mesh_min_dist_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)points, P, (const float*)tris, M, (float*)out);
  return (int)cudaGetLastError();
}
