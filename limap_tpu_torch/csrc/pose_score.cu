// MSAC scoring of candidate poses against point and line matches.
//
// Replaces the jitted XLA programs _score_poses and _pose_sq_errors
// (limap_tpu/estimators/absolute_pose.py:70 and :194): per pose h and
// correspondence j the squared error (points: squared reprojection
// distance; lines: the squared norm of the two endpoint-perpendicular
// residuals of the 2d_perpendicular_dist2 cost, each sqrt(|r|^2 + 1e-8));
// a point or endpoint at depth <= 1e-6 has an infinite error.  Scores
// mode writes the MSAC score wp sum min(e, th_p^2) + wl sum min(e, th_l^2)
// and the inlier masks e <= th^2; errors mode the errors.
//
// Bound: bytes of the masks (or errors) written, H x (Np + Nl) bytes (or
// words); the correspondences, 20 bytes a point and 40 a line, are read
// by every block but stay in L2.  A point costs some 40 fp32 operations,
// a line some 110.  One block a pose and threads over the
// correspondences, so the writes of a warp are contiguous; the score is
// a block reduction (warp shuffles, then one warp over the warps' sums),
// so its order of addition is not the plain version's.
//
// Numerics kept from the JAX program: the pose rotates by its quaternion
// as CameraViewsBatch.project does (v + 2 (w u x v + u x (u x v)), and
// the divide by depth + 1e-12); min() keeps a NaN error NaN, as
// jnp.minimum does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;

struct Pose {
  float qw, qx, qy, qz, tx, ty, tz, fx, fy, cx, cy;
};

// camera-frame point of world point (x, y, z)
__device__ __forceinline__ void to_camera(const Pose& P, float x, float y,
                                          float z, float* c) {
  // uv = u x v, with u the quaternion's vector part
  float uvx = P.qy * z - P.qz * y;
  float uvy = P.qz * x - P.qx * z;
  float uvz = P.qx * y - P.qy * x;
  float uuvx = P.qy * uvz - P.qz * uvy;
  float uuvy = P.qz * uvx - P.qx * uvz;
  float uuvz = P.qx * uvy - P.qy * uvx;
  c[0] = x + 2.f * (P.qw * uvx + uuvx) + P.tx;
  c[1] = y + 2.f * (P.qw * uvy + uuvy) + P.ty;
  c[2] = z + 2.f * (P.qw * uvz + uuvz) + P.tz;
}

__device__ __forceinline__ void to_pixel(const Pose& P, const float* c,
                                         float* px) {
  float u = c[0] / (c[2] + kEps);
  float v = c[1] / (c[2] + kEps);
  px[0] = P.fx * u + P.cx;
  px[1] = P.fy * v + P.cy;
}

__device__ __forceinline__ float point_error(const Pose& P, const float* p3,
                                             const float* p2) {
  float c[3], px[2];
  to_camera(P, p3[0], p3[1], p3[2], c);
  if (!(c[2] > 1e-6f)) return INFINITY;
  to_pixel(P, c, px);
  float dx = px[0] - p2[0], dy = px[1] - p2[1];
  return dx * dx + dy * dy;
}

// sqrt(|disp * sine|^2 + 1e-8) of one observed endpoint q against the
// projected line through mid with unit direction (dx, dy)
__device__ __forceinline__ float perp_residual(float qx, float qy,
                                               float mx, float my, float dx,
                                               float dy) {
  float ex = qx - mx, ey = qy - my;
  float dn = sqrtf(ex * ex + ey * ey + 1e-8f);
  float sine = fabsf(dx * ey - dy * ex) / dn;
  float rx = ex * sine, ry = ey * sine;
  return sqrtf(rx * rx + ry * ry + 1e-8f);
}

__device__ __forceinline__ float line_error(const Pose& P, const float* l3s,
                                            const float* l3e,
                                            const float* l2s,
                                            const float* l2e) {
  float cs[3], ce[3], ps[2], pe[2];
  to_camera(P, l3s[0], l3s[1], l3s[2], cs);
  to_camera(P, l3e[0], l3e[1], l3e[2], ce);
  if (!(cs[2] > 1e-6f && ce[2] > 1e-6f)) return INFINITY;
  to_pixel(P, cs, ps);
  to_pixel(P, ce, pe);
  float mx = 0.5f * (ps[0] + pe[0]), my = 0.5f * (ps[1] + pe[1]);
  float dx = pe[0] - ps[0], dy = pe[1] - ps[1];
  float len = sqrtf(dx * dx + dy * dy) + kEps;
  dx /= len;
  dy /= len;
  float rs = perp_residual(l2s[0], l2s[1], mx, my, dx, dy);
  float re = perp_residual(l2e[0], l2e[1], mx, my, dx, dy);
  return rs * rs + re * re;
}

__device__ __forceinline__ float nan_min(float e, float th) {
  return isnan(e) ? e : fminf(e, th);
}

__device__ float block_sum(float v, float* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? shared[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads) pose_score_kernel(
    const float* __restrict__ qvec, const float* __restrict__ tvec,
    const float* __restrict__ kvec, const float* __restrict__ p3,
    const float* __restrict__ p2, long long Np,
    const float* __restrict__ l3s, const float* __restrict__ l3e,
    const float* __restrict__ l2s, const float* __restrict__ l2e,
    long long Nl, float th_pt2, float th_ln2, float wp, float wl, int errors,
    float* __restrict__ scores, void* __restrict__ out_p,
    void* __restrict__ out_l) {
  __shared__ float shared[kThreads / 32];
  long long h = blockIdx.x;
  Pose P;
  P.qw = qvec[4 * h]; P.qx = qvec[4 * h + 1];
  P.qy = qvec[4 * h + 2]; P.qz = qvec[4 * h + 3];
  P.tx = tvec[3 * h]; P.ty = tvec[3 * h + 1]; P.tz = tvec[3 * h + 2];
  P.fx = kvec[0]; P.fy = kvec[1]; P.cx = kvec[2]; P.cy = kvec[3];

  float sp = 0.f, sl = 0.f;
  for (long long j = threadIdx.x; j < Np; j += kThreads) {
    float e = point_error(P, p3 + 3 * j, p2 + 2 * j);
    if (errors) {
      ((float*)out_p)[h * Np + j] = e;
    } else {
      ((unsigned char*)out_p)[h * Np + j] = e <= th_pt2;
      sp += nan_min(e, th_pt2);
    }
  }
  for (long long j = threadIdx.x; j < Nl; j += kThreads) {
    float e = line_error(P, l3s + 3 * j, l3e + 3 * j, l2s + 2 * j,
                         l2e + 2 * j);
    if (errors) {
      ((float*)out_l)[h * Nl + j] = e;
    } else {
      ((unsigned char*)out_l)[h * Nl + j] = e <= th_ln2;
      sl += nan_min(e, th_ln2);
    }
  }
  if (errors) return;
  sp = block_sum(sp, shared);
  sl = block_sum(sl, shared);
  if (threadIdx.x == 0) scores[h] = wp * sp + wl * sl;
}

}  // namespace

extern "C" int pose_score_launch(const void* qvec, const void* tvec,
                                 const void* kvec, const void* p3,
                                 const void* p2, long long Np,
                                 const void* l3s, const void* l3e,
                                 const void* l2s, const void* l2e,
                                 long long Nl, long long H, float th_pt2,
                                 float th_ln2, float wp, float wl,
                                 long long errors, void* scores, void* out_p,
                                 void* out_l, void* stream) {
  pose_score_kernel<<<(unsigned)H, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)qvec, (const float*)tvec, (const float*)kvec,
      (const float*)p3, (const float*)p2, Np, (const float*)l3s,
      (const float*)l3e, (const float*)l2s, (const float*)l2e, Nl, th_pt2,
      th_ln2, wp, wl, (int)errors, (float*)scores, out_p, out_l);
  return (int)cudaGetLastError();
}
