// Hypothesis scoring of the batched line RANSAC (one launch for all the
// segments of all images).
//
// Replaces the [N, H, S] part of the jitted program of fit_lines_ransac
// (limap_tpu/fitting/fitting.py:93-113): for every segment n and every
// hypothesis h, the distance of each of its S sample points to the line
// through samples idx_a[n, h] and idx_b[n, h] (fitting.py:62,
// _point_line_dist), the count of valid points within inlier_th[n], -1
// when either sample is invalid, and the first hypothesis with the most
// inliers (an argmax picks the first).  Out: that hypothesis's inlier
// mask [N, S], n_inl, n_valid and best [N].
//
// Bound: operations.  Per (n, h, point) some 20 fp32 operations, N*H*S
// of them, against N*S*13 + N*H*8 bytes read; at the default S = 64,
// H = 32 that is ~40 operations a byte, above the card's fp32 ridge.
// Design: one warp a segment, its S points and flags in shared memory,
// the lanes along the points, the count by __popc(__ballot_sync).  The
// distance is computed with the _rn intrinsics in the order of the plain
// version (no FMA contraction), so the kernel agrees with it bit for bit
// and a distance within an ulp of the threshold falls the same way.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

struct Line {
  float ax, ay, az, dx, dy, dz;
};

__device__ __forceinline__ Line make_line(const float* p, int ia, int ib) {
  Line l;
  l.ax = p[3 * ia];
  l.ay = p[3 * ia + 1];
  l.az = p[3 * ia + 2];
  float dx = __fsub_rn(p[3 * ib], l.ax);
  float dy = __fsub_rn(p[3 * ib + 1], l.ay);
  float dz = __fsub_rn(p[3 * ib + 2], l.az);
  float n = __fadd_rn(__fsqrt_rn(dot3(dx, dy, dz, dx, dy, dz)), kEps);
  l.dx = __fdiv_rn(dx, n);
  l.dy = __fdiv_rn(dy, n);
  l.dz = __fdiv_rn(dz, n);
  return l;
}

// |disp|^2 - along^2 clamped at 0 (a NaN stays NaN, as torch.clamp and
// jnp.maximum keep it), then the root
__device__ __forceinline__ float dist(const Line& l, const float* p, int j) {
  float ex = __fsub_rn(p[3 * j], l.ax);
  float ey = __fsub_rn(p[3 * j + 1], l.ay);
  float ez = __fsub_rn(p[3 * j + 2], l.az);
  float along = dot3(ex, ey, ez, l.dx, l.dy, l.dz);
  float d2 = __fsub_rn(dot3(ex, ey, ez, ex, ey, ez), __fmul_rn(along, along));
  if (!isnan(d2)) d2 = fmaxf(d2, 0.f);
  return __fsqrt_rn(d2);
}

__global__ void __launch_bounds__(kWarps * 32) line_ransac_kernel(
    const float* __restrict__ points, const unsigned char* __restrict__ valid,
    const float* __restrict__ inlier_th, const int* __restrict__ idx_a,
    const int* __restrict__ idx_b, long long N, int S, int H,
    unsigned char* __restrict__ inliers, int* __restrict__ n_inl,
    int* __restrict__ n_valid, int* __restrict__ best_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + warp;
  if (n >= N) return;  // no block-wide barrier below: warps are independent
  float* p = smem + (size_t)warp * 3 * S;
  unsigned char* ok = reinterpret_cast<unsigned char*>(smem + kWarps * 3 * S)
                      + (size_t)warp * S;
  const float* src = points + n * 3 * S;
  for (int j = lane; j < 3 * S; j += 32) p[j] = src[j];
  int nv = 0;
  for (int j0 = 0; j0 < S; j0 += 32) {
    int j = j0 + lane;
    bool v = j < S && valid[n * S + j];
    if (j < S) ok[j] = v;
    nv += __popc(__ballot_sync(kFull, v));
  }
  __syncwarp();
  const float th = inlier_th[n];

  int best_count = INT_MIN, best = 0;
  for (int h = 0; h < H; ++h) {
    int ia = idx_a[n * H + h], ib = idx_b[n * H + h];
    Line l = make_line(p, ia, ib);
    int count = 0;
    for (int j0 = 0; j0 < S; j0 += 32) {
      int j = j0 + lane;
      bool in = j < S && ok[j] && dist(l, p, j) <= th;
      count += __popc(__ballot_sync(kFull, in));
    }
    if (!(ok[ia] && ok[ib])) count = -1;
    if (count > best_count) {
      best_count = count;
      best = h;
    }
  }

  Line l = make_line(p, idx_a[n * H + best], idx_b[n * H + best]);
  int ni = 0;
  for (int j0 = 0; j0 < S; j0 += 32) {
    int j = j0 + lane;
    bool in = j < S && ok[j] && dist(l, p, j) <= th;
    if (j < S) inliers[n * S + j] = in;
    ni += __popc(__ballot_sync(kFull, in));
  }
  if (lane == 0) {
    n_inl[n] = ni;
    n_valid[n] = nv;
    best_out[n] = best;
  }
}

}  // namespace

extern "C" int line_ransac_launch(const void* points, const void* valid,
                                  const void* inlier_th, const void* idx_a,
                                  const void* idx_b, long long N, long long S,
                                  long long H, void* inliers, void* n_inl,
                                  void* n_valid, void* best, void* stream) {
  size_t smem = (size_t)kWarps * S * (3 * sizeof(float) + 1);
  unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
  line_ransac_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const unsigned char*)valid,
      (const float*)inlier_th, (const int*)idx_a, (const int*)idx_b, N,
      (int)S, (int)H, (unsigned char*)inliers, (int*)n_inl, (int*)n_valid,
      (int*)best);
  return (int)cudaGetLastError();
}
