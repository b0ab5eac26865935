// All-pairs epipolar IoU of two images' 2D segments.
//
// Replaces the jitted XLA program of compute_epipolar_iou
// (limap_tpu/triangulation/functions.py:149, F=None) over the [Nr, Nt]
// pair grid that match_line_2to2_epipolar_iou
// (limap_tpu/runners/hybrid_localization.py:36) builds with meshgrid and
// views tiled per pair.  The two epipolar lines of a reference segment
// depend on its row alone, so the caller computes them once per row
// (normalized, in the target image) and the kernel does, per pair, the
// target's line coordinates, the two intersections and the IoU of the
// target segment with the band between them.
//
// Bound: bytes; it writes Nr x Nt fp32 IoUs and reads 24 bytes a row and
// 16 a column, at some 70 fp32 operations a pair.  Threads run along a
// row's target segments, so the writes are contiguous; a block's row
// values are the same for all its threads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// min / max that keep a NaN, as torch.minimum / torch.maximum do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__global__ void __launch_bounds__(kThreads) epipolar_iou_kernel(
    const float* __restrict__ tgt,
    const float* __restrict__ ep_s, const float* __restrict__ ep_e,
    long long Nt, float* __restrict__ iou) {
  long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  long long i = blockIdx.y;
  if (j >= Nt) return;
  float sx = tgt[4 * j], sy = tgt[4 * j + 1];
  float ex = tgt[4 * j + 2], ey = tgt[4 * j + 3];
  // normalized homogeneous coordinates of the target segment's line
  float hs[3] = {sx, sy, 1.f}, he[3] = {ex, ey, 1.f}, coor[3];
  cross3(hs, he, coor);
  float cn = sqrtf(coor[0] * coor[0] + coor[1] * coor[1] +
                   coor[2] * coor[2]) + kEps;
  coor[0] /= cn;
  coor[1] /= cn;
  coor[2] /= cn;
  float dx = ex - sx, dy = ey - sy;
  float len2 = sqrtf(dx * dx + dy * dy);
  float dirx = dx / (len2 + kEps), diry = dy / (len2 + kEps);

  float c[2];
  const float* lines[2] = {ep_s + 3 * i, ep_e + 3 * i};
  for (int k = 0; k < 2; ++k) {
    float ch[3];
    cross3(coor, lines[k], ch);
    float px = ch[0] / (ch[2] + kEps), py = ch[1] / (ch[2] + kEps);
    c[k] = ((px - sx) * dirx + (py - sy) * diry) / (len2 + kEps);
  }
  float lo = nan_min(c[0], c[1]), hi = nan_max(c[0], c[1]);
  iou[i * Nt + j] = (nan_min(hi, 1.f) - nan_max(lo, 0.f)) /
                    (nan_max(hi, 1.f) - nan_min(lo, 0.f) + kEps);
}

}  // namespace

extern "C" int epipolar_iou_launch(const void* tgt, const void* ep_s,
                                   const void* ep_e, long long Nr,
                                   long long Nt, void* iou, void* stream) {
  dim3 grid((unsigned)((Nt + kThreads - 1) / kThreads), (unsigned)Nr);
  epipolar_iou_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tgt, (const float*)ep_s, (const float*)ep_e, Nt,
      (float*)iou);
  return (int)cudaGetLastError();
}
