// Kernel S: bilinear sampling of a dense descriptor grid at points, each
// descriptor L2-normalized.
//
// Replaces the jitted sample_descriptors (limap_tpu/point2d/superpoint.py
// :90), which SuperPoint's keypoints and SuperPointEndpointsExtractor's
// endpoints take, and the numpy sampler of
// WunschLineMatcher.compute_descriptors (limap_tpu/line2d/sold2/sold2.py
// :182-209), which SOLD2's line points take.  In: the grid [Hc, Wc, D]
// f32 (channels last, as the reference), points [P, 2]; out: [P, D] f32.
//
//   clamp (SuperPoint): points f32 (x, y) in pixels; x = px / stride -
//     0.5, its cell x0 = floor(x) clipped to [0, Wc - 2] and fx = x - x0
//     clipped to [0, 1] (likewise y); the four corners' weighted sum in
//     float32, divided by its norm + 1e-8;
//   zero (SOLD2): points f64 (h, w) in pixels; grid_sample with
//     align_corners=False: u = p / grid - 0.5, a corner outside the grid
//     counts 0; in float64 as the reference's numpy, divided by its norm
//     + 1e-12, then rounded to float32.
//
// Bound: bytes.  Each point reads four rows of D channels and writes
// one; ops/sample_descriptors.py::work counts each distinct row the
// points read once.  Design: a warp a point, its lanes strided over the
// channels (256 or 128: 8 or 4 a lane, each corner row read as whole
// 128-byte lines), the squared norm a warp-shuffle sum.  The products and sums are the _rn intrinsics in the
// reference's order (no multiply-add contraction).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PER_LANE = 16;  // D <= 512

__device__ __forceinline__ float fsum_warp(float x) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ double dsum_warp(double x) {
  for (int o = 16; o > 0; o >>= 1) x = __dadd_rn(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__global__ void __launch_bounds__(32 * WARPS)
    clamp_kernel(const float* __restrict__ grid, int Hc, int Wc, int D,
                 const float* __restrict__ pts, int P, float stride,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;
  const float x = __fsub_rn(__fdiv_rn(pts[2 * p], stride), 0.5f);
  const float y = __fsub_rn(__fdiv_rn(pts[2 * p + 1], stride), 0.5f);
  const int x0 = min(max((int)floorf(x), 0), Wc - 2);
  const int y0 = min(max((int)floorf(y), 0), Hc - 2);
  const float fx = fminf(fmaxf(__fsub_rn(x, (float)x0), 0.f), 1.f);
  const float fy = fminf(fmaxf(__fsub_rn(y, (float)y0), 0.f), 1.f);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float* r00 = grid + ((long long)y0 * Wc + x0) * D;
  const float* r01 = r00 + D;
  const float* r10 = r00 + (long long)Wc * D;
  const float* r11 = r10 + D;
  float d[MAX_PER_LANE];
  float ss = 0.f;
  int n = 0;
  for (int c = lane; c < D; c += 32, ++n) {
    float t = __fmul_rn(__fmul_rn(r00[c], gx), gy);
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(r01[c], fx), gy));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(r10[c], gx), fy));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(r11[c], fx), fy));
    d[n] = t;
    ss = __fadd_rn(ss, __fmul_rn(t, t));
  }
  const float den = __fadd_rn(sqrtf(fsum_warp(ss)), 1e-8f);
  n = 0;
  for (int c = lane; c < D; c += 32, ++n)
    out[p * D + c] = __fdiv_rn(d[n], den);
}

__device__ __forceinline__ double corner(const float* grid, int Hc, int Wc,
                                         int D, int h, int w, int c) {
  if (h < 0 || h >= Hc || w < 0 || w >= Wc) return 0.0;
  return (double)grid[((long long)h * Wc + w) * D + c];
}

__global__ void __launch_bounds__(32 * WARPS)
    zero_kernel(const float* __restrict__ grid, int Hc, int Wc, int D,
                const double* __restrict__ pts, int P, double gsize,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;
  const double uh = __dsub_rn(__ddiv_rn(pts[2 * p], gsize), 0.5);
  const double uw = __dsub_rn(__ddiv_rn(pts[2 * p + 1], gsize), 0.5);
  const double fh0 = floor(uh), fw0 = floor(uw);
  const int h0 = (int)fh0, w0 = (int)fw0;
  const double fh = __dsub_rn(uh, fh0), fw = __dsub_rn(uw, fw0);
  const double gh = __dsub_rn(1.0, fh), gw = __dsub_rn(1.0, fw);
  const double w00 = __dmul_rn(gh, gw), w01 = __dmul_rn(gh, fw);
  const double w10 = __dmul_rn(fh, gw), w11 = __dmul_rn(fh, fw);
  double d[MAX_PER_LANE];
  double ss = 0.0;
  int n = 0;
  for (int c = lane; c < D; c += 32, ++n) {
    double t = __dmul_rn(corner(grid, Hc, Wc, D, h0, w0, c), w00);
    t = __dadd_rn(t, __dmul_rn(corner(grid, Hc, Wc, D, h0, w0 + 1, c), w01));
    t = __dadd_rn(t, __dmul_rn(corner(grid, Hc, Wc, D, h0 + 1, w0, c), w10));
    t = __dadd_rn(t,
                  __dmul_rn(corner(grid, Hc, Wc, D, h0 + 1, w0 + 1, c), w11));
    d[n] = t;
    ss = __dadd_rn(ss, __dmul_rn(t, t));
  }
  const double den = __dadd_rn(sqrt(dsum_warp(ss)), 1e-12);
  n = 0;
  for (int c = lane; c < D; c += 32, ++n)
    out[p * D + c] = __double2float_rn(__ddiv_rn(d[n], den));
}

}  // namespace

// mode 0 clamp (pts f32, scale = stride), mode 1 zero (pts f64, scale =
// grid size).
extern "C" int sample_descriptors_launch(const float* grid, int Hc, int Wc,
                                         int D, const void* pts, int P,
                                         int mode, double scale, float* out,
                                         void* stream) {
  if (P <= 0) return 0;
  const unsigned blocks = (unsigned)((P + WARPS - 1) / WARPS);
  if (mode == 0)
    clamp_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        grid, Hc, Wc, D, (const float*)pts, P, (float)scale, out);
  else
    zero_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        grid, Hc, Wc, D, (const double*)pts, P, scale, out);
  return (int)cudaGetLastError();
}
