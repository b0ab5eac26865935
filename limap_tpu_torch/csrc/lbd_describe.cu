// Kernel V: the Line Band Descriptor (LBD) of every line of an image.
//
// Replaces the jitted lbd_describe (limap_tpu/line2d/lbd.py:67).  In: the
// image [H, W] f32, segments [N, 4] f32, valid [N] bool, the global
// Gaussian wg [63] and the local Gaussians wl [9, 63] (zero outside a
// band's neighbourhood; computed by the wrapper with the plain version's
// ops); out: descriptors [N, 72] f32.  A line's support region is 63
// rows across it (9 bands of 7) by 32 samples along it.  At each sample
// the central-difference gradients (replicated border) are interpolated
// bilinearly (coordinates clipped to [0, size - 1.001]) and projected on
// the line's direction and normal, times wg of the row.  For band j and
// column c the positive and negative parts of both projections are summed
// over the rows with weights wl[j]; per band the mean and the population
// std of each of the four over the 32 columns give 8 numbers; the 72 are
// L2-normalized, clamped at 0.4 and L2-normalized again.
//
// Bound: operations (~2,000 samples a line, each ~70 fp32 operations;
// the image is read once, ~2 MB at 600 x 800).  Design: a block a line.
// Pass 1, a thread a sample: position, gradients straight from the image
// (the first pass fused), projections, into shared memory (16 KB).  Pass
// 2, a thread a (band, column, part): the 21-row weighted sum.  Pass 3,
// a thread a (band, part): mean and std over the columns.  Pass 4, one
// warp: the two normalizations.  Positions, samples and projections use
// the _rn intrinsics in the plain version's order, so they are bit-equal
// to it; the sums over rows and columns are taken in another order than
// torch's, so the descriptors agree within float32 rounding (1e-5).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int M_BANDS = 9, W_BAND = 7, NS = 32;
constexpr int ROWS = M_BANDS * W_BAND;  // 63
constexpr int DIM = M_BANDS * 8;        // 72
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float grad_x(const float* img, int H, int W,
                                        int y, int x) {
  const float a = img[y * W + min(x + 1, W - 1)];
  const float b = img[y * W + max(x - 1, 0)];
  return __fmul_rn(__fsub_rn(a, b), 0.5f);
}

__device__ __forceinline__ float grad_y(const float* img, int H, int W,
                                        int y, int x) {
  const float a = img[min(y + 1, H - 1) * W + x];
  const float b = img[max(y - 1, 0) * W + x];
  return __fmul_rn(__fsub_rn(a, b), 0.5f);
}

// the reference's bilinear: v00 (1-fy)(1-fx) + v01 (1-fy) fx + v10 fy (1-fx)
// + v11 fy fx, left to right
__device__ __forceinline__ void sample(const float* img, int H, int W,
                                       float y, float x, float* gx,
                                       float* gy) {
  // the clip's bound rounded from float64, as torch rounds a Python float
  y = fminf(fmaxf(y, 0.f), (float)((double)H - 1.001));
  x = fminf(fmaxf(x, 0.f), (float)((double)W - 1.001));
  const float fy0 = floorf(y), fx0 = floorf(x);
  const int y0 = (int)fy0, x0 = (int)fx0;
  const float fy = __fsub_rn(y, fy0), fx = __fsub_rn(x, fx0);
  const float gy_ = __fsub_rn(1.f, fy), gx_ = __fsub_rn(1.f, fx);
  const float w00 = gy_, w01 = gy_, w10 = fy, w11 = fy;
  float ax = __fmul_rn(__fmul_rn(grad_x(img, H, W, y0, x0), w00), gx_);
  ax = __fadd_rn(ax, __fmul_rn(__fmul_rn(grad_x(img, H, W, y0, x0 + 1), w01), fx));
  ax = __fadd_rn(ax, __fmul_rn(__fmul_rn(grad_x(img, H, W, y0 + 1, x0), w10), gx_));
  ax = __fadd_rn(ax, __fmul_rn(__fmul_rn(grad_x(img, H, W, y0 + 1, x0 + 1), w11), fx));
  float ay = __fmul_rn(__fmul_rn(grad_y(img, H, W, y0, x0), w00), gx_);
  ay = __fadd_rn(ay, __fmul_rn(__fmul_rn(grad_y(img, H, W, y0, x0 + 1), w01), fx));
  ay = __fadd_rn(ay, __fmul_rn(__fmul_rn(grad_y(img, H, W, y0 + 1, x0), w10), gx_));
  ay = __fadd_rn(ay, __fmul_rn(__fmul_rn(grad_y(img, H, W, y0 + 1, x0 + 1), w11), fx));
  *gx = ax;
  *gy = ay;
}

__global__ void __launch_bounds__(THREADS)
    lbd_kernel(const float* __restrict__ img, int H, int W,
               const float* __restrict__ segs,
               const bool* __restrict__ valid,
               const float* __restrict__ wg, const float* __restrict__ wl,
               float t_step, float* __restrict__ out) {
  __shared__ float gO[ROWS * NS], gL[ROWS * NS];
  __shared__ float band[M_BANDS * 4 * NS];
  __shared__ float desc[DIM];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (long long)n * DIM;
  if (!valid[n]) {
    for (int k = tid; k < DIM; k += THREADS) o[k] = 0.f;
    return;
  }
  const float sx = segs[4 * n], sy = segs[4 * n + 1];
  const float dx = __fsub_rn(segs[4 * n + 2], sx);
  const float dy = __fsub_rn(segs[4 * n + 3], sy);
  const float len = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                   __fmul_rn(dy, dy)),
                                         1e-12f));
  const float lx = __fdiv_rn(dx, len), ly = __fdiv_rn(dy, len);
  const float ox = -ly, oy = lx;
  for (int s = tid; s < ROWS * NS; s += THREADS) {
    const int r = s / NS, c = s % NS;
    const float t = __fmul_rn((float)c, t_step);
    const float off = (float)r - (ROWS - 1) / 2.0f;
    const float px = __fadd_rn(__fadd_rn(sx, __fmul_rn(dx, t)),
                               __fmul_rn(ox, off));
    const float py = __fadd_rn(__fadd_rn(sy, __fmul_rn(dy, t)),
                               __fmul_rn(oy, off));
    float gx, gy;
    sample(img, H, W, py, px, &gx, &gy);
    gL[s] = __fmul_rn(__fadd_rn(__fmul_rn(gx, lx), __fmul_rn(gy, ly)), wg[r]);
    gO[s] = __fmul_rn(__fadd_rn(__fmul_rn(gx, ox), __fmul_rn(gy, oy)), wg[r]);
  }
  __syncthreads();
  for (int v = tid; v < M_BANDS * 4 * NS; v += THREADS) {
    const int j = v / (4 * NS), k = (v / NS) % 4, c = v % NS;
    const float* g = k < 2 ? gO : gL;
    const float sign = (k & 1) ? -1.f : 1.f;
    const int r0 = max((j - 1) * W_BAND, 0);
    const int r1 = min((j + 2) * W_BAND, ROWS);
    float acc = 0.f;
    for (int r = r0; r < r1; ++r)
      acc = __fadd_rn(acc, __fmul_rn(fmaxf(sign * g[r * NS + c], 0.f),
                                     wl[j * ROWS + r]));
    band[v] = acc;
  }
  __syncthreads();
  if (tid < M_BANDS * 4) {
    const int j = tid / 4, k = tid % 4;
    const float* b = band + (j * 4 + k) * NS;
    float sum = 0.f;
    for (int c = 0; c < NS; ++c) sum = __fadd_rn(sum, b[c]);
    const float mean = __fdiv_rn(sum, (float)NS);
    float var = 0.f;
    for (int c = 0; c < NS; ++c) {
      const float e = __fsub_rn(b[c], mean);
      var = __fadd_rn(var, __fmul_rn(e, e));
    }
    desc[j * 8 + k] = mean;
    desc[j * 8 + 4 + k] = __fsqrt_rn(__fdiv_rn(var, (float)NS));
  }
  __syncthreads();
  if (tid < 32) {
    float v[3];
    float ss = 0.f;
    for (int q = 0; q < 3; ++q) {
      const int k = tid + 32 * q;
      v[q] = k < DIM ? desc[k] : 0.f;
      ss = __fadd_rn(ss, __fmul_rn(v[q], v[q]));
    }
    for (int m = 16; m > 0; m >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, m));
    float inv = __fsqrt_rn(__fadd_rn(ss, 1e-12f));
    ss = 0.f;
    for (int q = 0; q < 3; ++q) {
      v[q] = fminf(__fdiv_rn(v[q], inv), 0.4f);
      ss = __fadd_rn(ss, __fmul_rn(v[q], v[q]));
    }
    for (int m = 16; m > 0; m >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, m));
    inv = __fsqrt_rn(__fadd_rn(ss, 1e-12f));
    for (int q = 0; q < 3; ++q) {
      const int k = tid + 32 * q;
      if (k < DIM) o[k] = __fdiv_rn(v[q], inv);
    }
  }
}

}  // namespace

extern "C" int lbd_describe_launch(const float* img, int H, int W,
                                   const float* segs, const bool* valid,
                                   int N, const float* wg, const float* wl,
                                   float t_step, float* out, void* stream) {
  if (N <= 0) return 0;
  lbd_kernel<<<N, THREADS, 0, (cudaStream_t)stream>>>(img, H, W, segs, valid,
                                                      wg, wl, t_step, out);
  return (int)cudaGetLastError();
}
