// Kernel Y: L2D2's line-aligned 48 x 32 patches.
//
// Replaces the host loop of L2D2Extractor.extract over get_patch
// (limap_tpu/line2d/l2d2.py:114): a cv2.warpAffine of the whole image a
// line, a crop and a cv2.resize to 48 x 32.  In: the image [H, W] f32, the
// inverse maps [N, 6] f32 and the crops [N, 4] int32 (first row and column
// in the warped plane, height, width); out: patches [N, 48, 32] f32.
// Output texel (i, j) of a line is the resize's half-pixel bilinear of
// four texels of the warped plane (taps computed in float64 from the
// crop's size, float32 fractions, clipped at the crop's edges, as
// util/cv2_ops.resize); warped texel (X, Y) is the image's bilinear at
// sx = m0 X + (m1 Y + m2), sy = m3 X + (m4 Y + m5) in float32, corners
// outside the image read as 0, lerped along x then y.
//
// Bound: the larger of the operations (~100 fp32 operations an output
// texel) and the bytes (each distinct image texel the bilinears read, as
// ops/l2d2_patches.py::image_texels counts them, and the patches
// written); chip_smoke computes both on its inputs.  Design: a block a
// line, a thread an output texel (1,536 a line, 6 a thread of 256), the
// image's texels from L2.  Every product and sum is an _rn intrinsic in
// the plain version's order (no multiply-add contraction), so the patches
// equal it bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PH = 48, PW = 32;
constexpr int THREADS = 256;

struct Tap {
  int a, b;
  float f;
};

// util/cv2_ops._linear_taps for input size n_in, output size n_out
__device__ __forceinline__ Tap linear_tap(int i, int n_in, int n_out) {
  const double scale = 1.0 / ((double)n_out / (double)n_in);
  const double f = ((double)i + 0.5) * scale - 0.5;
  const double s = floor(f);
  double frac = f - s;
  long long a = (long long)s;
  if (a < 0) {
    a = 0;
    frac = 0.0;
  }
  if (a >= n_in - 1) {
    a = n_in - 1;
    frac = 0.0;
  }
  Tap t;
  t.a = (int)a;
  t.b = (int)min(a + 1, (long long)n_in - 1);
  t.f = (float)frac;
  return t;
}

__device__ __forceinline__ float texel(const float* img, int H, int W, int y,
                                       int x) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? img[(long long)y * W + x]
                                              : 0.f;
}

__device__ __forceinline__ float warped(const float* img, int H, int W,
                                        const float* m, int X, int Y) {
  const float fX = (float)X, fY = (float)Y;
  const float sx = __fadd_rn(__fmul_rn(m[0], fX),
                             __fadd_rn(__fmul_rn(m[1], fY), m[2]));
  const float sy = __fadd_rn(__fmul_rn(m[3], fX),
                             __fadd_rn(__fmul_rn(m[4], fY), m[5]));
  const float fx0 = floorf(sx), fy0 = floorf(sy);
  const float ax = __fsub_rn(sx, fx0), ay = __fsub_rn(sy, fy0);
  const int x0 = (int)fx0, y0 = (int)fy0;
  const float p00 = texel(img, H, W, y0, x0), p01 = texel(img, H, W, y0, x0 + 1);
  const float p10 = texel(img, H, W, y0 + 1, x0);
  const float p11 = texel(img, H, W, y0 + 1, x0 + 1);
  const float a = __fadd_rn(p00, __fmul_rn(ax, __fsub_rn(p01, p00)));
  const float b = __fadd_rn(p10, __fmul_rn(ax, __fsub_rn(p11, p10)));
  return __fadd_rn(a, __fmul_rn(ay, __fsub_rn(b, a)));
}

__global__ void __launch_bounds__(THREADS)
    patches_kernel(const float* __restrict__ img, int H, int W,
                   const float* __restrict__ minv,
                   const int* __restrict__ boxes,
                   float* __restrict__ out) {
  const int n = blockIdx.x;
  __shared__ float m[6];
  if (threadIdx.x < 6) m[threadIdx.x] = minv[6 * n + threadIdx.x];
  __syncthreads();
  const int r0 = boxes[4 * n], c0 = boxes[4 * n + 1];
  const int ch = boxes[4 * n + 2], cw = boxes[4 * n + 3];
  for (int t = threadIdx.x; t < PH * PW; t += THREADS) {
    const int i = t / PW, j = t % PW;
    const Tap ty = linear_tap(i, ch, PH), tx = linear_tap(j, cw, PW);
    const float gx = __fsub_rn(1.f, tx.f), gy = __fsub_rn(1.f, ty.f);
    const int ya = r0 + ty.a, yb = r0 + ty.b;
    const int xa = c0 + tx.a, xb = c0 + tx.b;
    const float top = __fadd_rn(__fmul_rn(warped(img, H, W, m, xa, ya), gx),
                                __fmul_rn(warped(img, H, W, m, xb, ya), tx.f));
    const float bot = __fadd_rn(__fmul_rn(warped(img, H, W, m, xa, yb), gx),
                                __fmul_rn(warped(img, H, W, m, xb, yb), tx.f));
    out[(long long)n * PH * PW + t] =
        __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, ty.f));
  }
}

}  // namespace

extern "C" int l2d2_patches_launch(const float* img, int H, int W,
                                   const float* minv, const int* boxes,
                                   int N, float* out, void* stream) {
  if (N <= 0) return 0;
  patches_kernel<<<N, THREADS, 0, (cudaStream_t)stream>>>(img, H, W, minv,
                                                          boxes, out);
  return (int)cudaGetLastError();
}
