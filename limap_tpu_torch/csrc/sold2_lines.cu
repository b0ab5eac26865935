// Kernels T and U: SOLD2's line segment detection from junctions and a
// line heatmap.  They share the heatmap samplers.
//
// T, sold2_candidates, replaces the jitted _local_max_sample
// (limap_tpu/line2d/sold2/detection.py:155) with the candidate
// suppression of _suppressed (:278-299), the sample points of
// _sample_candidates (:252-276) and the decision (:241-244).  In: the
// junctions [J, 2] f64 (h, w), the candidate pairs (si, ei) [C] (the upper
// triangle, i < j), the heatmap [H, W] (f32 for the local max, f64 for
// the bilinear sampler), the sample positions t and 1 - t [S] f64 and the
// patch offsets [P, 2] f32 (a disc of radius 3: 29).  Out per candidate:
// detected u8, the mean of its samples f64 (NaN where suppressed) and its
// count of samples above the threshold.
//
// U, sold2_refine_junctions, replaces _refine_junctions (:301-329),
// which the reference runs as float64 numpy: each detected segment's two
// endpoints are moved on a 4-D grid of 9^4 = 6,561 perturbations of
// 0.25 px, each perturbed segment scored by the mean of S = 64 bilinear
// samples of the float64 heatmap, and the first best kept.  In: segments
// [G, 2, 2] f64, the heatmap f64, t and 1 - t, the perturbation values
// [K] f64; out: the refined segments [G, 2, 2] f64, clipped to the image.
//
// Bounds.  T: operations (per candidate J suppression tests of ~20
// float64 operations and S x P samples of ~10 fp32 operations against a
// few bytes; ops/sold2_lines.py::candidates_work).  U: operations (per
// segment 6,561 x 64 bilinear samples of ~25 float64 operations;
// ::refine_work).  Designs: T takes a warp a candidate (its lanes strided
// over the junctions for the suppression test, with a ballot count, then
// over the samples, a lane a sample and its 29 offsets); U takes a block
// a segment (the perturbations strided over its 256 threads, a thread
// the 64 samples of one, then a shared-memory argmax that keeps the
// lower index on ties: the reference's np.argmax).  Both run float64 on
// the card's FP64 units where the reference runs float64.
//
// Numerics.  Every product and sum is an _rn intrinsic in the
// reference's order (no multiply-add contraction); the float32 rounding
// of the sample points and the distance thresholds is the reference's
// astype(float32); rintf rounds half to even as jnp.round.  A mean is
// numpy's pairwise sum (eight accumulators for S <= 128) divided by S,
// in float32 for the local max and float64 for the bilinear samples, so
// the plain versions (ops/sold2_lines.py) and numpy agree bit for bit.
// The bilinear sampler weighs the corners by ceil - x and x - floor, so
// a sample at an integer coordinate is 0, as in the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int T_WARPS = 8;
constexpr int U_THREADS = 256;
constexpr int MAX_S = 128;

__device__ __forceinline__ double dclip(double x, double hi) {
  return fmin(fmax(x, 0.0), hi);
}

// heatmap[hf, wf] (hc - h)(wc - w) + heatmap[hf, wc] (hc - h)(w - wf)
// + heatmap[hc, wf] (h - hf)(wc - w) + heatmap[hc, wc] (h - hf)(w - wf)
__device__ __forceinline__ double bilinear(const double* hm, int W, double h,
                                           double w) {
  const double hf = floor(h), hc = ceil(h), wf = floor(w), wc = ceil(w);
  const long long ihf = (long long)hf, ihc = (long long)hc;
  const long long iwf = (long long)wf, iwc = (long long)wc;
  const double a = __dsub_rn(hc, h), b = __dsub_rn(h, hf);
  const double c = __dsub_rn(wc, w), d = __dsub_rn(w, wf);
  double s = __dmul_rn(__dmul_rn(hm[ihf * W + iwf], a), c);
  s = __dadd_rn(s, __dmul_rn(__dmul_rn(hm[ihf * W + iwc], a), d));
  s = __dadd_rn(s, __dmul_rn(__dmul_rn(hm[ihc * W + iwf], b), c));
  return __dadd_rn(s, __dmul_rn(__dmul_rn(hm[ihc * W + iwc], b), d));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// numpy's pairwise sum (n <= 128) of values that arrive one at a time:
// eight accumulators for the first n - n % 8, then the rest in order; a
// plain sum below 8
template <class F>
struct PairwiseSum {
  int n, i = 0;
  F r[8], res = 0;
  __device__ explicit PairwiseSum(int n_) : n(n_) {}
  __device__ void push(F x) {
    const int body = n - n % 8;
    if (n < 8) {
      res = add(res, x);
    } else if (i < 8) {
      r[i] = x;
    } else if (i < body) {
      r[i % 8] = add(r[i % 8], x);
    } else {
      res = add(res, x);
    }
    if (n >= 8 && i == body - 1)
      res = add(add(add(r[0], r[1]), add(r[2], r[3])),
                add(add(r[4], r[5]), add(r[6], r[7])));
    ++i;
  }
};

template <class F>
__device__ F pairwise_sum(const F* x, int n) {
  PairwiseSum<F> acc(n);
  for (int k = 0; k < n; ++k) acc.push(x[k]);
  return acc.res;
}

struct CandArgs {
  const float* hm32;
  const double* hm64;
  const double* junc;
  const int* si;
  const int* ei;
  const double* t;
  const double* omt;
  const float* offsets;
  int C, J, H, W, S, P, bilinear_mode, suppress;
  double nms_tol, lambda_radius, diag, half_diag_px, detect_thresh,
      inlier_thresh;
  unsigned char* detected;
  double* mean;
  int* inliers;
};

// the reference's _suppressed for one junction k of candidate (s, e)
__device__ __forceinline__ bool on_line(const double* junc, int k, double sh,
                                        double sw, double dir_h, double dir_w,
                                        double len_eps, double tol) {
  const double vh = __dsub_rn(junc[2 * k], sh);
  const double vw = __dsub_rn(junc[2 * k + 1], sw);
  const double cn = sqrt(__dadd_rn(__dmul_rn(vh, vh), __dmul_rn(vw, vw)));
  const double dot = __dadd_rn(__dmul_rn(vh, dir_h), __dmul_rn(vw, dir_w));
  const double proj = __ddiv_rn(dot, len_eps);
  const double cosang = __ddiv_rn(dot, cn > 0.0 ? cn : 1.0);
  const double perp = __dmul_rn(cn, sin(acos(fmin(fmax(cosang, -1.0), 1.0))));
  return perp <= tol && proj >= 0.0 && proj <= 1.0;
}

__global__ void __launch_bounds__(32 * T_WARPS) candidates_kernel(CandArgs a) {
  __shared__ float f32[T_WARPS][MAX_S];
  __shared__ double f64[T_WARPS][MAX_S];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * T_WARPS + warp;
  if (c >= a.C) return;  // a whole warp
  const int i = a.si[c], j = a.ei[c];
  const double sh = a.junc[2 * i], sw = a.junc[2 * i + 1];
  const double eh = a.junc[2 * j], ew = a.junc[2 * j + 1];

  if (a.suppress) {
    const double dh = __dsub_rn(eh, sh), dw = __dsub_rn(ew, sw);
    const double len = sqrt(__dadd_rn(__dmul_rn(dh, dh), __dmul_rn(dw, dw)));
    const double len_eps = __dadd_rn(len, 1e-12);
    const double dir_h = __ddiv_rn(dh, len_eps), dir_w = __ddiv_rn(dw, len_eps);
    int count = 0;
    for (int k0 = 0; k0 < a.J; k0 += 32) {
      const int k = k0 + lane;
      const bool on = k < a.J && k != i && k != j &&
                      on_line(a.junc, k, sh, sw, dir_h, dir_w, len_eps,
                              a.nms_tol);
      count += __popc(__ballot_sync(FULL, on));
    }
    if (count > 0) {
      if (lane == 0) {
        a.detected[c] = 0;
        a.mean[c] = NAN;
        a.inliers[c] = -1;
      }
      return;
    }
  }

  const double hmax = (double)(a.H - 1), wmax = (double)(a.W - 1);
  float dth = 0.f;
  if (!a.bilinear_mode) {
    const double dh = __dsub_rn(sh, eh), dw = __dsub_rn(sw, ew);
    const double len = sqrt(__dadd_rn(__dmul_rn(dh, dh), __dmul_rn(dw, dw)));
    dth = __double2float_rn(__dadd_rn(
        a.half_diag_px, __dmul_rn(a.lambda_radius, __ddiv_rn(len, a.diag))));
  }
  for (int s = lane; s < a.S; s += 32) {
    const double ch64 = dclip(__dadd_rn(__dmul_rn(sh, a.t[s]),
                                        __dmul_rn(eh, a.omt[s])), hmax);
    const double cw64 = dclip(__dadd_rn(__dmul_rn(sw, a.t[s]),
                                        __dmul_rn(ew, a.omt[s])), wmax);
    if (a.bilinear_mode) {
      f64[warp][s] = bilinear(a.hm64, a.W, ch64, cw64);
      continue;
    }
    const float ch = __double2float_rn(ch64), cw = __double2float_rn(cw64);
    const float rh = rintf(ch), rw = rintf(cw);
    float best = -INFINITY;
    for (int p = 0; p < a.P; ++p) {
      const float ph = __fadd_rn(rh, a.offsets[2 * p]);
      const float pw = __fadd_rn(rw, a.offsets[2 * p + 1]);
      const float dh = __fsub_rn(ch, ph), dw = __fsub_rn(cw, pw);
      const float d = sqrtf(__fadd_rn(__fmul_rn(dh, dh), __fmul_rn(dw, dw)));
      const int py = (int)fminf(fmaxf(ph, 0.f), (float)(a.H - 1));
      const int px = (int)fminf(fmaxf(pw, 0.f), (float)(a.W - 1));
      const float v = __fmul_rn(a.hm32[(long long)py * a.W + px],
                                d < dth ? 1.f : 0.f);
      best = fmaxf(best, v);
    }
    f32[warp][s] = best;
  }
  __syncwarp();
  if (lane != 0) return;
  int above = 0;
  bool det;
  double mean;
  if (a.bilinear_mode) {
    for (int s = 0; s < a.S; ++s) above += f64[warp][s] > a.detect_thresh;
    mean = __ddiv_rn(pairwise_sum(f64[warp], a.S), (double)a.S);
    det = mean > a.detect_thresh;
  } else {
    const float th = __double2float_rn(a.detect_thresh);
    for (int s = 0; s < a.S; ++s) above += f32[warp][s] > th;
    const float m = __fdiv_rn(pairwise_sum(f32[warp], a.S), (float)a.S);
    mean = (double)m;
    det = m > th;
  }
  if (a.inlier_thresh > 0.0)
    det = det && __ddiv_rn((double)above, (double)a.S) >= a.inlier_thresh;
  a.detected[c] = det ? 1 : 0;
  a.mean[c] = mean;
  a.inliers[c] = above;
}

struct RefineArgs {
  const double* segs;  // [G, 4]: start h, w, end h, w
  const double* hm64;
  const double* t;
  const double* omt;
  const double* vec;   // [K]
  int G, H, W, S, K;
  double* out;         // [G, 4]
};

// perturbation q = ((a K + b) K + c) K + d moves the start by (vec[a],
// vec[b]) and the end by (vec[c], vec[d]); each coordinate clipped
__device__ __forceinline__ void perturbed(const RefineArgs& r, int g, int q,
                                          double* p) {
  int idx[4];
  for (int k = 3; k >= 0; --k) {
    idx[k] = q % r.K;
    q /= r.K;
  }
  const double hmax = (double)(r.H - 1), wmax = (double)(r.W - 1);
  for (int k = 0; k < 4; ++k)
    p[k] = dclip(__dadd_rn(r.segs[4 * g + k], r.vec[idx[k]]),
                 (k & 1) ? wmax : hmax);
}

__global__ void __launch_bounds__(U_THREADS) refine_kernel(RefineArgs r) {
  __shared__ double best_s[U_THREADS];
  __shared__ int best_q[U_THREADS];
  const int g = blockIdx.x;
  const int n = r.K * r.K * r.K * r.K;
  const double hmax = (double)(r.H - 1), wmax = (double)(r.W - 1);
  double bs = -INFINITY;
  int bq = n;
  for (int q = threadIdx.x; q < n; q += U_THREADS) {
    double p[4];
    perturbed(r, g, q, p);
    auto sample = [&](int s) {
      const double ch = dclip(__dadd_rn(__dmul_rn(p[0], r.t[s]),
                                        __dmul_rn(p[2], r.omt[s])), hmax);
      const double cw = dclip(__dadd_rn(__dmul_rn(p[1], r.t[s]),
                                        __dmul_rn(p[3], r.omt[s])), wmax);
      return bilinear(r.hm64, r.W, ch, cw);
    };
    // numpy's pairwise sum, its eight accumulators kept in registers
    double sum = 0.0;
    int s = 0;
    if (r.S >= 8) {
      double acc[8];
      const int body = r.S - r.S % 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = sample(k);
      for (s = 8; s < body; s += 8) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = __dadd_rn(acc[k], sample(s + k));
      }
      sum = add(add(add(acc[0], acc[1]), add(acc[2], acc[3])),
                add(add(acc[4], acc[5]), add(acc[6], acc[7])));
    }
    for (; s < r.S; ++s) sum = __dadd_rn(sum, sample(s));
    const double score = __ddiv_rn(sum, (double)r.S);
    if (score > bs) {  // ascending q: the first best stays
      bs = score;
      bq = q;
    }
  }
  best_s[threadIdx.x] = bs;
  best_q[threadIdx.x] = bq;
  __syncthreads();
  for (int off = U_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      const double s2 = best_s[threadIdx.x + off];
      const int q2 = best_q[threadIdx.x + off];
      if (s2 > best_s[threadIdx.x] ||
          (s2 == best_s[threadIdx.x] && q2 < best_q[threadIdx.x])) {
        best_s[threadIdx.x] = s2;
        best_q[threadIdx.x] = q2;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double p[4];
    perturbed(r, g, best_q[0] < n ? best_q[0] : 0, p);
    for (int k = 0; k < 4; ++k) r.out[4 * g + k] = p[k];
  }
}

}  // namespace

// T.  p: hm32, hm64, junc, si, ei, t, omt, offsets, detected, mean,
// inliers.  n: C, J, H, W, S, P, bilinear_mode, suppress.  f: nms_tol,
// lambda_radius, diag, half_diag_px, detect_thresh, inlier_thresh.
extern "C" int sold2_candidates_launch(void** p, const int* n,
                                       const double* f, void* stream) {
  CandArgs a{(const float*)p[0], (const double*)p[1], (const double*)p[2],
             (const int*)p[3], (const int*)p[4], (const double*)p[5],
             (const double*)p[6], (const float*)p[7],
             n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7],
             f[0], f[1], f[2], f[3], f[4], f[5],
             (unsigned char*)p[8], (double*)p[9], (int*)p[10]};
  if (a.C <= 0) return 0;
  if (a.S > MAX_S) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a.C + T_WARPS - 1) / T_WARPS);
  candidates_kernel<<<blocks, 32 * T_WARPS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// U.  p: segs, hm64, t, omt, vec, out.  n: G, H, W, S, K.
extern "C" int sold2_refine_launch(void** p, const int* n, void* stream) {
  RefineArgs r{(const double*)p[0], (const double*)p[1], (const double*)p[2],
               (const double*)p[3], (const double*)p[4],
               n[0], n[1], n[2], n[3], n[4], (double*)p[5]};
  if (r.G <= 0) return 0;
  if (r.S > MAX_S) return (int)cudaErrorInvalidValue;
  refine_kernel<<<r.G, U_THREADS, 0, (cudaStream_t)stream>>>(r);
  return (int)cudaGetLastError();
}
