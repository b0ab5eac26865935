// The Levenberg-Marquardt program shared by kernels H (lm_line_ba.cu), I
// (lm_jointloc.cu), K (lm_line_refine.cu) and L and M (lm_assoc.cu):
// forward-mode dual numbers, the quaternion, SO(2) and axis-angle helpers,
// the retractions, bilinear sampling, the unrolled Cholesky, the lambda
// schedule and the per-row LM loop.
//
// It replaces the jitted program of limap_tpu/optimize/lm.py:64
// (_build_lm_runner with solve_spd :31, retract_quat_so2 :159 and
// retract_pose :176).  The port's plain version is lm_solve in
// limap_tpu_torch/optimize/lm.py: a vmapped torch.func.jvp over the D
// tangent directions.  Here a residual is written once, templated on its
// scalar, and evaluated on Jet<D> (a value and D tangents) at delta = 0
// through the retraction, which is that jvp.  Each Jet operation takes
// torch's forward-mode formula (div: (a' - b' r) / b; sqrt: a' / (2 r);
// abs: a' sgn(a) with sgn(0) = 0; acos: -a' / sqrt(1 - a^2); clamp passes
// the tangent where the bound is not exceeded; a vector norm's tangent is 0
// where the norm is 0; an operand without tangent contributes none), so
// the corners (inf and NaN from acos at 1, zero derivatives of abs at 0)
// come out as the plain version's.
//
// Every thread of a team (a warp for H, a block for I) runs the same LM
// loop on the same row: the items of the row (supports, matches) are split
// over the team, their sums reduced so that every thread holds bitwise the
// same totals, and the 4x4 or 6x6 solve, the retraction and the accept
// test are then repeated by every thread.  Nothing is broadcast.
//
// Compiles as host C++ too (without __CUDACC__), for tests of the
// arithmetic on a CPU.
//
// Kernels H, K, L and M run lm_row; kernel I runs its own fused loop
// (one pass and one sum an iteration, lm_jointloc.cu) and keeps lm_row
// only in its first design: a PR redesigns two kernels, and the gates of
// H, K, L and M hold the bits lm_row gives them.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define LM_FN __host__ __device__ __forceinline__
#else
#define LM_FN inline
#endif

namespace lm {

constexpr float EPS = 1e-12f;

// ---------------------------------------------------------------- Jet
template <int D>
struct Jet {
  float v;
  float d[D];
};

LM_FN float val(float x) { return x; }
template <int D>
LM_FN float val(const Jet<D>& x) { return x.v; }

// the tangent direction k at value 0 (delta = 0 of the retraction)
template <int D>
LM_FN Jet<D> jet_basis(int k) {
  Jet<D> r;
  r.v = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = (i == k) ? 1.f : 0.f;
  return r;
}

template <int D>
LM_FN Jet<D> operator+(const Jet<D>& a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int D>
LM_FN Jet<D> operator+(const Jet<D>& a, float b) {
  Jet<D> r = a;
  r.v = a.v + b;
  return r;
}
template <int D>
LM_FN Jet<D> operator+(float a, const Jet<D>& b) {
  Jet<D> r = b;
  r.v = a + b.v;
  return r;
}
template <int D>
LM_FN Jet<D> operator-(const Jet<D>& a) {
  Jet<D> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int D>
LM_FN Jet<D> operator-(const Jet<D>& a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int D>
LM_FN Jet<D> operator-(const Jet<D>& a, float b) {
  Jet<D> r = a;
  r.v = a.v - b;
  return r;
}
template <int D>
LM_FN Jet<D> operator-(float a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = -b.d[i];
  return r;
}
template <int D>
LM_FN Jet<D> operator*(const Jet<D>& a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = b.d[i] * a.v + a.d[i] * b.v;
  return r;
}
template <int D>
LM_FN Jet<D> operator*(const Jet<D>& a, float b) {
  Jet<D> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int D>
LM_FN Jet<D> operator*(float a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a * b.d[i];
  return r;
}
template <int D>
LM_FN Jet<D> operator/(const Jet<D>& a, const Jet<D>& b) {
  Jet<D> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = (a.d[i] - b.d[i] * r.v) / b.v;
  return r;
}
template <int D>
LM_FN Jet<D> operator/(const Jet<D>& a, float b) {
  Jet<D> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] / b;
  return r;
}

// sqrt, abs, exp, sin, cos, acos, clamp, where: float and Jet alike
LM_FN float sqrt_(float a) { return sqrtf(a); }
template <int D>
LM_FN Jet<D> sqrt_(const Jet<D>& a) {
  Jet<D> r;
  r.v = sqrtf(a.v);
  const float two_r = 2.f * r.v;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] / two_r;
  return r;
}
LM_FN float abs_(float a) { return fabsf(a); }
template <int D>
LM_FN Jet<D> abs_(const Jet<D>& a) {
  const float s = a.v > 0.f ? 1.f : (a.v < 0.f ? -1.f : 0.f);
  Jet<D> r;
  r.v = fabsf(a.v);
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * s;
  return r;
}
LM_FN float exp_(float a) { return expf(a); }
template <int D>
LM_FN Jet<D> exp_(const Jet<D>& a) {
  Jet<D> r;
  r.v = expf(a.v);
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * r.v;
  return r;
}
LM_FN float sin_(float a) { return sinf(a); }
template <int D>
LM_FN Jet<D> sin_(const Jet<D>& a) {
  Jet<D> r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * c;
  return r;
}
LM_FN float cos_(float a) { return cosf(a); }
template <int D>
LM_FN Jet<D> cos_(const Jet<D>& a) {
  Jet<D> r;
  r.v = cosf(a.v);
  const float ms = -sinf(a.v);
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * ms;
  return r;
}
LM_FN float acos_(float a) { return acosf(a); }
template <int D>
LM_FN Jet<D> acos_(const Jet<D>& a) {
  // torch: a' * -rsqrt(-a * a + 1): -inf, inf or NaN (a' = 0) at a = 1
  Jet<D> r;
  r.v = acosf(a.v);
  const float g = -(1.f / sqrtf(-a.v * a.v + 1.f));
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = a.d[i] * g;
  return r;
}
// torch.clamp(a, max=m) / (a, min=m): NaN stays NaN; the tangent passes
// where a <= m (>= m), bound included
LM_FN float clamp_max_(float a, float m) { return a > m ? m : a; }
template <int D>
LM_FN Jet<D> clamp_max_(const Jet<D>& a, float m) {
  Jet<D> r;
  r.v = a.v > m ? m : a.v;
  const bool pass = a.v <= m;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = pass ? a.d[i] : 0.f;
  return r;
}
LM_FN float clamp_min_(float a, float m) { return a < m ? m : a; }
template <int D>
LM_FN Jet<D> clamp_min_(const Jet<D>& a, float m) {
  Jet<D> r;
  r.v = a.v < m ? m : a.v;
  const bool pass = a.v >= m;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = pass ? a.d[i] : 0.f;
  return r;
}
// torch.linalg.vector_norm of n entries; the tangent is 0 at a zero norm
LM_FN float norm_(const float* a, int n) {
  float s = a[0] * a[0];
  for (int i = 1; i < n; ++i) s = s + a[i] * a[i];
  return sqrtf(s);
}
template <int D>
LM_FN Jet<D> norm_(const Jet<D>* a, int n) {
  Jet<D> r;
  float s = a[0].v * a[0].v;
  for (int i = 1; i < n; ++i) s = s + a[i].v * a[i].v;
  r.v = sqrtf(s);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float t = a[0].v * a[0].d[k];
    for (int i = 1; i < n; ++i) t = t + a[i].v * a[i].d[k];
    r.d[k] = r.v == 0.f ? 0.f : t / r.v;
  }
  return r;
}

template <typename A, typename B>
using Prod = decltype(A() * B());

// ------------------------------------------------------------ vectors
template <typename S>
struct V2 {
  S x, y;
};
template <typename S>
struct V3 {
  S v[3];
};
template <typename S>
struct V4 {
  S v[4];
};

template <typename A, typename B>
LM_FN V3<Prod<A, B>> cross(const V3<A>& a, const V3<B>& b) {
  return {{a.v[1] * b.v[2] - a.v[2] * b.v[1],
           a.v[2] * b.v[0] - a.v[0] * b.v[2],
           a.v[0] * b.v[1] - a.v[1] * b.v[0]}};
}
template <typename A, typename B>
LM_FN Prod<A, B> dot3(const V3<A>& a, const V3<B>& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}
// x / (|x| + EPS), the port's _normalize and Segments.direction
template <typename S>
LM_FN V3<S> normalize3(const V3<S>& a) {
  const S n = norm_(a.v, 3) + EPS;
  return {{a.v[0] / n, a.v[1] / n, a.v[2] / n}};
}

// ------------------------------------------------ quaternions (w, x, y, z)
template <typename A, typename B>
LM_FN V4<Prod<A, B>> quat_multiply(const V4<A>& a, const V4<B>& b) {
  const A &w1 = a.v[0], &x1 = a.v[1], &y1 = a.v[2], &z1 = a.v[3];
  const B &w2 = b.v[0], &x2 = b.v[1], &y2 = b.v[2], &z2 = b.v[3];
  return {{w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
           w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
           w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
           w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2}};
}
template <typename S>
LM_FN V4<S> quat_normalize(const V4<S>& q) {
  const S n = norm_(q.v, 4) + EPS;
  return {{q.v[0] / n, q.v[1] / n, q.v[2] / n, q.v[3] / n}};
}
template <typename S>
LM_FN V4<S> quat_conjugate(const V4<S>& q) {
  return {{q.v[0] * 1.f, q.v[1] * -1.f, q.v[2] * -1.f, q.v[3] * -1.f}};
}
// v + 2 (w (u x v) + u x (u x v)), q as it is (not normalized)
template <typename A, typename B>
LM_FN V3<Prod<A, B>> quat_rotate(const V4<A>& q, const V3<B>& v) {
  const V3<A> u = {{q.v[1], q.v[2], q.v[3]}};
  const auto uv = cross(u, v);
  const auto uuv = cross(u, uv);
  V3<Prod<A, B>> r;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.v[i] = v.v[i] + 2.f * (q.v[0] * uv.v[i] + uuv.v[i]);
  return r;
}
// columns 0 and 1 of the rotation of the normalized q
template <typename S>
LM_FN void quat_to_rotmat_cols01(const V4<S>& q0, V3<S>& c0, V3<S>& c1) {
  const V4<S> q = quat_normalize(q0);
  const S &w = q.v[0], &x = q.v[1], &y = q.v[2], &z = q.v[3];
  const S ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const S wy = w * y, wz = w * z, wx = w * x;
  const S xy = x * y, xz = x * z, yz = y * z;
  c0 = {{ww + xx - yy - zz, 2.f * (xy + wz), 2.f * (xz - wy)}};
  c1 = {{2.f * (xy - wz), ww - xx + yy - zz, 2.f * (yz + wx)}};
}
// exponential map with the small-angle series below theta^2 = 1e-12,
// the branch the Jacobian at delta = 0 takes
template <typename S>
LM_FN V4<S> axis_angle_to_quat(const S& a0, const S& a1, const S& a2) {
  const S t2 = a0 * a0 + a1 * a1 + a2 * a2;
  const S th = sqrt_(t2 + EPS);
  const S half = 0.5f * th;
  const S k = val(t2) > 1e-12f ? sin_(half) / th : 0.5f - t2 / 48.f;
  return {{cos_(half), k * a0, k * a1, k * a2}};
}

// ------------------------------------------------------- retractions
// minimal line (uvec [4], wvec [2]) + (so(3) [3], so(2) [1])
template <typename S>
LM_FN void retract_quat_so2(const float* p, const S* delta, S* out) {
  const V4<S> dq = axis_angle_to_quat(delta[0], delta[1], delta[2]);
  const V4<float> u = {{p[0], p[1], p[2], p[3]}};
  const V4<S> nu = quat_multiply(dq, u);
  const S c = cos_(delta[3]), s = sin_(delta[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = nu.v[i];
  out[4] = c * p[4] - s * p[5];
  out[5] = s * p[4] + c * p[5];
}

// pose (qvec [4], tvec [3]) + (so(3) [3], translation [3])
template <typename S>
LM_FN void retract_pose(const float* p, const S* delta, S* out) {
  const V4<S> dq = axis_angle_to_quat(delta[0], delta[1], delta[2]);
  const V4<float> q = {{p[0], p[1], p[2], p[3]}};
  const V4<S> nq = quat_multiply(dq, q);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = nq.v[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[4 + i] = p[4 + i] + delta[3 + i];
}

// a point's additive update: params [3] + delta [3]
template <typename S>
LM_FN void retract_add3(const float* p, const S* delta, S* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = p[i] + delta[i];
}

// ------------------------------------------------- bilinear sampling
// The plain interpolate_bilinear at (x, y) = (column, row) of a map of
// H x W texels, texel (row, col) channel c at base[(row * W + col) * C + c]:
// the cell floor(x), floor(y) clamped to [0, W - 2] and [0, H - 2] from the
// values (no tangent), the offsets clamped to [0, 1] (the tangent passes at
// the bounds, as torch.clamp's), and each channel summed in torch's order.
template <typename S>
struct Bilinear {
  int i00;          // offset of texel (y0, x0)
  int row;          // W * C: one row down
  int C;
  S gx0, gx1, gy0, gy1;  // 1 - fx, fx, 1 - fy, fy

  LM_FN Bilinear(int H, int W, int C_, const S& x, const S& y) : C(C_) {
    const float x0 = fminf(fmaxf(floorf(val(x)), 0.f), (float)(W - 2));
    const float y0 = fminf(fmaxf(floorf(val(y)), 0.f), (float)(H - 2));
    i00 = ((int)y0 * W + (int)x0) * C;
    row = W * C;
    gx1 = clamp_max_(clamp_min_(x - x0, 0.f), 1.f);
    gy1 = clamp_max_(clamp_min_(y - y0, 0.f), 1.f);
    gx0 = 1.f - gx1;
    gy0 = 1.f - gy1;
  }
  LM_FN S operator()(const float* base, int c) const {
    const float* p = base + i00 + c;
    return p[0] * gx0 * gy0 + p[C] * gx1 * gy0 + p[row] * gx0 * gy1
           + p[row + C] * gx1 * gy1;
  }
};

// ------------------------------------------------------------- solve
// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
LM_FN float nan_to_num(float x) {
  if (x != x) return 0.f;
  if (x == INFINITY) return FLT_MAX;
  if (x == -INFINITY) return -FLT_MAX;
  return x;
}

// The plain solve_spd: Cholesky with pivots clamped at 1e-12 (NaN
// propagates), forward and backward substitution, in its order.
template <int D>
LM_FN void solve_spd(const float (&A)[D][D], const float (&b)[D],
                     float (&x)[D]) {
  float L[D][D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(clamp_min_(s, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// ------------------------------------------------ robust losses (IRLS)
enum Loss { TRIVIAL = 0, CAUCHY = 1, HUBER = 2 };

// rho'(r2), as the plain robust_weight computes it in float32 (a Python
// scalar over a tensor is the tensor's reciprocal times the scalar)
LM_FN float robust_weight(float r2, int loss, float scale, float scale2) {
  if (loss == CAUCHY) return (1.f / (1.f + r2 / scale2)) * 1.f;
  if (loss == HUBER) {
    const float r = sqrtf(r2 + 1e-12f);
    return r <= scale ? 1.f : (1.f / r) * scale;
  }
  return 1.f;
}

// ------------------------------------------------------------ the loop
struct LMParams {
  int n_iter;
  float lam_init, lam_up, lam_down, lam_min, lam_max;
};

// Packed sums of a row: the lower triangle of J^T J (i >= j at
// i (i + 1) / 2 + j), then J^T r, then sum r^2.
template <int D>
struct NE {
  static constexpr int TRI = D * (D + 1) / 2;
  static constexpr int N = TRI + D + 1;
};

template <int D>
LM_FN void accumulate(float* acc, const Jet<D>& r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[k++] += r.d[i] * r.d[j];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[NE<D>::TRI + i] += r.d[i] * r.v;
  acc[NE<D>::TRI + D] += r.v * r.v;
}

// One row's whole solve.  ``params`` [P] in and out.  With ``ne`` set the
// row's normal equations at params0 go there ([D * D] J^T J, [D] J^T r,
// cost) and no iteration runs.  With ``trace`` set, iteration i writes
// (cost, new cost, params [P], new params [P]) at trace + i (2 + 2P).
template <int D, int P, class Problem, class Team>
LM_FN void lm_row(const Problem& pb, Team& team, const LMParams& lp,
                  float (&params)[P], float& cost0, float& cost_out,
                  int& n_acc_out, float* trace, float* ne) {
  constexpr int N = NE<D>::N;
  float cost = pb.cost(team, params);
  cost0 = cost;
  float lam = lp.lam_init;
  int n_acc = 0;
  const int n_iter = ne ? 0 : lp.n_iter;
  if (ne) {
    float acc[N];
    pb.normal_equations(team, params, acc);
    if (team.leader()) {
      for (int i = 0; i < D; ++i)
        for (int j = 0; j <= i; ++j) {
          const float a = acc[i * (i + 1) / 2 + j];
          ne[i * D + j] = a;
          ne[j * D + i] = a;
        }
      for (int i = 0; i < D; ++i) ne[D * D + i] = acc[NE<D>::TRI + i];
      ne[D * D + D] = acc[NE<D>::TRI + D];
    }
  }
  for (int it = 0; it < n_iter; ++it) {
    float acc[N];
    pb.normal_equations(team, params, acc);
    float A[D][D], b[D], x[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        A[i][j] = acc[i * (i + 1) / 2 + j];
        A[j][i] = A[i][j];
      }
      b[i] = acc[NE<D>::TRI + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
      A[i][i] = A[i][i] + lam * clamp_min_(A[i][i], 1e-8f);
    solve_spd<D>(A, b, x);
    float delta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) delta[i] = nan_to_num(-x[i]);
    float np[P];
    pb.retract(params, delta, np);
    const float new_cost = pb.cost(team, np);
    const bool accept = new_cost < cost;
    if (trace && team.leader()) {
      float* tr = trace + it * (2 + 2 * P);
      tr[0] = cost;
      tr[1] = new_cost;
      for (int i = 0; i < P; ++i) {
        tr[2 + i] = params[i];
        tr[2 + P + i] = np[i];
      }
    }
    if (accept) {
#pragma unroll
      for (int i = 0; i < P; ++i) params[i] = np[i];
      cost = new_cost;
      ++n_acc;
    }
    lam = accept ? lam * lp.lam_down : lam * lp.lam_up;
    lam = fminf(fmaxf(lam, lp.lam_min), lp.lam_max);
  }
  cost_out = cost;
  n_acc_out = n_acc;
}

// ------------------------------------------------------------- teams
// a single thread: the host's sequential reference
struct SerialTeam {
  LM_FN int rank() const { return 0; }
  LM_FN int size() const { return 1; }
  LM_FN bool leader() const { return true; }
  template <int N>
  LM_FN void sum(float (&)[N]) {}
  LM_FN float sum1(float a) { return a; }
};

// one warp a row: xor butterflies leave bitwise equal sums in every lane
struct WarpTeam {
  int lane;
  LM_FN int rank() const { return lane; }
  LM_FN int size() const { return 32; }
  LM_FN bool leader() const { return lane == 0; }
  template <int N>
  LM_FN void sum(float (&a)[N]) {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
#endif
  }
  LM_FN float sum1(float a) {
    float b[1] = {a};
    sum(b);
    return b[0];
  }
};

// one block a row: warp butterflies, then every thread adds the warps'
// partials in warp order from shared memory (scratch: warps x NMAX
// floats); ``tid`` and ``threads`` are the block's thread index and size
template <int NMAX>
struct BlockTeam {
  float* scratch;
  int tid, threads;
  LM_FN int rank() const { return tid; }
  LM_FN int size() const { return threads; }
  LM_FN bool leader() const { return tid == 0; }
  template <int N>
  LM_FN void sum(float (&a)[N]) {
    static_assert(N <= NMAX, "scratch too small");
#ifdef __CUDA_ARCH__
    const int lane = tid & 31, warp = tid >> 5;
    const int nw = (threads + 31) >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
    __syncthreads();
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) scratch[warp * NMAX + k] = a[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = scratch[k];
      for (int w = 1; w < nw; ++w) s += scratch[w * NMAX + k];
      a[k] = s;
    }
#endif
  }
  LM_FN float sum1(float a) {
    float b[1] = {a};
    sum(b);
    return b[0];
  }
};

}  // namespace lm
