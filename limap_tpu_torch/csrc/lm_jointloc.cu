// Kernel I: the joint point+line pose solve of localization, every LM
// iteration of every pose chain in one launch.
//
// Replaces the jitted LM program of limap_tpu/optimize/lm.py:64
// (_build_lm_runner) with the residual of
// limap_tpu/optimize/hybrid_localization.py:235 (_jointloc_residual over
// line_loc_residuals :109), as solve_jointloc (:191) runs it.  The plain
// version is limap_tpu_torch/optimize/lm.py::lm_solve with
// optimize/hybrid_localization.py::_jointloc_residual.
//
// Rows: T pose chains (qvec [4], tvec [3]) on a 6-D tangent.  Data shared
// by all rows: N_l line matches (3D start and end, 2D start and end) and
// N_p point matches (3D, 2D), one camera (fx, fy, cx, cy); masks per row.
// Every LineLocConfig is a launch argument: the six cost functions, the
// five 2D weights, the three robust losses, weight_line and weight_point.
// A line's block is R_l in {2, 3, 4} residuals times its 2D weight, a
// point's the reprojection error; each is scaled by the square root of
// its type's weight times the IRLS weight of its detached block.
//
// Layout: one block a row, the threads over the line matches and then the
// point matches, a block sum (warp butterflies, then the warps' partials
// in warp order) of the 21 + 6 + 1 normal-equation terms and of the
// costs; every thread repeats the 6x6 solve (lm_common.cuh).  The shared
// matches are read from global memory (L1 and L2) on every pass.
//
// Bound: operations.  Per (row, iteration, masked match) one Jet<6>
// residual (7 lanes of each operation) with its products and sums, and
// one float residual for the new cost.  See testing/lm_checks.py for the
// counts.  The 50 serial iterations of a block, each with two block sums
// and a 6x6 solve, set the time: the LO's chains mask few matches.

#include "lm_common.cuh"

namespace {

using lm::Jet;
using lm::V2;
using lm::V3;
using lm::V4;

// COST_FUNCTIONS and COST_WEIGHTS of optimize/hybrid_localization.py
enum Cost { MIDPOINT2 = 0, MIDPOINT_ANGLE3, PERP2, PERP4, LINE_LINE3D,
            PLANE_LINE3D };
enum Weight { W_NONE = 0, W_COSINE, W_LINE3DPP, W_LENGTH, W_INVLENGTH };

template <typename T>
struct Pose {
  V4<T> q;   // as the row holds it
  V3<T> t;
  V4<T> qc;  // normalized conjugate: camera-to-world rotation
  V3<T> C;   // camera centre
};

struct JointLoc {
  const float *l3s, *l3e, *l2s, *l2e, *p3, *p2;  // [N_l, 3 | 2], [N_p, ...]
  const uint8_t *lmask, *pmask;                  // this row's
  int nl, np;
  float fx, fy, cx, cy;
  int cf, wt, loss;
  float alpha, scale, scale2, wline, wpoint;

  LM_FN bool needs_centre() const {
    return cf == LINE_LINE3D || cf == PLANE_LINE3D;
  }

  template <typename T>
  LM_FN Pose<T> pose(const T* p) const {
    Pose<T> P;
    P.q = {{p[0], p[1], p[2], p[3]}};
    P.t = {{p[4], p[5], p[6]}};
    if (needs_centre()) {
      P.qc = lm::quat_normalize(lm::quat_conjugate(P.q));
      const V3<T> mt = {{-P.t.v[0], -P.t.v[1], -P.t.v[2]}};
      P.C = lm::quat_rotate(P.qc, mt);
    }
    return P;
  }

  // CameraViewsBatch.project
  template <typename T>
  LM_FN V2<T> project(const Pose<T>& P, const float* X) const {
    const V3<float> x = {{X[0], X[1], X[2]}};
    const V3<T> r = lm::quat_rotate(P.q, x);
    const T pc0 = r.v[0] + P.t.v[0], pc1 = r.v[1] + P.t.v[1],
            pc2 = r.v[2] + P.t.v[2];
    const T u = pc0 / (pc2 + lm::EPS);
    const T v = pc1 / (pc2 + lm::EPS);
    return {fx * u + cx, fy * v + cy};
  }

  // CameraViewsBatch.ray_direction
  template <typename T>
  LM_FN V3<T> ray(const Pose<T>& P, const float* p) const {
    const V3<float> dc = {{(p[0] - cx) / fx, (p[1] - cy) / fy, 1.f}};
    return lm::normalize3(lm::quat_rotate(P.qc, dc));
  }

  // 3d_line_line_dist2 of one observed endpoint
  template <typename T>
  LM_FN T ray_line_dist(const Pose<T>& P, const float* p,
                        const V3<float>& d3, const V3<T>& dA) const {
    const V3<T> ry = ray(P, p);
    const V3<T> n = lm::cross(ry, d3);
    const T nn = lm::dot3(n, n);
    if (lm::val(nn) <= 1e-8f) {
      const V3<T> cr = lm::cross(ry, dA);
      return lm::sqrt_(lm::dot3(cr, cr) / (lm::dot3(ry, ry) + 1e-8f)
                       + 1e-8f);
    }
    return lm::abs_(lm::dot3(n, dA)) / lm::sqrt_(lm::clamp_min_(nn, 1e-8f));
  }

  // the line block before weighting: returns R_l
  template <typename T>
  LM_FN int line_block(const Pose<T>& P, int i, T (&r)[4]) const {
    const float* A = l3s + 3 * i;
    const float* B = l3e + 3 * i;
    const float* a2 = l2s + 2 * i;
    const float* b2 = l2e + 2 * i;
    const V2<T> ps = project(P, A), pe = project(P, B);
    const T dxy[2] = {pe.x - ps.x, pe.y - ps.y};
    const T dn = lm::norm_(dxy, 2) + lm::EPS;
    const T pdx = dxy[0] / dn, pdy = dxy[1] / dn;
    int R = 2;
    if (cf == MIDPOINT2 || cf == MIDPOINT_ANGLE3) {
      r[0] = 0.5f * (ps.x + pe.x) - 0.5f * (a2[0] + b2[0]);
      r[1] = 0.5f * (ps.y + pe.y) - 0.5f * (a2[1] + b2[1]);
      if (cf == MIDPOINT_ANGLE3) {
        const float e[2] = {b2[0] - a2[0], b2[1] - a2[1]};
        const float en = lm::norm_(e, 2) + lm::EPS;
        const float d2x = e[0] / en, d2y = e[1] / en;
        const T sine = lm::abs_(pdx * d2y - pdy * d2x);
        r[2] = lm::norm_(dxy, 2) * sine;
        R = 3;
      }
    } else if (cf == PERP2 || cf == PERP4) {
      const T mx = 0.5f * (ps.x + pe.x), my = 0.5f * (ps.y + pe.y);
      T q[4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* p = k ? b2 : a2;
        const T ex = p[0] - mx, ey = p[1] - my;
        const T en = lm::sqrt_(ex * ex + ey * ey + 1e-8f);
        const T sine = lm::abs_(pdx * ey - pdy * ex) / en;
        q[2 * k] = ex * sine;
        q[2 * k + 1] = ey * sine;
      }
      if (cf == PERP4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = q[k];
        R = 4;
      } else {
        r[0] = lm::sqrt_(q[0] * q[0] + q[1] * q[1] + 1e-8f);
        r[1] = lm::sqrt_(q[2] * q[2] + q[3] * q[3] + 1e-8f);
      }
    } else if (cf == LINE_LINE3D) {
      const V3<float> e = {{B[0] - A[0], B[1] - A[1], B[2] - A[2]}};
      const V3<float> d3 = lm::normalize3(e);
      const V3<T> dA = {{A[0] - P.C.v[0], A[1] - P.C.v[1], A[2] - P.C.v[2]}};
      r[0] = ray_line_dist(P, a2, d3, dA);
      r[1] = ray_line_dist(P, b2, d3, dA);
    } else {  // PLANE_LINE3D
      const V3<T> n = lm::normalize3(lm::cross(ray(P, a2), ray(P, b2)));
      const V3<T> dA = {{A[0] - P.C.v[0], A[1] - P.C.v[1], A[2] - P.C.v[2]}};
      const V3<T> dB = {{B[0] - P.C.v[0], B[1] - P.C.v[1], B[2] - P.C.v[2]}};
      r[0] = lm::abs_(lm::dot3(n, dA));
      r[1] = lm::abs_(lm::dot3(n, dB));
    }
    // _weight_2d: a function of the pose under cosine and line3dpp only
    if (wt == W_COSINE || wt == W_LINE3DPP) {
      const float ex = b2[0] - a2[0], ey = b2[1] - a2[1];
      const float en = sqrtf(ex * ex + ey * ey + 1e-8f);
      const T c = lm::clamp_max_(lm::abs_(pdx * ex + pdy * ey) / en, 1.f);
      const T w = wt == W_COSINE ? lm::exp_(alpha * (1.f - c))
                                 : lm::exp_(alpha * lm::acos_(c));
      for (int k = 0; k < R; ++k) r[k] = r[k] * w;
    } else if (wt != W_NONE) {
      const float ex = b2[0] - a2[0], ey = b2[1] - a2[1];
      const float en = sqrtf(ex * ex + ey * ey + 1e-8f);
      const float w = wt == W_LENGTH ? en : (1.f / en) * 1.f;
      for (int k = 0; k < R; ++k) r[k] = r[k] * w;
    }
    return R;
  }

  // a block times sqrt(weight rho'(|r|^2) + 1e-12)
  template <typename T>
  LM_FN void weigh(T (&r)[4], int R, float weight) const {
    float r2 = lm::val(r[0]) * lm::val(r[0]);
    for (int k = 1; k < R; ++k) r2 = r2 + lm::val(r[k]) * lm::val(r[k]);
    const float sc =
        sqrtf(weight * lm::robust_weight(r2, loss, scale, scale2) + 1e-12f);
    for (int k = 0; k < R; ++k) r[k] = r[k] * sc;
  }

  // match i's weighted block (lines first, then points): its size, 0
  // where the row masks the match
  template <typename T>
  LM_FN int block(const Pose<T>& P, int i, T (&r)[4]) const {
    if (i < nl) {
      if (!lmask[i]) return 0;
      const int R = line_block(P, i, r);
      weigh(r, R, wline);
      return R;
    }
    i -= nl;
    if (!pmask[i]) return 0;
    const V2<T> x = project(P, p3 + 3 * i);
    r[0] = x.x - p2[2 * i];
    r[1] = x.y - p2[2 * i + 1];
    weigh(r, 2, wpoint);
    return 2;
  }

  LM_FN void retract(const float (&p)[7], const float (&delta)[6],
                     float (&out)[7]) const {
    lm::retract_pose(p, delta, out);
  }

  template <class Team>
  LM_FN void normal_equations(Team& team, const float (&p)[7],
                              float (&acc)[lm::NE<6>::N]) const {
    Jet<6> delta[6], jp[7];
#pragma unroll
    for (int k = 0; k < 6; ++k) delta[k] = lm::jet_basis<6>(k);
    lm::retract_pose(p, delta, jp);
    const Pose<Jet<6>> P = pose(jp);
#pragma unroll
    for (int k = 0; k < lm::NE<6>::N; ++k) acc[k] = 0.f;
    for (int i = team.rank(); i < nl + np; i += team.size()) {
      Jet<6> r[4];
      const int R = block(P, i, r);
      for (int k = 0; k < R; ++k) lm::accumulate(acc, r[k]);
    }
    team.sum(acc);
  }

  template <class Team>
  LM_FN float cost(Team& team, const float (&p)[7]) const {
    const Pose<float> P = pose(p);
    float c = 0.f;
    for (int i = team.rank(); i < nl + np; i += team.size()) {
      float r[4];
      const int R = block(P, i, r);
      for (int k = 0; k < R; ++k) c += r[k] * r[k];
    }
    return team.sum1(c);
  }
};

}  // namespace

// The kernel and its launch; what precedes compiles as host C++ too.
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

struct Args {
  const float *params0, *l3s, *l3e, *l2s, *l2e, *p3, *p2;
  const uint8_t *lmask, *pmask;
  int T, nl, np, cf, wt, loss;
  float fx, fy, cx, cy, alpha, scale, scale2, wline, wpoint;
  lm::LMParams lp;
  float *params, *cost0, *cost;
  int* n_acc;
  float *trace, *ne;
};

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) lm_jointloc_kernel(Args a) {
  __shared__ float scratch[(THREADS / 32) * lm::NE<6>::N];
  const int row = blockIdx.x;
  const JointLoc pb{a.l3s, a.l3e, a.l2s, a.l2e, a.p3, a.p2,
                    a.lmask + (long long)row * a.nl,
                    a.pmask + (long long)row * a.np, a.nl, a.np,
                    a.fx, a.fy, a.cx, a.cy, a.cf, a.wt, a.loss,
                    a.alpha, a.scale, a.scale2, a.wline, a.wpoint};
  lm::BlockTeam<lm::NE<6>::N> team{scratch, (int)threadIdx.x,
                                    (int)blockDim.x};
  float params[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) params[i] = a.params0[7 * row + i];
  float cost0, cost;
  int n_acc;
  lm::lm_row<6, 7>(pb, team, a.lp, params, cost0, cost, n_acc,
                   a.trace ? a.trace + (long long)row * a.lp.n_iter * 16
                           : nullptr,
                   a.ne ? a.ne + (long long)row * 43 : nullptr);
  if (team.leader()) {
#pragma unroll
    for (int i = 0; i < 7; ++i) a.params[7 * row + i] = params[i];
    a.cost0[row] = cost0;
    a.cost[row] = cost;
    a.n_acc[row] = n_acc;
  }
}

}  // namespace

// hp: fx, fy, cx, cy, alpha, loss scale, loss scale^2, weight_line,
// weight_point, lambda init, up, down, min, max.  ip: cost function,
// weight, loss (the orders of COST_FUNCTIONS, COST_WEIGHTS and
// (trivial, cauchy, huber)).  trace [T, n_iter, 16] and ne [T, 43] may be
// null; with ne the kernel writes the normal equations at params0 and
// runs no iteration.
extern "C" int lm_jointloc_launch(const float* params0, const float* l3s,
                                  const float* l3e, const float* l2s,
                                  const float* l2e, const uint8_t* lmask,
                                  const float* p3, const float* p2,
                                  const uint8_t* pmask, long long T,
                                  long long nl, long long np,
                                  const float* hp, const long long* ip,
                                  long long n_iter, float* params,
                                  float* cost0, float* cost, int* n_acc,
                                  float* trace, float* ne, void* stream) {
  Args a;
  a.params0 = params0;
  a.l3s = l3s;
  a.l3e = l3e;
  a.l2s = l2s;
  a.l2e = l2e;
  a.p3 = p3;
  a.p2 = p2;
  a.lmask = lmask;
  a.pmask = pmask;
  a.T = (int)T;
  a.nl = (int)nl;
  a.np = (int)np;
  a.cf = (int)ip[0];
  a.wt = (int)ip[1];
  a.loss = (int)ip[2];
  a.fx = hp[0];
  a.fy = hp[1];
  a.cx = hp[2];
  a.cy = hp[3];
  a.alpha = hp[4];
  a.scale = hp[5];
  a.scale2 = hp[6];
  a.wline = hp[7];
  a.wpoint = hp[8];
  a.lp = {(int)n_iter, hp[9], hp[10], hp[11], hp[12], hp[13]};
  a.params = params;
  a.cost0 = cost0;
  a.cost = cost;
  a.n_acc = n_acc;
  a.trace = trace;
  a.ne = ne;
  lm_jointloc_kernel<<<(unsigned)T, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
