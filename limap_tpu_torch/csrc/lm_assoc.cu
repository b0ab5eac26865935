// Kernels L and M: the line step and the point step of the joint
// point-line-VP association, every LM iteration of every row in one launch.
//
// Replace the jitted LM programs of limap_tpu/optimize/lm.py:64
// (_build_lm_runner) that GlobalAssociator.solve runs in each round of its
// block-coordinate descent: the line step over line_residual
// (limap_tpu/optimize/global_pl_association.py:198-226, solved at :249)
// and the point step over point_residual (:228-247, solved at :260 with
// an additive retraction).  The plain versions are
// limap_tpu_torch/optimize/lm.py::lm_solve with
// ops/lm_assoc.py::line_residual / point_residual.
//
// L, one warp a track (a minimal line, tangent 4): the lanes over its S
// supports (the line BA's robust geometric term), then over its 2A
// association slots: the distance of an associated point, gathered by
// index from the current points [P, 3], times sqrt(lw_pl w), and the sine
// between the line and an associated VP gathered from [V, 3], times
// sqrt(lw_vpl w).  Nothing is broadcast to [T, P, 3]: a slot reads one
// row.
//
// M, one warp a point (tangent 3, additive): the lanes over its S
// observations, each view gathered by image index from the full views
// [N, ...], the reprojection error times sqrt(lw_point), then over its A
// slots: the distance to an associated line, its minimal parameters
// gathered from the current lines [T, 6] and unpacked to Plücker here.
//
// Both sum the normal-equation terms by xor butterflies and repeat the
// small solve in every lane (lm_common.cuh).  Bound: operations (Jet lanes
// counted), see testing/lm_checks.py::ops_assoc_lines / ops_assoc_points;
// as for H, the serial iterations of a warp set the time.

#include "lm_common.cuh"

namespace {

using lm::Jet;
using lm::V3;
using lm::V4;

// minimal_to_plucker
template <typename T>
LM_FN void plucker(const T* p, V3<T>& d, V3<T>& m) {
  const V4<T> u = {{p[0], p[1], p[2], p[3]}};
  V3<T> c0, c1;
  lm::quat_to_rotmat_cols01(u, c0, c1);
  const T w1 = lm::abs_(p[4]);
  const T w2 = lm::abs_(p[5]);
  const T ratio = w2 / (w1 + lm::EPS);
  d = c0;
#pragma unroll
  for (int i = 0; i < 3; ++i) m.v[i] = c1.v[i] * ratio;
}

// InfiniteLines3d.point_distance: |q - (q + d x (m + d x q))|
template <typename A, typename B>
LM_FN auto point_line_distance(const V3<A>& d, const V3<A>& m,
                               const V3<B>& q) {
  const auto dq = lm::cross(d, q);
  V3<decltype(m.v[0] + dq.v[0])> mq;
#pragma unroll
  for (int i = 0; i < 3; ++i) mq.v[i] = m.v[i] + dq.v[i];
  const auto c = lm::cross(d, mq);
  V3<decltype(q.v[0] - (q.v[0] + c.v[0]))> diff;
#pragma unroll
  for (int i = 0; i < 3; ++i) diff.v[i] = q.v[i] - (q.v[i] + c.v[i]);
  return lm::norm_(diff.v, 3);
}

struct AssocLines {
  const float *kv, *qv, *tv, *ps, *pe, *w;  // this track's [S, ...]
  const int *pt_idx, *vp_idx;               // [A]
  const float *pt_w, *vp_w;
  const float *points, *vps;                // [P, 3], [V, 3]
  int S, A, use_vps, loss;
  float alpha, scale, scale2, lw_pl, lw_vpl;

  template <typename T>
  LM_FN bool geometric(const V3<T>& d, const V3<T>& m, int s,
                       T (&r)[2]) const {
    const float ws = w[s];
    if (!(ws > 0.f)) return false;
    const float fx = kv[4 * s], fy = kv[4 * s + 1], cx = kv[4 * s + 2],
                cy = kv[4 * s + 3];
    const V4<float> q = {{qv[4 * s], qv[4 * s + 1], qv[4 * s + 2],
                          qv[4 * s + 3]}};
    const V3<float> t = {{tv[3 * s], tv[3 * s + 1], tv[3 * s + 2]}};
    const V3<T> Rm = lm::quat_rotate(q, m);
    const V3<T> Rd = lm::quat_rotate(q, d);
    const V3<T> tRd = lm::cross(t, Rd);
    V3<T> mc;
#pragma unroll
    for (int i = 0; i < 3; ++i) mc.v[i] = Rm.v[i] + tRd.v[i];
    V3<T> coor = {{fy * mc.v[0], fx * mc.v[1],
                   (fx * fy) * mc.v[2] - (cx * fy) * mc.v[0]
                       - (cy * fx) * mc.v[1]}};
    coor = lm::normalize3(coor);
    const T dn = lm::sqrt_(coor.v[0] * coor.v[0] + coor.v[1] * coor.v[1]
                           + lm::EPS);
    const float p1x = ps[2 * s], p1y = ps[2 * s + 1];
    const float p2x = pe[2 * s], p2y = pe[2 * s + 1];
    const T d1 = (p1x * coor.v[0] + p1y * coor.v[1] + coor.v[2]) / dn;
    const T d2 = (p2x * coor.v[0] + p2y * coor.v[1] + coor.v[2]) / dn;
    const T dir0 = (-coor.v[1]) / dn;
    const T dir1 = coor.v[0] / dn;
    const float sx = p2x - p1x, sy = p2y - p1y;
    const float sn = sqrtf(sx * sx + sy * sy + lm::EPS);
    const T cosine = lm::clamp_max_(lm::abs_(dir0 * sx + dir1 * sy) / sn,
                                    1.f);
    const T weight = lm::exp_(alpha * (1.f - cosine));
    r[0] = d1 * weight;
    r[1] = d2 * weight;
    const float r2 = lm::val(r[0]) * lm::val(r[0])
                     + lm::val(r[1]) * lm::val(r[1]);
    const float sc =
        sqrtf(ws * lm::robust_weight(r2, loss, scale, scale2) + 1e-12f);
    r[0] = r[0] * sc;
    r[1] = r[1] * sc;
    return true;
  }

  // association slot k < A: a point; A <= k < 2A: a VP
  template <typename T>
  LM_FN bool slot(const V3<T>& d, const V3<T>& m, int k, T& r) const {
    if (k < A) {
      const float wk = pt_w[k];
      if (!(wk > 0.f)) return false;
      const float* p = points + 3 * (long long)pt_idx[k];
      const V3<float> q = {{p[0], p[1], p[2]}};
      r = point_line_distance(d, m, q) * sqrtf(lw_pl * wk);
      return true;
    }
    k -= A;
    const float wk = vp_w[k];
    if (!use_vps || !(wk > 0.f)) return false;
    const float* p = vps + 3 * (long long)vp_idx[k];
    const V3<float> v = {{p[0], p[1], p[2]}};
    const T sine = lm::norm_(lm::cross(d, v).v, 3)
                   / (lm::norm_(v.v, 3) + 1e-12f);
    r = sine * sqrtf(lw_vpl * wk);
    return true;
  }

  template <typename T, class Team, class Add>
  LM_FN void residuals(Team& team, const T (&np)[6], Add add) const {
    V3<T> d, m;
    plucker(np, d, m);
    for (int s = team.rank(); s < S; s += team.size()) {
      T r[2];
      if (geometric(d, m, s, r)) {
        add(r[0]);
        add(r[1]);
      }
    }
    for (int k = team.rank(); k < 2 * A; k += team.size()) {
      T r;
      if (slot(d, m, k, r)) add(r);
    }
  }

  LM_FN void retract(const float (&p)[6], const float (&delta)[4],
                     float (&out)[6]) const {
    lm::retract_quat_so2(p, delta, out);
  }

  template <class Team>
  LM_FN void normal_equations(Team& team, const float (&p)[6],
                              float (&acc)[lm::NE<4>::N]) const {
    Jet<4> delta[4], np[6];
#pragma unroll
    for (int k = 0; k < 4; ++k) delta[k] = lm::jet_basis<4>(k);
    lm::retract_quat_so2(p, delta, np);
#pragma unroll
    for (int k = 0; k < lm::NE<4>::N; ++k) acc[k] = 0.f;
    residuals(team, np, [&](const Jet<4>& r) { lm::accumulate(acc, r); });
    team.sum(acc);
  }

  template <class Team>
  LM_FN float cost(Team& team, const float (&p)[6]) const {
    float c = 0.f;
    residuals(team, p, [&](float r) { c += r * r; });
    return team.sum1(c);
  }
};

struct AssocPoints {
  const float *views_k, *views_q, *views_t;  // [N, ...]
  const int* img;                            // this point's [S]
  const float* p2d;
  const uint8_t* mask;
  const int* ln_idx;                         // [A]
  const float* ln_w;
  const float* lines;                        // [T, 6]
  int S, A;
  float sqrt_lw, lw_pl;

  template <typename T>
  LM_FN bool reprojection(const V3<T>& X, int s, T (&r)[2]) const {
    if (!mask[s]) return false;
    const long long i = img[s];
    const float* k = views_k + 4 * i;
    const V4<float> q = {{views_q[4 * i], views_q[4 * i + 1],
                          views_q[4 * i + 2], views_q[4 * i + 3]}};
    const V3<T> R = lm::quat_rotate(q, X);
    V3<T> pc;
#pragma unroll
    for (int j = 0; j < 3; ++j) pc.v[j] = R.v[j] + views_t[3 * i + j];
    const T z = pc.v[2] + lm::EPS;
    const T u = pc.v[0] / z;
    const T v = pc.v[1] / z;
    r[0] = (k[0] * u + k[2] - p2d[2 * s]) * sqrt_lw;
    r[1] = (k[1] * v + k[3] - p2d[2 * s + 1]) * sqrt_lw;
    return true;
  }

  template <typename T>
  LM_FN bool slot(const V3<T>& X, int k, T& r) const {
    const float wk = ln_w[k];
    if (!(wk > 0.f)) return false;
    const float* l = lines + 6 * (long long)ln_idx[k];
    V3<float> d, m;
    plucker(l, d, m);
    r = point_line_distance(d, m, X) * sqrtf(lw_pl * wk);
    return true;
  }

  template <typename T, class Team, class Add>
  LM_FN void residuals(Team& team, const T (&np)[3], Add add) const {
    const V3<T> X = {{np[0], np[1], np[2]}};
    for (int s = team.rank(); s < S; s += team.size()) {
      T r[2];
      if (reprojection(X, s, r)) {
        add(r[0]);
        add(r[1]);
      }
    }
    for (int k = team.rank(); k < A; k += team.size()) {
      T r;
      if (slot(X, k, r)) add(r);
    }
  }

  LM_FN void retract(const float (&p)[3], const float (&delta)[3],
                     float (&out)[3]) const {
    lm::retract_add3(p, delta, out);
  }

  template <class Team>
  LM_FN void normal_equations(Team& team, const float (&p)[3],
                              float (&acc)[lm::NE<3>::N]) const {
    Jet<3> delta[3], np[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) delta[k] = lm::jet_basis<3>(k);
    lm::retract_add3(p, delta, np);
#pragma unroll
    for (int k = 0; k < lm::NE<3>::N; ++k) acc[k] = 0.f;
    residuals(team, np, [&](const Jet<3>& r) { lm::accumulate(acc, r); });
    team.sum(acc);
  }

  template <class Team>
  LM_FN float cost(Team& team, const float (&p)[3]) const {
    float c = 0.f;
    residuals(team, p, [&](float r) { c += r * r; });
    return team.sum1(c);
  }
};

}  // namespace

// The kernels and their launches; what precedes compiles as host C++ too.
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

struct Out {
  float *params, *cost0, *cost;
  int* n_acc;
  float *trace, *ne;
};

constexpr int WARPS = 4;

template <int D, int P, class Problem>
__device__ void run_row(const Problem& pb, const lm::LMParams& lp,
                        const float* params0, int row, const Out& o) {
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  float params[P];
#pragma unroll
  for (int i = 0; i < P; ++i) params[i] = params0[P * row + i];
  float cost0, cost;
  int n_acc;
  lm::lm_row<D, P>(pb, team, lp, params, cost0, cost, n_acc,
                   o.trace ? o.trace + (long long)row * lp.n_iter * (2 + 2 * P)
                           : nullptr,
                   o.ne ? o.ne + (long long)row * (D * D + D + 1) : nullptr);
  if (team.leader()) {
#pragma unroll
    for (int i = 0; i < P; ++i) o.params[P * row + i] = params[i];
    o.cost0[row] = cost0;
    o.cost[row] = cost;
    o.n_acc[row] = n_acc;
  }
}

struct LineArgs {
  const float *params0, *kv, *qv, *tv, *ps, *pe, *w;
  const int* pt_idx;
  const float* pt_w;
  const int* vp_idx;
  const float *vp_w, *points, *vps;
  int T, S, A, use_vps, loss;
  float alpha, scale, scale2, lw_pl, lw_vpl;
  lm::LMParams lp;
  Out o;
};

__global__ void __launch_bounds__(32 * WARPS) lm_assoc_lines_kernel(
    LineArgs a) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.T) return;  // a whole warp
  const long long s = (long long)row * a.S, k = (long long)row * a.A;
  const AssocLines pb{a.kv + 4 * s, a.qv + 4 * s, a.tv + 3 * s,
                      a.ps + 2 * s, a.pe + 2 * s, a.w + s,
                      a.pt_idx + k, a.vp_idx + k, a.pt_w + k, a.vp_w + k,
                      a.points, a.vps, a.S, a.A, a.use_vps, a.loss,
                      a.alpha, a.scale, a.scale2, a.lw_pl, a.lw_vpl};
  run_row<4, 6>(pb, a.lp, a.params0, row, a.o);
}

struct PointArgs {
  const float *params0, *views_k, *views_q, *views_t;
  const int* img;
  const float* p2d;
  const uint8_t* mask;
  const int* ln_idx;
  const float *ln_w, *lines;
  int P, S, A;
  float sqrt_lw, lw_pl;
  lm::LMParams lp;
  Out o;
};

__global__ void __launch_bounds__(32 * WARPS) lm_assoc_points_kernel(
    PointArgs a) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.P) return;  // a whole warp
  const long long s = (long long)row * a.S, k = (long long)row * a.A;
  const AssocPoints pb{a.views_k, a.views_q, a.views_t, a.img + s,
                       a.p2d + 2 * s, a.mask + s, a.ln_idx + k,
                       a.ln_w + k, a.lines, a.S, a.A, a.sqrt_lw, a.lw_pl};
  run_row<3, 3>(pb, a.lp, a.params0, row, a.o);
}

}  // namespace

// hp: alpha, loss scale, its square, lambda init, up, down, min, max,
// lw_pointline, lw_vpline.  trace [T, n_iter, 14] and ne [T, 21] may be
// null; with ne the kernel writes the normal equations at params0 and runs
// no iteration.
extern "C" int lm_assoc_lines_launch(
    const float* params0, const float* kv, const float* qv, const float* tv,
    const float* ps, const float* pe, const float* w, const int* pt_idx,
    const float* pt_w, const int* vp_idx, const float* vp_w,
    const float* points, const float* vps, long long T, long long S,
    long long A, long long P, long long V, const float* hp, long long loss,
    long long use_vps, long long n_iter, float* params, float* cost0,
    float* cost, int* n_acc, float* trace, float* ne, void* stream) {
  (void)P;
  (void)V;
  LineArgs a{params0, kv, qv, tv, ps, pe, w, pt_idx, pt_w, vp_idx, vp_w,
             points, vps};
  a.T = (int)T;
  a.S = (int)S;
  a.A = (int)A;
  a.use_vps = (int)use_vps;
  a.loss = (int)loss;
  a.alpha = hp[0];
  a.scale = hp[1];
  a.scale2 = hp[2];
  a.lp = {(int)n_iter, hp[3], hp[4], hp[5], hp[6], hp[7]};
  a.lw_pl = hp[8];
  a.lw_vpl = hp[9];
  a.o = {params, cost0, cost, n_acc, trace, ne};
  const int blocks = (int)((T + WARPS - 1) / WARPS);
  lm_assoc_lines_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// hp: sqrt(lw_point), lw_pointline, lambda init, up, down, min, max.
// trace [P, n_iter, 8] and ne [P, 13] may be null.
extern "C" int lm_assoc_points_launch(
    const float* params0, const float* views_k, const float* views_q,
    const float* views_t, const int* img, const float* p2d,
    const uint8_t* mask, const int* ln_idx, const float* ln_w,
    const float* lines, long long P, long long S, long long A, long long N,
    long long T, const float* hp, long long n_iter, float* params,
    float* cost0, float* cost, int* n_acc, float* trace, float* ne,
    void* stream) {
  (void)N;
  (void)T;
  PointArgs a{params0, views_k, views_q, views_t, img, p2d, mask, ln_idx,
              ln_w, lines};
  a.P = (int)P;
  a.S = (int)S;
  a.A = (int)A;
  a.sqrt_lw = hp[0];
  a.lw_pl = hp[1];
  a.lp = {(int)n_iter, hp[2], hp[3], hp[4], hp[5], hp[6]};
  a.o = {params, cost0, cost, n_acc, trace, ne};
  const int blocks = (int)((P + WARPS - 1) / WARPS);
  lm_assoc_points_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
