// Kernel H: the fixed-camera line bundle adjustment, every LM iteration of
// every track in one launch.
//
// Replaces the jitted LM program of limap_tpu/optimize/lm.py:64
// (_build_lm_runner) with the residual of limap_tpu/optimize/line_ba.py:82
// (_build_ba_residual), as solve_line_bundle_adjustment (:106) runs it.
// The plain version is limap_tpu_torch/optimize/lm.py::lm_solve with
// optimize/line_ba.py::ba_residual.
//
// Rows: T tracks, each a minimal line (uvec [4], wvec [2]) on a 4-D
// tangent.  Supports: S padded a track, each with its view's kvec [4],
// qvec [4], tvec [3], its 2D segment (start [2], end [2]), a weight and a
// validity flag.  The residual of a support is the cosine-weighted
// perpendicular distance of both endpoints to the line's projection
// (minimal_to_plucker -> line_world_to_pixel ->
// cosine_weighted_perpendicular_dist2d), times the square root of the
// support's weight and of the IRLS weight of its detached residual.
//
// Layout: one warp a track, the lanes over its supports (looping when
// S > 32), xor-butterfly sums of the 10 + 4 + 1 normal-equation terms and
// of the costs; every lane repeats the 4x4 solve (lm_common.cuh).  The
// supports are read from global memory (L1 and L2) on every pass.
//
// Bound: operations where the supports carry weight, else the bytes of
// the padded slots.  Per (track, iteration, weighted support) one Jet<4>
// residual (5 lanes of each operation), its 2 x 15 products and sums, and
// one float residual for the new cost; the inputs (68 bytes a support
// slot) are read once a launch.  See testing/lm_checks.py for the counts.
// One warp's 20 serial iterations, not the work, set the time.

#include "lm_common.cuh"

namespace {

using lm::Jet;
using lm::V3;
using lm::V4;

struct LineBA {
  const float *kv, *qv, *tv, *ps, *pe, *w;  // this track's [S, ...]
  const uint8_t* valid;
  int S;
  float alpha, scale, scale2;
  int loss;

  template <typename T>
  LM_FN void plucker(const T* p, V3<T>& d, V3<T>& m) const {
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

  // the weighted residual [2] of support s; false where it is zero
  template <typename T>
  LM_FN bool residual(const V3<T>& d, const V3<T>& m, int s,
                      T (&r)[2]) const {
    const float ws = w[s];
    if (!valid[s] || !(ws > 0.f)) return false;
    const float fx = kv[4 * s], fy = kv[4 * s + 1], cx = kv[4 * s + 2],
                cy = kv[4 * s + 3];
    const V4<float> q = {{qv[4 * s], qv[4 * s + 1], qv[4 * s + 2],
                          qv[4 * s + 3]}};
    const V3<float> t = {{tv[3 * s], tv[3 * s + 1], tv[3 * s + 2]}};
    // line_world_to_pixel: m_cam = R m + t x R d, then det(K) K^-T m_cam
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
    // cosine_weighted_perpendicular_dist2d
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
    V3<Jet<4>> d, m;
    plucker(np, d, m);
#pragma unroll
    for (int k = 0; k < lm::NE<4>::N; ++k) acc[k] = 0.f;
    for (int s = team.rank(); s < S; s += team.size()) {
      Jet<4> r[2];
      if (residual(d, m, s, r)) {
        lm::accumulate(acc, r[0]);
        lm::accumulate(acc, r[1]);
      }
    }
    team.sum(acc);
  }

  template <class Team>
  LM_FN float cost(Team& team, const float (&p)[6]) const {
    V3<float> d, m;
    plucker(p, d, m);
    float c = 0.f;
    for (int s = team.rank(); s < S; s += team.size()) {
      float r[2];
      if (residual(d, m, s, r)) c += r[0] * r[0] + r[1] * r[1];
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
  const float *params0, *kv, *qv, *tv, *ps, *pe, *w;
  const uint8_t* valid;
  int T, S, loss;
  float alpha, scale, scale2;
  lm::LMParams lp;
  float *params, *cost0, *cost;
  int* n_acc;
  float *trace, *ne;
};

constexpr int WARPS = 4;

__global__ void __launch_bounds__(32 * WARPS) lm_line_ba_kernel(Args a) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.T) return;  // a whole warp
  const long long o = (long long)row * a.S;
  const LineBA pb{a.kv + 4 * o, a.qv + 4 * o, a.tv + 3 * o,
                  a.ps + 2 * o, a.pe + 2 * o, a.w + o,
                  a.valid + o, a.S, a.alpha, a.scale, a.scale2, a.loss};
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  float params[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) params[i] = a.params0[6 * row + i];
  float cost0, cost;
  int n_acc;
  lm::lm_row<4, 6>(pb, team, a.lp, params, cost0, cost, n_acc,
                   a.trace ? a.trace + (long long)row * a.lp.n_iter * 14
                           : nullptr,
                   a.ne ? a.ne + (long long)row * 21 : nullptr);
  if (team.leader()) {
#pragma unroll
    for (int i = 0; i < 6; ++i) a.params[6 * row + i] = params[i];
    a.cost0[row] = cost0;
    a.cost[row] = cost;
    a.n_acc[row] = n_acc;
  }
}

}  // namespace

// hp: alpha, loss scale, loss scale^2, lambda init, up, down, min, max.
// trace [T, n_iter, 14] and ne [T, 21] may be null; with ne the kernel
// writes the normal equations at params0 and runs no iteration.
extern "C" int lm_line_ba_launch(const float* params0, const float* kv,
                                 const float* qv, const float* tv,
                                 const float* ps, const float* pe,
                                 const float* w, const uint8_t* valid,
                                 long long T, long long S, const float* hp,
                                 long long loss, long long n_iter,
                                 float* params, float* cost0, float* cost,
                                 int* n_acc, float* trace, float* ne,
                                 void* stream) {
  Args a;
  a.params0 = params0;
  a.kv = kv;
  a.qv = qv;
  a.tv = tv;
  a.ps = ps;
  a.pe = pe;
  a.w = w;
  a.valid = valid;
  a.T = (int)T;
  a.S = (int)S;
  a.loss = (int)loss;
  a.alpha = hp[0];
  a.scale = hp[1];
  a.scale2 = hp[2];
  a.lp = {(int)n_iter, hp[3], hp[4], hp[5], hp[6], hp[7]};
  a.params = params;
  a.cost0 = cost0;
  a.cost = cost;
  a.n_acc = n_acc;
  a.trace = trace;
  a.ne = ne;
  const int blocks = (int)((T + WARPS - 1) / WARPS);
  lm_line_ba_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
