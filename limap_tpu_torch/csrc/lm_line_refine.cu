// Kernel K: the line refinement, every LM iteration of every track in one
// launch.
//
// Replaces the jitted LM program of limap_tpu/optimize/lm.py:64
// (_build_lm_runner) with the residual of
// limap_tpu/optimize/line_refinement.py:358-404 (residual_one, with
// _heatmap_residual :89 and _fconsis_residual :251), as
// solve_line_refinement (:406) runs it.  The plain version is
// limap_tpu_torch/optimize/lm.py::lm_solve with
// ops/lm_line_refine.py::refine_residual.
//
// Rows: T tracks, each a minimal line (uvec [4], wvec [2]) on a 4-D
// tangent.  A track's residuals, in the plain version's order:
//   1. geometric (flag 1): per support the line BA's two weighted
//      endpoint distances, the IRLS weight from the detached residual;
//   2. VP: per support with vp_w > 0 the sine between the line direction
//      in the support's camera and its VP's direction, times sqrt(vp_w);
//   3. heatmap (flag 2): per support with w > 0 and per anchor a of its
//      patch [A, Pa], 1 - the patch at the anchor's perpendicular foot on
//      the projected line (0 outside the patch), times sqrt(multiplier);
//   4. feature consistency (flag 4): per term with w > 0 the line's
//      intersection with the reference view's sample line, the epipolar
//      line of that point in the target view, its intersection with the
//      target projection, and C channels of both patches [Pp, Pp, C]
//      sampled there, target minus reference (0 where either point is
//      outside its patch), times sqrt(w * multiplier).
// Terms whose weight is 0 add nothing and are skipped.
//
// Layout: one warp a track, the lanes over its supports (the geometric,
// VP and heatmap terms, a lane's anchors in a loop) and then over its
// feature terms; xor-butterfly sums of the 10 + 4 + 1 normal-equation
// terms and of the costs; every lane repeats the 4x4 solve
// (lm_common.cuh).  The patches stay in device memory: an evaluation
// reads the 4 texels of a sample, a channel at a time, through L1 and L2.
//
// Bound: operations.  Per (track, iteration) and per weighted item a Jet
// evaluation (5 lanes of each operation) and a float one for the new
// cost; see testing/lm_checks.py::ops_line_refine for the counts.  As for
// H, a warp's serial iterations, not the work, set the time.

#include "lm_common.cuh"

namespace {

using lm::Jet;
using lm::V3;
using lm::V4;

enum { GEOMETRIC = 1, HEATMAP = 2, FCONSIS = 4 };

struct View {
  float k[4], q[4], t[3];
};

LM_FN View load_view(const float* kv, const float* qv, const float* tv,
                     long long i) {
  View v;
#pragma unroll
  for (int j = 0; j < 4; ++j) v.k[j] = kv[4 * i + j];
#pragma unroll
  for (int j = 0; j < 4; ++j) v.q[j] = qv[4 * i + j];
#pragma unroll
  for (int j = 0; j < 3; ++j) v.t[j] = tv[3 * i + j];
  return v;
}

// 0 without tangent
LM_FN float zero(float) { return 0.f; }
template <int D>
LM_FN Jet<D> zero(const Jet<D>&) {
  Jet<D> r;
  r.v = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) r.d[i] = 0.f;
  return r;
}

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

// line_world_to_pixel: m_cam = R m + t x R d, then det(K) K^-T m_cam,
// normalized
template <typename T>
LM_FN V3<T> project_line(const View& v, const V3<T>& d, const V3<T>& m) {
  const V4<float> q = {{v.q[0], v.q[1], v.q[2], v.q[3]}};
  const V3<float> t = {{v.t[0], v.t[1], v.t[2]}};
  const V3<T> Rm = lm::quat_rotate(q, m);
  const V3<T> Rd = lm::quat_rotate(q, d);
  const V3<T> tRd = lm::cross(t, Rd);
  V3<T> mc;
#pragma unroll
  for (int i = 0; i < 3; ++i) mc.v[i] = Rm.v[i] + tRd.v[i];
  const float fx = v.k[0], fy = v.k[1], cx = v.k[2], cy = v.k[3];
  const V3<T> coor = {{fy * mc.v[0], fx * mc.v[1],
                       (fx * fy) * mc.v[2] - (cx * fy) * mc.v[0]
                           - (cy * fx) * mc.v[1]}};
  return lm::normalize3(coor);
}

// epipolar_line: K2^-T [t_rel]x R2 R1^T K1^-1 (x, y, 1)
template <typename T>
LM_FN V3<T> epipolar_line(const View& v1, const View& v2, const T& x,
                          const T& y) {
  const T u = (x - v1.k[2]) / v1.k[0];
  const T w = (y - v1.k[3]) / v1.k[1];
  const V4<float> q1 = {{v1.q[0], v1.q[1], v1.q[2], v1.q[3]}};
  const V4<float> q1c = lm::quat_normalize(lm::quat_conjugate(q1));
  const V4<float> q2 = {{v2.q[0], v2.q[1], v2.q[2], v2.q[3]}};
  const V3<T> x1 = {{u, w, zero(u) + 1.f}};
  const V3<T> rx = lm::quat_rotate(q2, lm::quat_rotate(q1c, x1));
  const V3<float> t1 = {{v1.t[0], v1.t[1], v1.t[2]}};
  const V3<float> rt = lm::quat_rotate(q2, lm::quat_rotate(q1c, t1));
  const V3<float> dt = {{v2.t[0] - rt.v[0], v2.t[1] - rt.v[1],
                         v2.t[2] - rt.v[2]}};
  const V3<T> ex = lm::cross(dt, rx);
  const float fx2 = v2.k[0], fy2 = v2.k[1], cx2 = v2.k[2], cy2 = v2.k[3];
  return {{ex.v[0] / fx2, ex.v[1] / fy2,
           ex.v[2] - (cx2 / fx2) * ex.v[0] - (cy2 / fy2) * ex.v[1]}};
}

// the inhomogeneous point of a homogeneous one, h[:2] / (h[2] + 1e-12)
template <typename T>
LM_FN void dehomogenize(const V3<T>& h, T& x, T& y) {
  const T z = h.v[2] + 1e-12f;
  x = h.v[0] / z;
  y = h.v[1] / z;
}

struct Refine {
  // this track's supports [S, ...] and feature terms [F, ...]
  const float *kv, *qv, *tv, *ps, *pe, *w, *vps, *vw;
  const float *hm, *hm_o, *hm_u, *hm_v, *hm_len;
  const float *views_k, *views_q, *views_t;  // every view [N, ...]
  const int *fr, *ft;
  const float *fco, *frp, *ftp, *fro, *fto, *fw;
  int S, A, Pa, F, Pp, C, flags, loss;
  float alpha, scale, scale2, hm_mult, fc_mult;

  // the geometric term of support s: (false where its weight is 0)
  template <typename T>
  LM_FN bool geometric(const V3<T>& coor, int s, T (&r)[2]) const {
    const float ws = w[s];
    if (!(ws > 0.f)) return false;
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

  // the VP term of support s, seen from view v
  template <typename T>
  LM_FN bool vp(const View& v, const V3<T>& d, int s, T& r) const {
    const float vws = vw[s];
    if (!(vws > 0.f)) return false;
    const V4<float> q = {{v.q[0], v.q[1], v.q[2], v.q[3]}};
    const V3<T> d_rot = lm::normalize3(lm::quat_rotate(q, d));
    const float* p = vps + 3 * s;
    const float fx = v.k[0], fy = v.k[1], cx = v.k[2], cy = v.k[3];
    const V3<float> dv = {{p[0] / fx - cx / fx * p[2],
                           p[1] / fy - cy / fy * p[2], p[2]}};
    const V3<float> direc = lm::normalize3(dv);
    const V3<T> cr = lm::cross(d_rot, direc);
    r = lm::norm_(cr.v, 3) * sqrtf(vws + 1e-12f);
    return true;
  }

  // the heatmap term of support s at anchor a (false outside the patch,
  // where it is 0)
  template <typename T>
  LM_FN bool heatmap(const V3<T>& coor, int s, int a, float sq, T& r) const {
    const float ox = hm_o[2 * s], oy = hm_o[2 * s + 1];
    const float ux = hm_u[2 * s], uy = hm_u[2 * s + 1];
    const float vx = hm_v[2 * s], vy = hm_v[2 * s + 1];
    const float len = hm_len[s];
    const float t = (float)a / (float)(A - 1);
    const float qx = ox + t * ux * len, qy = oy + t * uy * len;
    // infline2d_point_projection
    const T& la = coor.v[0];
    const T& lb = coor.v[1];
    const T k = (la * qx + lb * qy + coor.v[2]) / (la * la + lb * lb
                                                    + lm::EPS);
    const T rx = (qx - la * k) - ox;
    const T ry = (qy - lb * k) - oy;
    const T pa = (rx * ux + ry * uy) / fmaxf(len, 1e-8f) * (float)(A - 1);
    const T pb = (rx * vx + ry * vy) / 1.f + (float)(Pa - 1) / 2.f;
    const float va = lm::val(pa), vb = lm::val(pb);
    if (!(va >= 0.f && va <= (float)(A - 1) && vb >= 0.f
          && vb <= (float)(Pa - 1)))
      return false;
    const lm::Bilinear<T> bl(A, Pa, 1, pb, pa);
    r = (1.f - bl(hm + (long long)s * A * Pa, 0)) * sq;
    return true;
  }

  // the feature term f's residuals [C], each handed to ``out`` (false
  // where they are 0: a zero weight or a point outside its patch)
  template <typename T, class Out>
  LM_FN bool fconsis(const V3<T>& d, const V3<T>& m, int f, Out out) const {
    const float fwm = fw[f] * fc_mult;
    if (!(fwm > 0.f)) return false;
    const float sq = sqrtf(fwm + 1e-12f);
    const View vr = load_view(views_k, views_q, views_t, fr[f]);
    const View vt = load_view(views_k, views_q, views_t, ft[f]);
    const V3<float> sl = {{fco[3 * f], fco[3 * f + 1], fco[3 * f + 2]}};
    T xr, yr, xt, yt;
    dehomogenize(lm::cross(project_line(vr, d, m), sl), xr, yr);
    const V3<T> epl = epipolar_line(vr, vt, xr, yr);
    dehomogenize(lm::cross(project_line(vt, d, m), epl), xt, yt);
    const T lxr = xr - fro[2 * f], lyr = yr - fro[2 * f + 1];
    const T lxt = xt - fto[2 * f], lyt = yt - fto[2 * f + 1];
    const float hi = (float)(Pp - 1);
    auto inside = [hi](const T& a, const T& b) {
      return lm::val(a) >= 0.f && lm::val(a) <= hi && lm::val(b) >= 0.f
             && lm::val(b) <= hi;
    };
    const bool ok = inside(lxr, lyr) && inside(lxt, lyt);
    if (!ok) return false;  // zeros
    const long long patch = (long long)f * Pp * Pp * C;
    const lm::Bilinear<T> br(Pp, Pp, C, lxr, lyr);
    const lm::Bilinear<T> bt(Pp, Pp, C, lxt, lyt);
    for (int c = 0; c < C; ++c)
      out(c, (bt(ftp + patch, c) - br(frp + patch, c)) * sq);
    return true;
  }

  LM_FN void retract(const float (&p)[6], const float (&delta)[4],
                     float (&out)[6]) const {
    lm::retract_quat_so2(p, delta, out);
  }

  // every residual of this lane's items, each handed to ``add``
  template <typename T, class Team, class Add>
  LM_FN void residuals(Team& team, const T (&np)[6], Add add) const {
    V3<T> d, m;
    plucker(np, d, m);
    const float hsq = sqrtf(hm_mult + 1e-12f);
    for (int s = team.rank(); s < S; s += team.size()) {
      const View v = load_view(kv, qv, tv, s);
      const bool need_line =
          ((flags & GEOMETRIC) || (flags & HEATMAP)) && w[s] > 0.f;
      V3<T> coor;
      if (need_line) coor = project_line(v, d, m);
      if (flags & GEOMETRIC) {
        T r[2];
        if (geometric(coor, s, r)) {
          add(r[0]);
          add(r[1]);
        }
      }
      T rv;
      if (vp(v, d, s, rv)) add(rv);
      if ((flags & HEATMAP) && need_line && hm_mult > 0.f)
        for (int a = 0; a < A; ++a) {
          T rh;
          if (heatmap(coor, s, a, hsq, rh)) add(rh);
        }
    }
    if (flags & FCONSIS)
      for (int f = team.rank(); f < F; f += team.size())
        fconsis(d, m, f, [&](int, const T& r) { add(r); });
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

}  // namespace

// The kernel and its launch; what precedes compiles as host C++ too.
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

struct Args {
  const float *params0, *kv, *qv, *tv, *ps, *pe, *w, *vps, *vw;
  const float *hm, *hm_o, *hm_u, *hm_v, *hm_len;
  const float *views_k, *views_q, *views_t;
  const int *fr, *ft;
  const float *fco, *frp, *ftp, *fro, *fto, *fw;
  int T, S, A, Pa, F, Pp, C, flags, loss;
  float alpha, scale, scale2, hm_mult, fc_mult;
  lm::LMParams lp;
  float *params, *cost0, *cost;
  int* n_acc;
  float *trace, *ne;
};

constexpr int WARPS = 4;

__global__ void __launch_bounds__(32 * WARPS) lm_line_refine_kernel(Args a) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.T) return;  // a whole warp
  const long long o = (long long)row * a.S;
  const long long of = (long long)row * a.F;
  const long long pf = (long long)a.Pp * a.Pp * a.C;
  const Refine pb{a.kv + 4 * o, a.qv + 4 * o, a.tv + 3 * o, a.ps + 2 * o,
                  a.pe + 2 * o, a.w + o, a.vps + 3 * o, a.vw + o,
                  a.hm + o * a.A * a.Pa, a.hm_o + 2 * o, a.hm_u + 2 * o,
                  a.hm_v + 2 * o, a.hm_len + o, a.views_k, a.views_q,
                  a.views_t, a.fr + of, a.ft + of, a.fco + 3 * of,
                  a.frp + of * pf, a.ftp + of * pf, a.fro + 2 * of,
                  a.fto + 2 * of, a.fw + of, a.S, a.A, a.Pa, a.F, a.Pp, a.C,
                  a.flags, a.loss, a.alpha, a.scale, a.scale2, a.hm_mult,
                  a.fc_mult};
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

// d: the 25 inputs (params0 and RefineData's fields in order); dims: T, S,
// A, Pa, N, F, Pp, C; flags: 1 geometric, 2 heatmap, 4 feature
// consistency; hp: alpha, loss scale, its square, lambda init, up, down,
// min, max, heatmap and feature multipliers.  trace [T, n_iter, 14] and ne
// [T, 21] may be null; with ne the kernel writes the normal equations at
// params0 and runs no iteration.
extern "C" int lm_line_refine_launch(
    const float* params0, const float* kv, const float* qv, const float* tv,
    const float* ps, const float* pe, const float* w, const float* vps,
    const float* vw, const float* hm, const float* hm_o, const float* hm_u,
    const float* hm_v, const float* hm_len, const float* views_k,
    const float* views_q, const float* views_t, const int* fr, const int* ft,
    const float* fco, const float* frp, const float* ftp, const float* fro,
    const float* fto, const float* fw, long long T, long long S, long long A,
    long long Pa, long long N, long long F, long long Pp, long long C,
    long long flags, const float* hp, long long loss, long long n_iter,
    float* params, float* cost0, float* cost, int* n_acc, float* trace,
    float* ne, void* stream) {
  (void)N;
  Args a{params0, kv, qv, tv, ps, pe, w, vps, vw, hm, hm_o, hm_u, hm_v,
         hm_len, views_k, views_q, views_t, fr, ft, fco, frp, ftp, fro, fto,
         fw};
  a.T = (int)T;
  a.S = (int)S;
  a.A = (int)A;
  a.Pa = (int)Pa;
  a.F = (int)F;
  a.Pp = (int)Pp;
  a.C = (int)C;
  a.flags = (int)flags;
  a.loss = (int)loss;
  a.alpha = hp[0];
  a.scale = hp[1];
  a.scale2 = hp[2];
  a.lp = {(int)n_iter, hp[3], hp[4], hp[5], hp[6], hp[7]};
  a.hm_mult = hp[8];
  a.fc_mult = hp[9];
  a.params = params;
  a.cost0 = cost0;
  a.cost = cost;
  a.n_acc = n_acc;
  a.trace = trace;
  a.ne = ne;
  const int blocks = (int)((T + WARPS - 1) / WARPS);
  lm_line_refine_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
