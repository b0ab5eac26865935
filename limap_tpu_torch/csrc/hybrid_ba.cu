// Kernels O, P and Q: one step of the hybrid (pose + focal + line + point)
// bundle adjustment on one card.
//
// They replace the jitted program of limap_tpu/parallel/sharded_ba.py:
// make_hybrid_ba_step's body (:299-389) and make_hybrid_ba_cost (:439-449).
// The plain versions are in limap_tpu_torch/ops/hybrid_ba.py.
//
// O (hybrid_terms_launch) -- the vmap of _line_track_terms /
//   _point_track_terms (:303-308), _scatter_g and _accumulate_dense
//   (:317-330) and the Jacobi diagonal diag0 (:340-348).  Stage 1, one warp
//   a track, the lanes over its supports: each support's two residuals as
//   forward Jets over the landmark tangent (L = 4 for a line, 3 for a
//   point) and the support's own camera tangent (Dc = 6, or 8 with the
//   focal lengths) -- a support's residual depends on its own pose only,
//   so JAX's jacfwd to [S, 2, S, 6] and its diagonal are one Jet here.  The
//   lanes write H_cl [Dc, L], H_cc [Dc, Dc] and g_c [Dc] (into g_red's
//   place) of their weighted supports and sum H_ll, b_l and the cost; every
//   lane inverts H_ll + (lam + 1e-8) I and the lanes write A = H_cl H_ll^-1
//   and g_red = g_c - A b_l over g_c.  A slot of weight 0 is read for its
//   weight alone and its factors are not written.  Stage 2,
//   one warp a block (g, h) of the reduced system (a group is the pose of
//   an image or the focal lengths of a camera): the lanes take the
//   supports of group g in track order, find each track's supports of group
//   h (a binary search in the track's sorted images), add
//   [u == s] H_cc[s] - A[s] H_cl[u]^T, and the warp sums by a butterfly; the
//   diagonal warps also sum g_red and the self terms of diag0.  Every entry
//   is written once, by one warp, in a fixed order: no atomics.
// P (hybrid_apply_launch) -- CG's product (_matvec, :233-239) and the
//   back-substitution (backsub, :375-388), one cooperative launch.  Stage
//   1, a warp a track: y = H_ll^-1 (sum_s H_cl[s]^T v[cols_s] (+ b_l)); the
//   back-substitution writes -y.  Stage 2 (the product), after a grid-wide
//   barrier: the sum over a group's supports of H_cc[s] v[cols_s] -
//   H_cl[s] y_t, cut into SPLIT shares of consecutive supports (a warp a
//   share), then after another barrier the shares added in order (a warp
//   a group).
// Q (hybrid_cost_launch) -- the residuals alone, a warp a track (lines,
//   then points), each track's sum in lane order and a butterfly, then,
//   after a grid-wide barrier, the first block adds the tracks in a fixed
//   order: the same state gives the same cost every time, which the
//   host's accept/reject test compares.
//
// The cooperative kernels (P, Q) take as many blocks as the card holds at
// once, at most a warp a unit of work (a track, a share of a group), and
// stride over the units.  The file has four kernels: O's two stages, P
// and Q.
//
// Residuals as the plain versions write them: a line's cosine-weighted
// perpendicular distances of the 2D endpoints to the projection of the
// minimal line (minimal_to_plucker -> line_world_to_pixel ->
// cosine_weighted_perpendicular_dist2d), a point's reprojection error
// times sqrt(lw_point); each times sqrt(w rho'(|r|^2) + 1e-12), rho' from
// the detached residual (_weighted), zero where w <= 0.  The focal lengths
// are the camera's (cam_fxfy) plus the focal tangent, the principal point
// the support's kvec.
//
// Everything above the CUDA section compiles as host C++ too (with
// lm::SerialTeam in place of a warp), for tests of the arithmetic on a CPU.

#include "lm_common.cuh"

namespace hba {

using lm::Jet;
using lm::V3;
using lm::V4;

enum Kind { LINE = 0, POINT = 1 };

struct Hyper {
  float alpha, scale, scale2, sw, lam;
  int loss, const_pose, const_land;
};

// one kind of track and the state, track-major [T, S, ...]
struct Inputs {
  const float* land;  // [T, P]
  const float* pose;  // [I, 7]
  const float* fxfy;  // [C, 2]
  const float* kvec;  // [T, S, 4]
  const int* cam;     // [T, S]
  const int* img;     // [T, S]
  const float* obs;   // [T, S, 4] line (start, end) or [T, S, 2] point
  const float* w;     // [T, S]
  int T, S, I, C;
};

// the supports grouped by the camera block they feed (ops/hybrid_ba.py
// build_index)
struct Index {
  const int* grp_ptr;     // [G + 1]
  const int* inc;         // [E] t * S + s
  const int* sorted_img;  // [T, S]
  const int* sorted_pos;  // [T, S]
};

// per-track and per-support factors
struct Factors {
  float *hinv, *bl;  // [T, L, L], [T, L]
  float *hcl, *A;    // [T, S, Dc, L]
  float *hcc;        // [T, S, Dc, Dc]
  float *gred;       // [T, S, Dc]
  float* cost;       // [T]
  float* hll;        // [T, L, L] undamped (for the checks)
};

template <int KIND>
struct KindDims;
template <>
struct KindDims<LINE> {
  static constexpr int L = 4, P = 6, OBS = 4;
};
template <>
struct KindDims<POINT> {
  static constexpr int L = 3, P = 3, OBS = 2;
};

template <int N>
LM_FN Jet<N> jet_const(float v) {
  Jet<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = 0.f;
  return r;
}

// ---------------------------------------------------------- residuals
// one scalar type S for every input: float (Q) or Jet (O)
template <typename S>
LM_FN void line_residual(const S (&lp)[6], const S (&pose)[7], const S& fx,
                         const S& fy, float cx, float cy, const float* ob,
                         float alpha, S (&r)[2]) {
  // minimal_to_plucker
  const V4<S> u = {{lp[0], lp[1], lp[2], lp[3]}};
  V3<S> c0, c1;
  lm::quat_to_rotmat_cols01(u, c0, c1);
  const S w1 = lm::abs_(lp[4]);
  const S w2 = lm::abs_(lp[5]);
  const S ratio = w2 / (w1 + lm::EPS);
  V3<S> m;
#pragma unroll
  for (int i = 0; i < 3; ++i) m.v[i] = c1.v[i] * ratio;
  // line_world_to_pixel: m_cam = R m + t x R d, then det(K) K^-T m_cam
  const V4<S> q = {{pose[0], pose[1], pose[2], pose[3]}};
  const V3<S> t = {{pose[4], pose[5], pose[6]}};
  const V3<S> Rm = lm::quat_rotate(q, m);
  const V3<S> Rd = lm::quat_rotate(q, c0);
  const V3<S> tRd = lm::cross(t, Rd);
  V3<S> mc;
#pragma unroll
  for (int i = 0; i < 3; ++i) mc.v[i] = Rm.v[i] + tRd.v[i];
  V3<S> coor = {{fy * mc.v[0], fx * mc.v[1],
                 (fx * fy) * mc.v[2] - (cx * fy) * mc.v[0]
                     - (cy * fx) * mc.v[1]}};
  coor = lm::normalize3(coor);
  // cosine_weighted_perpendicular_dist2d
  const S dn = lm::sqrt_(coor.v[0] * coor.v[0] + coor.v[1] * coor.v[1]
                         + lm::EPS);
  const float p1x = ob[0], p1y = ob[1], p2x = ob[2], p2y = ob[3];
  const S d1 = (p1x * coor.v[0] + p1y * coor.v[1] + coor.v[2]) / dn;
  const S d2 = (p2x * coor.v[0] + p2y * coor.v[1] + coor.v[2]) / dn;
  const S dir0 = (-coor.v[1]) / dn;
  const S dir1 = coor.v[0] / dn;
  const float sx = p2x - p1x, sy = p2y - p1y;
  const float sn = sqrtf(sx * sx + sy * sy + lm::EPS);
  const S cosine = lm::clamp_max_(lm::abs_(dir0 * sx + dir1 * sy) / sn, 1.f);
  const S weight = lm::exp_(alpha * (1.f - cosine));
  r[0] = d1 * weight;
  r[1] = d2 * weight;
}

template <typename S>
LM_FN void point_residual(const S (&x)[3], const S (&pose)[7], const S& fx,
                          const S& fy, float cx, float cy, const float* ob,
                          float sw, S (&r)[2]) {
  const V4<S> q = {{pose[0], pose[1], pose[2], pose[3]}};
  const V3<S> xv = {{x[0], x[1], x[2]}};
  const V3<S> Rx = lm::quat_rotate(q, xv);
  V3<S> pc;
#pragma unroll
  for (int i = 0; i < 3; ++i) pc.v[i] = Rx.v[i] + pose[4 + i];
  const S z = pc.v[2] + lm::EPS;
  const S u = pc.v[0] / z;
  const S v = pc.v[1] / z;
  r[0] = ((fx * u + cx) - ob[0]) * sw;
  r[1] = ((fy * v + cy) - ob[1]) * sw;
}

// _weighted: sqrt(w rho'(|r|^2) + 1e-12), rho' of the values alone
template <typename S>
LM_FN void weigh(S (&r)[2], float ws, const Hyper& h) {
  const float r2 = lm::val(r[0]) * lm::val(r[0])
                   + lm::val(r[1]) * lm::val(r[1]);
  const float sc =
      sqrtf(ws * lm::robust_weight(r2, h.loss, h.scale, h.scale2) + 1e-12f);
  r[0] = r[0] * sc;
  r[1] = r[1] * sc;
}

// the weighted residuals of support (t, s) as Jets over (landmark [L],
// pose [6], focal [DC - 6]) at delta = 0
template <int KIND, int DC>
LM_FN void support_jets(const Inputs& in, const Hyper& h, int t, int s,
                        Jet<KindDims<KIND>::L + DC> (&r)[2]) {
  constexpr int L = KindDims<KIND>::L, N = L + DC;
  const long long ts = (long long)t * in.S + s;
  const int im = in.img[ts], c = in.cam[ts];
  Jet<N> dpose[6], pose[7];
#pragma unroll
  for (int k = 0; k < 6; ++k) dpose[k] = lm::jet_basis<N>(L + k);
  lm::retract_pose(in.pose + 7 * im, dpose, pose);
  Jet<N> fx = jet_const<N>(in.fxfy[2 * c]);
  Jet<N> fy = jet_const<N>(in.fxfy[2 * c + 1]);
  if constexpr (DC == 8) {
    fx = fx + lm::jet_basis<N>(L + 6);
    fy = fy + lm::jet_basis<N>(L + 7);
  }
  const float* kv = in.kvec + 4 * ts;
  const float* ob = in.obs + KindDims<KIND>::OBS * ts;
  if constexpr (KIND == LINE) {
    Jet<N> dl[4], lp[6];
#pragma unroll
    for (int k = 0; k < 4; ++k) dl[k] = lm::jet_basis<N>(k);
    lm::retract_quat_so2(in.land + 6 * t, dl, lp);
    line_residual(lp, pose, fx, fy, kv[2], kv[3], ob, h.alpha, r);
  } else {
    Jet<N> x[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      x[k] = lm::jet_basis<N>(k) + in.land[3 * t + k];
    point_residual(x, pose, fx, fy, kv[2], kv[3], ob, h.sw, r);
  }
  weigh(r, in.w[ts], h);
}

// the weighted residuals of support (t, s) at the state, in float
template <int KIND>
LM_FN void support_values(const Inputs& in, const Hyper& h, int t, int s,
                          float (&r)[2]) {
  const long long ts = (long long)t * in.S + s;
  const int im = in.img[ts], c = in.cam[ts];
  float pose[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) pose[k] = in.pose[7 * im + k];
  const float fx = in.fxfy[2 * c], fy = in.fxfy[2 * c + 1];
  const float* kv = in.kvec + 4 * ts;
  const float* ob = in.obs + KindDims<KIND>::OBS * ts;
  if constexpr (KIND == LINE) {
    float lp[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) lp[k] = in.land[6 * t + k];
    line_residual(lp, pose, fx, fy, kv[2], kv[3], ob, h.alpha, r);
  } else {
    float x[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = in.land[3 * t + k];
    point_residual(x, pose, fx, fy, kv[2], kv[3], ob, h.sw, r);
  }
  weigh(r, in.w[ts], h);
}

// Gauss-Jordan inverse with partial pivoting (the plain version's
// torch.linalg.inv pivots too); the row swaps are predicated so that every
// index stays static and the matrices stay in registers
template <int L>
LM_FN void invert(float (&A)[L][L], float (&X)[L][L]) {
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) X[i][j] = i == j ? 1.f : 0.f;
#pragma unroll
  for (int c = 0; c < L; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < L; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        piv = r;
      }
#pragma unroll
    for (int r = c + 1; r < L; ++r) {
      const bool sw = r == piv;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float a = A[c][j], x = X[c][j];
        A[c][j] = sw ? A[r][j] : a;
        A[r][j] = sw ? a : A[r][j];
        X[c][j] = sw ? X[r][j] : x;
        X[r][j] = sw ? x : X[r][j];
      }
    }
    const float inv = 1.f / A[c][c];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      A[c][j] = A[c][j] * inv;
      X[c][j] = X[c][j] * inv;
    }
#pragma unroll
    for (int r = 0; r < L; ++r) {
      if (r == c) continue;
      const float f = A[r][c];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        A[r][j] = A[r][j] - f * A[c][j];
        X[r][j] = X[r][j] - f * X[c][j];
      }
    }
  }
}

// --------------------------------------------------- O, stage 1: a track
template <int KIND, int DC, class Team>
LM_FN void track_terms(const Inputs& in, const Hyper& h, const Factors& o,
                       int t, Team& team) {
  constexpr int L = KindDims<KIND>::L, TRI = L * (L + 1) / 2;
  float acc[TRI + L + 1];
#pragma unroll
  for (int k = 0; k < TRI + L + 1; ++k) acc[k] = 0.f;
  for (int s = team.rank(); s < in.S; s += team.size()) {
    const long long ts = (long long)t * in.S + s;
    if (!(in.w[ts] > 0.f)) continue;
    float r0[2], Jl[2][L], Jc[2][DC];
    Jet<L + DC> r[2];
    support_jets<KIND, DC>(in, h, t, s, r);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      r0[rr] = r[rr].v;
#pragma unroll
      for (int a = 0; a < L; ++a) Jl[rr][a] = h.const_land ? 0.f : r[rr].d[a];
#pragma unroll
      for (int p = 0; p < DC; ++p)
        Jc[rr][p] = (h.const_pose && p < 6) ? 0.f : r[rr].d[L + p];
    }
    float* hcl = o.hcl + ts * DC * L;
    float* hcc = o.hcc + ts * DC * DC;
    float* gc = o.gred + ts * DC;  // g_c until the second pass
#pragma unroll
    for (int p = 0; p < DC; ++p) {
#pragma unroll
      for (int a = 0; a < L; ++a)
        hcl[p * L + a] = Jc[0][p] * Jl[0][a] + Jc[1][p] * Jl[1][a];
#pragma unroll
      for (int q = 0; q < DC; ++q)
        hcc[p * DC + q] = Jc[0][p] * Jc[0][q] + Jc[1][p] * Jc[1][q];
      gc[p] = Jc[0][p] * r0[0] + Jc[1][p] * r0[1];
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < L; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        acc[k++] += Jl[0][a] * Jl[0][b] + Jl[1][a] * Jl[1][b];
#pragma unroll
    for (int a = 0; a < L; ++a)
      acc[TRI + a] += Jl[0][a] * r0[0] + Jl[1][a] * r0[1];
    acc[TRI + L] += r0[0] * r0[0] + r0[1] * r0[1];
  }
  team.sum(acc);
  float H[L][L], Hi[L][L], bl[L];
  const float damp = h.lam + 1e-8f;
#pragma unroll
  for (int a = 0; a < L; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      H[a][b] = acc[a * (a + 1) / 2 + b];
      H[b][a] = H[a][b];
    }
    bl[a] = acc[TRI + a];
  }
#pragma unroll
  for (int a = 0; a < L; ++a) H[a][a] = H[a][a] + damp;
  invert<L>(H, Hi);
  // the same lanes take the same slots as in the first pass
  for (int s = team.rank(); s < in.S; s += team.size()) {
    const long long ts = (long long)t * in.S + s;
    if (!(in.w[ts] > 0.f)) continue;
    const float* hcl = o.hcl + ts * DC * L;
    float* A = o.A + ts * DC * L;
    float* gr = o.gred + ts * DC;
#pragma unroll
    for (int p = 0; p < DC; ++p) {
      float Ab = 0.f;
#pragma unroll
      for (int b = 0; b < L; ++b) {
        float x = 0.f;
#pragma unroll
        for (int a = 0; a < L; ++a) x += hcl[p * L + a] * Hi[a][b];
        A[p * L + b] = x;
        Ab += x * bl[b];
      }
      gr[p] = gr[p] - Ab;
    }
  }
  if (team.leader()) {
#pragma unroll
    for (int a = 0; a < L; ++a) {
      o.bl[t * L + a] = bl[a];
#pragma unroll
      for (int b = 0; b < L; ++b) {
        o.hinv[(t * L + a) * L + b] = Hi[a][b];
        o.hll[(t * L + a) * L + b] = acc[a >= b ? a * (a + 1) / 2 + b
                                                : b * (b + 1) / 2 + a];
      }
    }
    o.cost[t] = acc[TRI + L];
  }
}

// a group's first entry of the camera tangent [D] and its size; the
// entry of a support's Dc-vector where the group starts
LM_FN int group_base(int g, int I) { return g < I ? 6 * g : 6 * I + 2 * (g - I); }
LM_FN int group_size(int g, int I) { return g < I ? 6 : 2; }
LM_FN int group_off(int g, int I) { return g < I ? 0 : 6; }

// the first k in [0, S) with a[k] >= key (a ascending)
LM_FN int lower_bound(const int* a, int S, int key) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ------------------------------------------ O, stage 2: a block (g, h)
// writes Hp's block (g, h) (when dense) and, when g == h, g and diag0 of
// group g
template <int L, int DC, class Team>
LM_FN void assemble_block(const Inputs& in, const Index& ix,
                          const Factors& o, int g, int hc, bool dense,
                          Team& team, float* Hp, float* gv, float* diag0) {
  const int I = in.I, S = in.S;
  const int D = 6 * I + (DC == 8 ? 2 * in.C : 0);
  const int rg = group_size(g, I), ro = group_off(g, I);
  const int co = group_off(hc, I);
  const bool self = g == hc;
  float acc[48];  // block [6][6], then g [6], then diag0 [6]
#pragma unroll
  for (int k = 0; k < 48; ++k) acc[k] = 0.f;
  for (int e = ix.grp_ptr[g] + team.rank(); e < ix.grp_ptr[g + 1];
       e += team.size()) {
    const int ts = ix.inc[e];
    const int t = ts / S, s = ts - t * S;
    const float* A = o.A + (long long)ts * DC * L;
    const float* hcl_s = o.hcl + (long long)ts * DC * L;
    const float* hcc = o.hcc + (long long)ts * DC * DC;
    if (self) {
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        if (p >= rg) break;
        const int pp = ro + p;
        float sr = 0.f;
#pragma unroll
        for (int a = 0; a < L; ++a) sr += A[pp * L + a] * hcl_s[pp * L + a];
        acc[36 + p] += o.gred[(long long)ts * DC + pp];
        acc[42 + p] += hcc[pp * DC + pp] + (-sr);
      }
    }
    if (!dense) continue;
    const long long tb = (long long)t * S;
    int k0, k1;
    if (hc < I) {
      k0 = lower_bound(ix.sorted_img + tb, S, hc);
      k1 = lower_bound(ix.sorted_img + tb, S, hc + 1);
    } else {
      k0 = 0;
      k1 = S;
    }
    for (int k = k0; k < k1; ++k) {
      int u;
      if (hc < I) {
        u = ix.sorted_pos[tb + k];
      } else {
        u = k;
        if (!(in.w[tb + u] > 0.f) || in.cam[tb + u] != hc - I) continue;
      }
      const float* hcl_u = o.hcl + (tb + u) * DC * L;
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        if (p >= rg) break;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          if (q >= group_size(hc, I)) break;
          float x = 0.f;
#pragma unroll
          for (int a = 0; a < L; ++a)
            x += A[(ro + p) * L + a] * hcl_u[(co + q) * L + a];
          const float d = u == s ? hcc[(ro + p) * DC + co + q] : 0.f;
          acc[p * 6 + q] += d - x;
        }
      }
    }
  }
  team.sum(acc);
  if (!team.leader()) return;
  const int rb = group_base(g, I), cb = group_base(hc, I);
  if (dense)
    for (int p = 0; p < rg; ++p)
      for (int q = 0; q < group_size(hc, I); ++q)
        Hp[(long long)(rb + p) * D + cb + q] = acc[p * 6 + q];
  if (self)
    for (int p = 0; p < rg; ++p) {
      gv[rb + p] = acc[36 + p];
      diag0[rb + p] = acc[42 + p];
    }
}

// the column of entry p of support (t, s)'s camera tangent
LM_FN int col_of(const Inputs& in, long long ts, int p) {
  return p < 6 ? 6 * in.img[ts] + p : 6 * in.I + 2 * in.cam[ts] + (p - 6);
}

// ------------------------------------------------- P, stage 1: a track
template <int L, int DC, class Team>
LM_FN void apply_track(const Inputs& in, const Factors& o, const float* v,
                       bool backsub, int t, Team& team, float* y) {
  float acc[L];
#pragma unroll
  for (int a = 0; a < L; ++a) acc[a] = 0.f;
  for (int s = team.rank(); s < in.S; s += team.size()) {
    const long long ts = (long long)t * in.S + s;
    if (!(in.w[ts] > 0.f)) continue;
    const float* hcl = o.hcl + ts * DC * L;
#pragma unroll
    for (int p = 0; p < DC; ++p) {
      const float vp = v[col_of(in, ts, p)];
#pragma unroll
      for (int a = 0; a < L; ++a) acc[a] += hcl[p * L + a] * vp;
    }
  }
  team.sum(acc);
  if (!team.leader()) return;
  if (backsub)
#pragma unroll
    for (int a = 0; a < L; ++a) acc[a] = o.bl[t * L + a] + acc[a];
#pragma unroll
  for (int a = 0; a < L; ++a) {
    float x = 0.f;
#pragma unroll
    for (int b = 0; b < L; ++b) x += o.hinv[(t * L + a) * L + b] * acc[b];
    y[t * L + a] = backsub ? -x : x;
  }
}

// ------------------------------------------- P, stage 2: a share of a group
// The product's sum over a group's supports is cut into SPLIT shares of
// consecutive supports, a warp each, then the shares are added in order.
constexpr int SPLIT = 16;

// share k of group g: sum of H_cc[s] v[cols_s] - H_cl[s] y_t into
// part[(g * SPLIT + k) * 6 ...]
template <int L, int DC, class Team>
LM_FN void apply_share(const Inputs& in, const Index& ix, const Factors& o,
                       const float* v, const float* y, int g, int k,
                       Team& team, float* part) {
  const int I = in.I, S = in.S;
  const int rg = group_size(g, I), ro = group_off(g, I);
  const int first = ix.grp_ptr[g], n = ix.grp_ptr[g + 1] - first;
  const int per = (n + SPLIT - 1) / SPLIT;
  const int lo = first + k * per;
  const int hi = lo + per < first + n ? lo + per : first + n;
  float acc[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) acc[p] = 0.f;
  for (int e = lo + team.rank(); e < hi; e += team.size()) {
    const int ts = ix.inc[e];
    const int t = ts / S;
    const float* hcl = o.hcl + (long long)ts * DC * L;
    const float* hcc = o.hcc + (long long)ts * DC * DC;
    float vc[DC];
#pragma unroll
    for (int q = 0; q < DC; ++q) vc[q] = v[col_of(in, ts, q)];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (p >= rg) break;
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int q = 0; q < DC; ++q) a1 += hcc[(ro + p) * DC + q] * vc[q];
#pragma unroll
      for (int a = 0; a < L; ++a) a2 += hcl[(ro + p) * L + a] * y[t * L + a];
      acc[p] += a1 - a2;
    }
  }
  team.sum(acc);
  if (team.leader())
    for (int p = 0; p < 6; ++p) part[((long long)g * SPLIT + k) * 6 + p] = acc[p];
}

// group g's entries of the product: its shares added in order, an entry
// a lane
template <class Team>
LM_FN void apply_gather(const Inputs& in, const float* part, int g,
                        Team& team, float* out) {
  const int p = team.rank();
  if (p >= group_size(g, in.I)) return;
  float x = 0.f;
  for (int k = 0; k < SPLIT; ++k) x += part[((long long)g * SPLIT + k) * 6 + p];
  out[group_base(g, in.I) + p] = x;
}

// --------------------------------------------------------- Q: a track
template <int KIND, class Team>
LM_FN float track_cost(const Inputs& in, const Hyper& h, int t, Team& team) {
  float c = 0.f;
  for (int s = team.rank(); s < in.S; s += team.size()) {
    if (!(in.w[(long long)t * in.S + s] > 0.f)) continue;
    float r[2];
    support_values<KIND>(in, h, t, s, r);
    c += r[0] * r[0] + r[1] * r[1];
  }
  return team.sum1(c);
}

}  // namespace hba

// The kernels and their launches; what precedes compiles as host C++ too.
#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

using namespace hba;

constexpr int WARPS = 4;

__device__ __forceinline__ int warp_id() {
  return blockIdx.x * WARPS + (threadIdx.x >> 5);
}

template <int KIND, int DC>
__global__ void __launch_bounds__(32 * WARPS)
    terms_kernel(Inputs in, Hyper h, Factors o) {
  const int t = warp_id();
  if (t >= in.T) return;  // a whole warp
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  track_terms<KIND, DC>(in, h, o, t, team);
}

template <int L, int DC>
__global__ void __launch_bounds__(32 * WARPS)
    assemble_kernel(Inputs in, Index ix, Factors o, int G, int dense,
                    float* Hp, float* gv, float* diag0) {
  const long long w = warp_id();
  const long long n = dense ? (long long)G * G : G;
  if (w >= n) return;
  const int g = dense ? (int)(w / G) : (int)w;
  const int hc = dense ? (int)(w % G) : g;
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  assemble_block<L, DC>(in, ix, o, g, hc, dense, team, Hp, gv, diag0);
}

// P: stage 1 over the tracks, then (the product) stage 2 over the shares
// of the groups and, after another barrier, over the groups
template <int L, int DC>
__global__ void __launch_bounds__(32 * WARPS)
    apply_kernel(Inputs in, Index ix, Factors o, const float* v, int backsub,
                 float* y, int G, float* part, float* out) {
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  const int nw = gridDim.x * WARPS;
  for (int t = warp_id(); t < in.T; t += nw)
    apply_track<L, DC>(in, o, v, backsub, t, team, y);
  if (backsub) return;
  auto grid = cooperative_groups::this_grid();
  grid.sync();
  for (int u = warp_id(); u < G * SPLIT; u += nw)
    apply_share<L, DC>(in, ix, o, v, y, u / SPLIT, u % SPLIT, team, part);
  grid.sync();
  for (int g = warp_id(); g < G; g += nw)
    apply_gather(in, part, g, team, out);
}

// Q: lines are tracks [0, Tl), points [Tl, Tl + Tp); then the first block
// adds lines and points, each in a fixed order (thread i takes tracks i,
// i + 128, ..., then a shared-memory tree)
__global__ void __launch_bounds__(32 * WARPS)
    cost_kernel(Inputs li, Inputs pi, Hyper h, float* per_track,
                float* out) {
  constexpr int RED = 32 * WARPS;
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  const int nw = gridDim.x * WARPS;
  for (int t = warp_id(); t < li.T + pi.T; t += nw) {
    const float c = t < li.T ? track_cost<LINE>(li, h, t, team)
                             : track_cost<POINT>(pi, h, t - li.T, team);
    if (team.leader()) per_track[t] = c;
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  __shared__ float sh[2][RED];
  const int i = threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int k = i; k < li.T; k += RED) a += per_track[k];
  for (int k = i; k < pi.T; k += RED) b += per_track[li.T + k];
  sh[0][i] = a;
  sh[1][i] = b;
  __syncthreads();
  for (int off = RED / 2; off > 0; off >>= 1) {
    if (i < off) {
      sh[0][i] += sh[0][i + off];
      sh[1][i] += sh[1][i + off];
    }
    __syncthreads();
  }
  if (i == 0) out[0] = sh[0][0] + sh[1][0];
}

int blocks_for(long long warps) { return (int)((warps + WARPS - 1) / WARPS); }

template <int KIND, int DC>
int launch_terms(const Inputs& in, const Hyper& h, const Index& ix,
                 const Factors& o, int dense, float* Hp, float* gv,
                 float* diag0, cudaStream_t st) {
  constexpr int L = KindDims<KIND>::L;
  terms_kernel<KIND, DC><<<blocks_for(in.T), 32 * WARPS, 0, st>>>(in, h, o);
  const int G = in.I + (DC == 8 ? in.C : 0);
  const long long n = dense ? (long long)G * G : G;
  assemble_kernel<L, DC><<<blocks_for(n), 32 * WARPS, 0, st>>>(
      in, ix, o, G, dense, Hp, gv, diag0);
  return (int)cudaGetLastError();
}

// a cooperative launch of ``kernel`` with one warp a unit of ``warps``,
// at most as many blocks as are resident at once
template <typename K, typename... Args>
int launch_coop(K kernel, long long warps, cudaStream_t st, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * WARPS,
                                                0);
  const long long most = (long long)sms * per_sm;
  const int blocks = (int)(blocks_for(warps) < most ? blocks_for(warps)
                                                    : most);
  void* ptrs[] = {(void*)&args...};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel,
                                          dim3(blocks > 0 ? blocks : 1),
                                          dim3(32 * WARPS), ptrs, 0, st);
}

template <int L, int DC>
int launch_apply(const Inputs& in, const Index& ix, const Factors& o,
                 const float* v, int backsub, float* y, float* part,
                 float* out, cudaStream_t st) {
  const int G = in.I + (DC == 8 ? in.C : 0);
  const long long warps = in.T > G * SPLIT ? in.T : G * SPLIT;
  const int err = launch_coop(apply_kernel<L, DC>, warps, st, in, ix, o, v,
                              backsub, y, G, part, out);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// O.  p: land, pose, fxfy, kvec, cam, img, obs, w, grp_ptr, inc,
// sorted_img, sorted_pos, hinv, bl, hcl, A, hcc, gred, cost [T], Hp (null
// unless dense), g, diag0, hll.  n: kind, focal, T, S, I, C, loss, const_pose,
// const_land, dense.  f: alpha, loss scale, loss scale^2, sqrt(lw_point),
// lam.
extern "C" int hybrid_terms_launch(void** p, const long long* n,
                                   const float* f, void* stream) {
  Inputs in{(const float*)p[0], (const float*)p[1], (const float*)p[2],
            (const float*)p[3], (const int*)p[4],   (const int*)p[5],
            (const float*)p[6], (const float*)p[7], (int)n[2],
            (int)n[3],          (int)n[4],          (int)n[5]};
  Index ix{(const int*)p[8], (const int*)p[9], (const int*)p[10],
           (const int*)p[11]};
  Factors o{(float*)p[12], (float*)p[13], (float*)p[14], (float*)p[15],
            (float*)p[16], (float*)p[17], (float*)p[18], (float*)p[22]};
  Hyper h{f[0], f[1], f[2], f[3], f[4], (int)n[6], (int)n[7], (int)n[8]};
  float *Hp = (float*)p[19], *gv = (float*)p[20], *diag0 = (float*)p[21];
  const int dense = (int)n[9];
  auto st = (cudaStream_t)stream;
  if (n[0] == LINE)
    return n[1] ? launch_terms<LINE, 8>(in, h, ix, o, dense, Hp, gv, diag0, st)
                : launch_terms<LINE, 6>(in, h, ix, o, dense, Hp, gv, diag0, st);
  return n[1] ? launch_terms<POINT, 8>(in, h, ix, o, dense, Hp, gv, diag0, st)
              : launch_terms<POINT, 6>(in, h, ix, o, dense, Hp, gv, diag0, st);
}

// P.  p: img, cam, w, hinv, bl, hcl, hcc, v, y [T, L], grp_ptr, inc, out
// and part [G * SPLIT * 6] (both null for the back-substitution).  n:
// kind, focal, T, S, I, C, backsub.
extern "C" int hybrid_apply_launch(void** p, const long long* n,
                                   const float*, void* stream) {
  Inputs in{nullptr, nullptr, nullptr, nullptr, (const int*)p[1],
            (const int*)p[0], nullptr, (const float*)p[2], (int)n[2],
            (int)n[3], (int)n[4], (int)n[5]};
  Index ix{(const int*)p[9], (const int*)p[10], nullptr, nullptr};
  Factors o{(float*)p[3], (float*)p[4], (float*)p[5], nullptr,
            (float*)p[6], nullptr, nullptr, nullptr};
  const float* v = (const float*)p[7];
  float *y = (float*)p[8], *out = (float*)p[11], *part = (float*)p[12];
  const int backsub = (int)n[6];
  auto st = (cudaStream_t)stream;
  if (n[0] == LINE)
    return n[1] ? launch_apply<4, 8>(in, ix, o, v, backsub, y, part, out, st)
                : launch_apply<4, 6>(in, ix, o, v, backsub, y, part, out, st);
  return n[1] ? launch_apply<3, 8>(in, ix, o, v, backsub, y, part, out, st)
              : launch_apply<3, 6>(in, ix, o, v, backsub, y, part, out, st);
}

// Q.  p: line land, point land, pose, fxfy, then kvec, cam, img, obs, w of
// the lines and of the points, per_track [Tl + Tp], out [].  n: Tl, Sl,
// Tp, Sp, loss.  f: alpha, loss scale, loss scale^2, sqrt(lw_point).
extern "C" int hybrid_cost_launch(void** p, const long long* n,
                                  const float* f, void* stream) {
  const float *pose = (const float*)p[2], *fxfy = (const float*)p[3];
  Inputs li{(const float*)p[0], pose, fxfy, (const float*)p[4],
            (const int*)p[5], (const int*)p[6], (const float*)p[7],
            (const float*)p[8], (int)n[0], (int)n[1], 0, 0};
  Inputs pi{(const float*)p[1], pose, fxfy, (const float*)p[9],
            (const int*)p[10], (const int*)p[11], (const float*)p[12],
            (const float*)p[13], (int)n[2], (int)n[3], 0, 0};
  Hyper h{f[0], f[1], f[2], f[3], 0.f, (int)n[4], 0, 0};
  float *per_track = (float*)p[14], *out = (float*)p[15];
  const int err = launch_coop(cost_kernel, (long long)li.T + pi.T,
                              (cudaStream_t)stream, li, pi, h, per_track,
                              out);
  return err ? err : (int)cudaGetLastError();
}
#endif  // __CUDACC__
