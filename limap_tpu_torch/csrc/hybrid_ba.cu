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
//   weight alone and its factors are not written.  Stage 2 walks the
//   pairs of a block (g, h) of the reduced system (a group is the pose of
//   an image or the focal lengths of a camera): the (s, u) pairs of
//   weighted supports of one track with s in g and u in h, listed once a
//   solve by ops/hybrid_ba.py::build_index in the order the first design
//   met them (s by its place in the track-major order, then u).  A block's
//   pairs are cut into shares of SHARE consecutive pairs (without the
//   dense matrix a group's (s, s) pairs are one share, so that g and diag0
//   are the first design's sums bit for bit), a warp a share:
//   the lanes add [u == s] H_cc[s] - A[s] H_cl[u]^T, and on a diagonal
//   block g_red and the self terms of diag0 of their pairs with u == s,
//   then the warp sums by a butterfly into the share's PART partials;
//   then a warp a chunk adds CHUNK consecutive shares of a block in order,
//   and a warp a block its chunks in order (an entry a lane, CHUNK loads
//   in flight; one warp for every share of a focal block took ms), and
//   writes the block (and g and diag0 of a diagonal block; a block
//   without pairs is 0).  Without
//   the dense matrix the list holds the diagonal blocks' (s, s) pairs
//   alone.  Every entry is written once, in a fixed order: no atomics, so
//   the same state gives the same bits.
//   Bound: the first design (kept as the yardstick
//   hybrid_terms_scan: a warp a block walks all of group g's supports and
//   binary-searches each one's track for image h) visited every support of
//   g for each of the G blocks of its row, ~1.2e7 visits on phase 14's
//   points against the 4,441,395 pairs that contribute.  A pair's own work
//   is 2 Dc^2 L operations on A[s] and H_cl[u] read from L2; the share
//   kernel is held by the latency of its two dependent reads a round (the
//   pairs, then the rows they name), not by that work.
// P (hybrid_apply_launch) -- CG's product (_matvec, :233-239) of one kind
//   or of both (lines then points: CG's product is their sum) and the
//   back-substitution (backsub, :375-388).  Stage 1, a warp a track: y =
//   H_ll^-1 (sum_s H_cl[s]^T v[cols_s] (+ b_l)); the back-substitution
//   writes -y and ends there.  For the product each lane then writes, for
//   its weighted supports, the contribution c_s = H_cc[s] v[cols_s] -
//   H_cl[s] y_t [Dc] (contrib_track) while H_cl[s] is warm.  After a
//   grid barrier (one cooperative launch), stage 2 takes a group a
//   block: warp k sums share k of the group's supports (SPLIT shares of
//   consecutive supports, each lane its strided supports, then a
//   butterfly) from the contributions alone,
//   and the first threads add the shares in order and, for both kinds,
//   the line sum and the point sum.  The floats added and their order
//   are those of the first design, so the product is its bits.
//   Bound: bytes (H_cl and H_cc of each weighted support, read once).
//   The first design (the yardstick hybrid_apply_scan) had stage 2 read
//   each support's H_cc, H_cl, v columns and its track's y again,
//   through a second grid barrier and partials in global memory, and a
//   launch a kind: two a CG product, against one.
// Q (hybrid_cost_launch) -- the residuals alone, a warp a track (lines,
//   then points), each track's sum in lane order and a butterfly, then,
//   after a grid-wide barrier, the first block adds the tracks in a fixed
//   order: the same state gives the same cost every time, which the
//   host's accept/reject test compares.
//
// The cooperative kernels (P and its first design, Q) take as many
// blocks as the card holds at once (queried once a kernel and device),
// at most a warp a unit of work (a track, a share of a group; P a block
// a group), and stride over the units.  The file has nine kernels: O's stage 1, its stage 2 (the
// shares, the chunks, the blocks), the first designs of O's stage 2 and
// of P (the yardsticks), P and Q.
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

// stage 2's pairs (ops/hybrid_ba.py build_index): block b = g G + h on the
// dense path, g without it; its pairs [pair_ptr[b], pair_ptr[b + 1]) as
// t * S + s and t * S + u; its shares [share_ptr[b], share_ptr[b + 1])
// (share k the pairs [share_first[k], share_first[k + 1]): SHARE of them
// on the dense path, a whole group without it), in chunks of CHUNK
// consecutive shares [chunk_ptr[b], chunk_ptr[b + 1])
struct PairIndex {
  const int* pair_ptr;     // [NB + 1]
  const int* pair_s;       // [P]
  const int* pair_u;       // [P]
  const int* share_ptr;    // [NB + 1]
  const int* share_block;  // [NS]
  const int* chunk_ptr;    // [NB + 1] the block's chunks of CHUNK shares
  const int* chunk_block;  // [NC]
  const int* share_first;  // [NS + 1] share k's pairs, to share k + 1's
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

// ------------------------------- O, stage 2: a share of a block's pairs
// a share's pairs, its partials: the block [6][6], then g [6], then diag0 [6]
constexpr int SHARE = 128;
constexpr int PART = 48;
constexpr int CHUNK = 32;

// a read of memory no thread writes during the launch (through the
// read-only path on the card, so that sum_rows keeps CHUNK loads in
// flight)
LM_FN float load_nc(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// one pair's terms: Ar the rows of A[s] of group g (from row ro), Hu those
// of H_cl[u] of group h (from row co), hcc and gred support s's; on a
// diagonal block the pair with u == s (same) also adds g_red and the self
// term of diag0, where Hu are then s's own rows of group g
template <int L, int DC>
LM_FN void pair_terms(const float* Ar, const float* Hu, const float* hcc,
                      const float* gred, bool same, bool self, bool dense,
                      int rg, int cg, int ro, int co, float (&acc)[PART]) {
  if (self && same) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r >= rg) break;
      float sr = 0.f;
#pragma unroll
      for (int a = 0; a < L; ++a) sr += Ar[r * L + a] * Hu[r * L + a];
      acc[36 + r] += gred[ro + r];
      acc[42 + r] += hcc[(ro + r) * DC + ro + r] + (-sr);
    }
  }
  if (!dense) return;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    if (r >= rg) break;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      if (q >= cg) break;
      float x = 0.f;
#pragma unroll
      for (int a = 0; a < L; ++a) x += Ar[r * L + a] * Hu[q * L + a];
      acc[r * 6 + q] += -x;
    }
  }
  if (!same) return;  // H_cc's rows, read for u == s alone
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    if (r >= rg) break;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      if (q >= cg) break;
      acc[r * 6 + q] += hcc[(ro + r) * DC + co + q];
    }
  }
}

// share k of block b, a lane every team.size()-th pair: the sum over its
// pairs (s, u) of [u == s] H_cc[s] - A[s] H_cl[u]^T (dense) and, on a
// diagonal block, the self terms of g and diag0 of its pairs with u == s,
// into part[k * PART ...] (the card's share_kernel stages the rows in
// shared memory and adds in the same order)
template <int L, int DC, class Team>
LM_FN void assemble_share(const Inputs& in, const PairIndex& px,
                          const Factors& o, int G, bool dense, int k,
                          Team& team, float* part) {
  const int I = in.I;
  const int b = px.share_block[k];
  const int g = dense ? b / G : b, hc = dense ? b % G : b;
  const int rg = group_size(g, I), ro = group_off(g, I);
  const int cg = group_size(hc, I), co = group_off(hc, I);
  const int p0 = px.share_first[k], p1 = px.share_first[k + 1];
  float acc[PART];
#pragma unroll
  for (int i = 0; i < PART; ++i) acc[i] = 0.f;
  for (int p = p0 + team.rank(); p < p1; p += team.size()) {
    const long long s = px.pair_s[p], u = px.pair_u[p];
    pair_terms<L, DC>(o.A + s * DC * L + ro * L, o.hcl + u * DC * L + co * L,
                      o.hcc + s * DC * DC, o.gred + s * DC, u == s, g == hc,
                      dense, rg, cg, ro, co, acc);
  }
  team.sum(acc);
  if (team.leader())
    for (int i = 0; i < PART; ++i) part[(long long)k * PART + i] = acc[i];
}

// entry i of rows [k0, k1) of part, added in order, CHUNK loads at a
// time in flight (an absent row adds 0)
LM_FN float sum_rows(const float* part, int k0, int k1, int i) {
  float x = 0.f;
  for (int c = k0; c < k1; c += CHUNK) {
    float v[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      v[j] = c + j < k1 ? load_nc(part + (long long)(c + j) * PART + i) : 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) x += v[j];
  }
  return x;
}

// chunk c: its shares' partials added in order into part2[c], an entry a
// lane (the lanes read a share's partials side by side)
template <class Team>
LM_FN void assemble_chunk(const PairIndex& px, const float* part, int c,
                          Team& team, float* part2) {
  const int b = px.chunk_block[c];
  const int k0 = px.share_ptr[b] + (c - px.chunk_ptr[b]) * CHUNK;
  const int k1 = k0 + CHUNK < px.share_ptr[b + 1] ? k0 + CHUNK
                                                   : px.share_ptr[b + 1];
  for (int i = team.rank(); i < PART; i += team.size())
    part2[(long long)c * PART + i] = sum_rows(part, k0, k1, i);
}

// block b: its chunks' partials added in order, an entry a lane; writes
// Hp's block (when dense) and, on a diagonal block, g and diag0 of its
// group; a block without pairs writes 0
template <class Team>
LM_FN void assemble_gather(const Inputs& in, const PairIndex& px,
                           const float* part2, int G, bool dense, int D,
                           int b, Team& team, float* Hp, float* gv,
                           float* diag0) {
  const int I = in.I;
  const int g = dense ? b / G : b, hc = dense ? b % G : b;
  const int rg = group_size(g, I), cg = group_size(hc, I);
  const int rb = group_base(g, I), cb = group_base(hc, I);
  for (int i = team.rank(); i < PART; i += team.size()) {
    const float x = sum_rows(part2, px.chunk_ptr[b], px.chunk_ptr[b + 1], i);
    if (i < 36) {
      const int r = i / 6, q = i - 6 * (i / 6);
      if (dense && r < rg && q < cg) Hp[(long long)(rb + r) * D + cb + q] = x;
    } else if (g == hc) {
      const int r = (i - 36) % 6;
      if (r < rg) (i < 42 ? gv : diag0)[rb + r] = x;
    }
  }
}

// ------------------------- O, stage 2 of the first design: a block (g, h)
// (the yardstick hybrid_terms_scan) writes Hp's block (g, h) (when dense)
// and, when g == h, g and diag0 of group g
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

// ------------------------- P, the product's stage 1: a track's y, then
// each weighted support's contribution to its groups' entries
// Every lane holds the track's sum after the butterfly, so every lane
// computes y_t as apply_track's leader does (the same bits) and the
// leader writes it.  Then each lane, for its own weighted supports,
// writes c_s[p] = sum_q H_cc[s][p, q] v[col_q] - sum_a H_cl[s][p, a] y_t[a]
// for every p < Dc: the terms apply_share adds, with its expressions and
// order (a1 over q, a2 over a), so that stage 2 adds the same floats.
template <int L, int DC, class Team>
LM_FN void contrib_track(const Inputs& in, const Factors& o, const float* v,
                         int t, Team& team, float* y, float* contrib) {
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
  float yt[L];
#pragma unroll
  for (int a = 0; a < L; ++a) {
    float x = 0.f;
#pragma unroll
    for (int b = 0; b < L; ++b) x += o.hinv[(t * L + a) * L + b] * acc[b];
    yt[a] = x;
  }
  if (team.leader())
#pragma unroll
    for (int a = 0; a < L; ++a) y[t * L + a] = yt[a];
  for (int s = team.rank(); s < in.S; s += team.size()) {
    const long long ts = (long long)t * in.S + s;
    if (!(in.w[ts] > 0.f)) continue;
    const float* hcl = o.hcl + ts * DC * L;
    const float* hcc = o.hcc + ts * DC * DC;
    float vc[DC];
#pragma unroll
    for (int q = 0; q < DC; ++q) vc[q] = v[col_of(in, ts, q)];
#pragma unroll
    for (int p = 0; p < DC; ++p) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int q = 0; q < DC; ++q) a1 += hcc[p * DC + q] * vc[q];
#pragma unroll
      for (int a = 0; a < L; ++a) a2 += hcl[p * L + a] * yt[a];
      contrib[ts * DC + p] = a1 - a2;
    }
  }
}

// ------------------- P, the product's stage 2: share k of group g from
// the contributions, as apply_share cuts and adds it (the same bounds,
// lane stride and butterfly), into acc
template <int DC, class Team>
LM_FN void contrib_share(const Inputs& in, const Index& ix,
                         const float* contrib, int g, int k, Team& team,
                         float (&acc)[6]) {
  const int rg = group_size(g, in.I), ro = group_off(g, in.I);
  const int first = ix.grp_ptr[g], n = ix.grp_ptr[g + 1] - first;
  const int per = (n + SPLIT - 1) / SPLIT;
  const int lo = first + k * per;
  const int hi = lo + per < first + n ? lo + per : first + n;
#pragma unroll
  for (int p = 0; p < 6; ++p) acc[p] = 0.f;
  for (int e = lo + team.rank(); e < hi; e += team.size()) {
    const float* c = contrib + (long long)ix.inc[e] * DC + ro;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (p >= rg) break;
      acc[p] += c[p];
    }
  }
  team.sum(acc);
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

// assemble_share on the card: each round of 32 pairs (a pair a lane, as
// there) first stages the rows it reads, group g's of A[s] and group h's
// of H_cl[u], in shared memory with 8-byte loads spread over the warp
// (a lane's own row gathered by scalar loads took 32 L1 wavefronts a
// load instruction), then each lane adds its pair from there
constexpr int SROW = 25;  // floats a staged row: at most 6 x 4, odd

template <int L, int DC>
__global__ void __launch_bounds__(32 * WARPS)
    share_kernel(Inputs in, PairIndex px, Factors o, int G, int dense,
                 int n_shares, float* part) {
  __shared__ float sa[WARPS][32][SROW], sb[WARPS][32][SROW];
  __shared__ int ss[WARPS][32], su[WARPS][32];
  const int k = warp_id();
  if (k >= n_shares) return;  // a whole warp
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int I = in.I;
  const int b = px.share_block[k];
  const int g = dense ? b / G : b, hc = dense ? b % G : b;
  const int rg = group_size(g, I), ro = group_off(g, I);
  const int cg = group_size(hc, I), co = group_off(hc, I);
  const int na = rg * L / 2, nb = cg * L / 2;  // float2 a staged row
  const int p0 = px.share_first[k], p1 = px.share_first[k + 1];
  float acc[PART];
#pragma unroll
  for (int i = 0; i < PART; ++i) acc[i] = 0.f;
  for (int base = p0; base < p1; base += 32) {
    const int n = min(32, p1 - base);
    const bool have = lane < n;
    const int s = have ? px.pair_s[base + lane] : 0;
    const int u = have ? px.pair_u[base + lane] : 0;
    ss[w][lane] = s;
    su[w][lane] = u;
    __syncwarp();
    for (int i = lane; i < n * na; i += 32) {
      const int j = i / na, c = 2 * (i - j * na);
      const float2 v = *reinterpret_cast<const float2*>(
          o.A + (long long)ss[w][j] * DC * L + ro * L + c);
      sa[w][j][c] = v.x;
      sa[w][j][c + 1] = v.y;
    }
    for (int i = lane; i < n * nb; i += 32) {
      const int j = i / nb, c = 2 * (i - j * nb);
      const float2 v = *reinterpret_cast<const float2*>(
          o.hcl + (long long)su[w][j] * DC * L + co * L + c);
      sb[w][j][c] = v.x;
      sb[w][j][c + 1] = v.y;
    }
    __syncwarp();
    if (have)
      pair_terms<L, DC>(sa[w][lane], sb[w][lane],
                        o.hcc + (long long)s * DC * DC,
                        o.gred + (long long)s * DC, u == s, g == hc, dense,
                        rg, cg, ro, co, acc);
    __syncwarp();
  }
  lm::WarpTeam team{lane};
  team.sum(acc);
  if (team.leader())
    for (int i = 0; i < PART; ++i) part[(long long)k * PART + i] = acc[i];
}

__global__ void __launch_bounds__(32 * WARPS)
    chunk_kernel(PairIndex px, const float* part, int n_chunks,
                 float* part2) {
  const int c = warp_id();
  if (c >= n_chunks) return;
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  assemble_chunk(px, part, c, team, part2);
}

__global__ void __launch_bounds__(32 * WARPS)
    gather_kernel(Inputs in, PairIndex px, const float* part2, int G,
                  int dense, int D, float* Hp, float* gv, float* diag0) {
  const long long b = warp_id();
  if (b >= (dense ? (long long)G * G : G)) return;
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  assemble_gather(in, px, part2, G, dense, D, (int)b, team, Hp, gv, diag0);
}

// the first design's stage 2, a warp a block (the yardstick)
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

// P's first design (the yardstick hybrid_apply_scan): stage 1 over the
// tracks, then (the product) stage 2 over the shares of the groups and,
// after another barrier, over the groups.  stages (to time a part
// alone): STAGE1 the tracks, BARRIER the two grid barriers, STAGE2 the
// shares and the groups
constexpr int STAGE1 = 1, BARRIER = 2, STAGE2 = 4;

template <int L, int DC>
__global__ void __launch_bounds__(32 * WARPS)
    apply_kernel(Inputs in, Index ix, Factors o, const float* v, int backsub,
                 float* y, int G, float* part, float* out, int stages) {
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  const int nw = gridDim.x * WARPS;
  if (stages & STAGE1)
    for (int t = warp_id(); t < in.T; t += nw)
      apply_track<L, DC>(in, o, v, backsub, t, team, y);
  if (backsub) return;
  auto grid = cooperative_groups::this_grid();
  if (stages & BARRIER) grid.sync();
  if (stages & STAGE2)
    for (int u = warp_id(); u < G * SPLIT; u += nw)
      apply_share<L, DC>(in, ix, o, v, y, u / SPLIT, u % SPLIT, team, part);
  if (stages & BARRIER) grid.sync();
  if (stages & STAGE2)
    for (int g = warp_id(); g < G; g += nw)
      apply_gather(in, part, g, team, out);
}

// P: one kind of track and its buffers
struct ApplyKind {
  Inputs in;
  Index ix;
  Factors o;
  float* y;        // [T, L]
  float* contrib;  // [T, S, Dc] (the product)
  int L;
};

// P, the product, one cooperative launch: stage 1, a warp a track (the
// kinds' tracks in order), writing y and the contributions; a grid
// barrier; stage 2, a group a block, warp k its share k of each kind,
// and the first threads add the SPLIT shares in order, a kind at a
// time, and write out = line sum + point sum (the sum of two products as
// torch adds them).  With backsub, stage 1 alone writes -y (apply_track,
// as the first design).  stages as apply_kernel's (to time a part
// alone).  Two ordinary launches in place of the barrier were tried and
// were no faster.
template <int DC>
__global__ void __launch_bounds__(32 * SPLIT)
    product_kernel(ApplyKind k0, ApplyKind k1, int nk, const float* v,
                   int backsub, int G, float* out, int stages) {
  __shared__ float part[2][SPLIT][6];
  const int w = threadIdx.x >> 5;
  lm::WarpTeam team{(int)(threadIdx.x & 31)};
  if (stages & STAGE1) {
    const int T0 = k0.in.T, T = T0 + (nk > 1 ? k1.in.T : 0);
    for (int u = blockIdx.x * SPLIT + w; u < T; u += gridDim.x * SPLIT) {
      const ApplyKind& k = u < T0 ? k0 : k1;
      const int t = u < T0 ? u : u - T0;
      if (backsub) {
        if (k.L == 4)
          apply_track<4, DC>(k.in, k.o, v, true, t, team, k.y);
        else
          apply_track<3, DC>(k.in, k.o, v, true, t, team, k.y);
      } else if (k.L == 4) {
        contrib_track<4, DC>(k.in, k.o, v, t, team, k.y, k.contrib);
      } else {
        contrib_track<3, DC>(k.in, k.o, v, t, team, k.y, k.contrib);
      }
    }
  }
  if (backsub) return;
  if (stages & BARRIER) cooperative_groups::this_grid().sync();
  if (!(stages & STAGE2)) return;
  const int I = k0.in.I;
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    for (int kk = 0; kk < nk; ++kk) {
      float acc[6];
      contrib_share<DC>(kk ? k1.in : k0.in, kk ? k1.ix : k0.ix,
                        kk ? k1.contrib : k0.contrib, g, w, team, acc);
      if (team.leader())
#pragma unroll
        for (int p = 0; p < 6; ++p) part[kk][w][p] = acc[p];
    }
    __syncthreads();
    const int p = threadIdx.x;
    if (p < group_size(g, I)) {
      float x0 = 0.f, x1 = 0.f;
      for (int k = 0; k < SPLIT; ++k) x0 += part[0][k][p];
      if (nk > 1)
        for (int k = 0; k < SPLIT; ++k) x1 += part[1][k][p];
      out[group_base(g, I) + p] = nk > 1 ? x0 + x1 : x0;
    }
    __syncthreads();
  }
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

// stages: 1 stage 1, 2 stage 2, 3 both; scan: the first design's stage 2
template <int KIND, int DC>
int launch_terms(const Inputs& in, const Hyper& h, const Index& ix,
                 const PairIndex& px, const Factors& o, int dense,
                 int n_shares, int n_chunks, int stages, int scan,
                 float* part, float* part2, float* Hp, float* gv,
                 float* diag0, cudaStream_t st) {
  constexpr int L = KindDims<KIND>::L;
  if (stages & 1)
    terms_kernel<KIND, DC><<<blocks_for(in.T), 32 * WARPS, 0, st>>>(in, h,
                                                                    o);
  if (!(stages & 2)) return (int)cudaGetLastError();
  const int G = in.I + (DC == 8 ? in.C : 0);
  const int D = 6 * in.I + (DC == 8 ? 2 * in.C : 0);
  const long long n = dense ? (long long)G * G : G;
  if (scan) {
    assemble_kernel<L, DC><<<blocks_for(n), 32 * WARPS, 0, st>>>(
        in, ix, o, G, dense, Hp, gv, diag0);
    return (int)cudaGetLastError();
  }
  if (n_shares) {
    share_kernel<L, DC><<<blocks_for(n_shares), 32 * WARPS, 0, st>>>(
        in, px, o, G, dense, n_shares, part);
    chunk_kernel<<<blocks_for(n_chunks), 32 * WARPS, 0, st>>>(px, part,
                                                             n_chunks, part2);
  }
  gather_kernel<<<blocks_for(n), 32 * WARPS, 0, st>>>(in, px, part2, G,
                                                      dense, D, Hp, gv,
                                                      diag0);
  return (int)cudaGetLastError();
}

// The blocks of ``kernel`` (``threads`` a block) resident at once on the
// current device, queried once a kernel, device and process.
int resident_blocks(const void* kernel, int threads) {
  struct Entry {
    const void* kernel;
    int dev, blocks;
  };
  static Entry cache[64];
  static int n_cached = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev)
      return cache[i].blocks;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int blocks = sms * per_sm;
  if (n_cached < 64 && blocks > 0) cache[n_cached++] = {kernel, dev, blocks};
  return blocks;
}

// a cooperative launch of ``kernel`` with one warp a unit of ``warps``,
// at most as many blocks as are resident at once
template <typename K, typename... Args>
int launch_coop(K kernel, long long warps, cudaStream_t st, Args... args) {
  const long long most = resident_blocks((const void*)kernel, 32 * WARPS);
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
                 float* out, int stages, cudaStream_t st) {
  const int G = in.I + (DC == 8 ? in.C : 0);
  const long long warps = in.T > G * SPLIT ? in.T : G * SPLIT;
  const int err = launch_coop(apply_kernel<L, DC>, warps, st, in, ix, o, v,
                              backsub, y, G, part, out, stages);
  return err ? err : (int)cudaGetLastError();
}

// P in the new design: one cooperative launch, as many blocks as the
// larger stage takes (a warp a track, a block a group; the
// back-substitution is stage 1 alone), at most as many as are resident
// at once.
template <int DC>
int launch_product(const ApplyKind& k0, const ApplyKind& k1, int nk,
                   const float* v, int backsub, int G, float* out,
                   int stages, cudaStream_t st) {
  constexpr int THREADS = 32 * SPLIT;
  const long long T = k0.in.T + (nk > 1 ? k1.in.T : 0);
  long long blocks = (T + SPLIT - 1) / SPLIT;
  if (!backsub && G > blocks) blocks = G;
  const long long most =
      resident_blocks((const void*)product_kernel<DC>, THREADS);
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  void* ptrs[] = {(void*)&k0, (void*)&k1, (void*)&nk, (void*)&v,
                  (void*)&backsub, (void*)&G, (void*)&out, (void*)&stages};
  const int err = (int)cudaLaunchCooperativeKernel(
      (const void*)product_kernel<DC>, dim3((unsigned)blocks), dim3(THREADS),
      ptrs, 0, st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// O.  p: land, pose, fxfy, kvec, cam, img, obs, w, grp_ptr, inc,
// sorted_img, sorted_pos, hinv, bl, hcl, A, hcc, gred, cost [T], Hp (null
// unless dense), g, diag0, hll, pair_ptr, pair_s, pair_u, share_ptr,
// share_block, part [NS * PART], chunk_ptr, chunk_block, part2 [NC *
// PART], share_first.  n: kind, focal, T, S, I, C, loss, const_pose,
// const_land,
// dense, NS, stages (1, 2 or 3), scan (the first design's stage 2), NC.
// f: alpha, loss scale, loss scale^2, sqrt(lw_point), lam.
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
  PairIndex px{(const int*)p[23], (const int*)p[24], (const int*)p[25],
               (const int*)p[26], (const int*)p[27], (const int*)p[29],
               (const int*)p[30], (const int*)p[32]};
  float *part = (float*)p[28], *part2 = (float*)p[31];
  Hyper h{f[0], f[1], f[2], f[3], f[4], (int)n[6], (int)n[7], (int)n[8]};
  float *Hp = (float*)p[19], *gv = (float*)p[20], *diag0 = (float*)p[21];
  const int dense = (int)n[9], n_shares = (int)n[10], stages = (int)n[11],
            scan = (int)n[12], n_chunks = (int)n[13];
  auto st = (cudaStream_t)stream;
#define HBA_TERMS(KIND, DC)                                                   \
  launch_terms<KIND, DC>(in, h, ix, px, o, dense, n_shares, n_chunks,      \
                         stages, scan, part, part2, Hp, gv, diag0, st)
  if (n[0] == LINE) return n[1] ? HBA_TERMS(LINE, 8) : HBA_TERMS(LINE, 6);
  return n[1] ? HBA_TERMS(POINT, 8) : HBA_TERMS(POINT, 6);
#undef HBA_TERMS
}

// P's first design (the yardstick).  p: img, cam, w, hinv, bl, hcl, hcc,
// v, y [T, L], grp_ptr, inc, out and part [G * SPLIT * 6] (both null for
// the back-substitution).  n: kind, focal, T, S, I, C, backsub, stages.
extern "C" int hybrid_apply_scan_launch(void** p, const long long* n,
                                        const float*, void* stream) {
  Inputs in{nullptr, nullptr, nullptr, nullptr, (const int*)p[1],
            (const int*)p[0], nullptr, (const float*)p[2], (int)n[2],
            (int)n[3], (int)n[4], (int)n[5]};
  Index ix{(const int*)p[9], (const int*)p[10], nullptr, nullptr};
  Factors o{(float*)p[3], (float*)p[4], (float*)p[5], nullptr,
            (float*)p[6], nullptr, nullptr, nullptr};
  const float* v = (const float*)p[7];
  float *y = (float*)p[8], *out = (float*)p[11], *part = (float*)p[12];
  const int backsub = (int)n[6], stages = (int)n[7];
  auto st = (cudaStream_t)stream;
#define HBA_APPLY(L, DC) \
  launch_apply<L, DC>(in, ix, o, v, backsub, y, part, out, stages, st)
  if (n[0] == LINE) return n[1] ? HBA_APPLY(4, 8) : HBA_APPLY(4, 6);
  return n[1] ? HBA_APPLY(3, 8) : HBA_APPLY(3, 6);
#undef HBA_APPLY
}

// P.  n: nk (1, or 2 for lines then points), focal, I, C, backsub,
// stages, then per kind: kind, T, S.  p: v, out ([D]; null for the
// back-substitution), then per kind: img, cam, w, hinv, bl, hcl, hcc,
// y [T, L], grp_ptr, inc, contrib [T, S, Dc] (null for the
// back-substitution).
extern "C" int hybrid_apply_launch(void** p, const long long* n,
                                   const float*, void* stream) {
  const int nk = (int)n[0], focal = (int)n[1], I = (int)n[2],
            C = (int)n[3];
  ApplyKind k[2] = {};
  for (int i = 0; i < nk; ++i) {
    void** q = p + 2 + 11 * i;
    const long long* m = n + 6 + 3 * i;
    k[i].in = Inputs{nullptr, nullptr, nullptr, nullptr, (const int*)q[1],
                     (const int*)q[0], nullptr, (const float*)q[2],
                     (int)m[1], (int)m[2], I, C};
    k[i].ix = Index{(const int*)q[8], (const int*)q[9], nullptr, nullptr};
    k[i].o = Factors{(float*)q[3], (float*)q[4], (float*)q[5], nullptr,
                     (float*)q[6], nullptr, nullptr, nullptr};
    k[i].y = (float*)q[7];
    k[i].contrib = (float*)q[10];
    k[i].L = m[0] == LINE ? 4 : 3;
  }
  const int G = I + (focal ? C : 0);
  const float* v = (const float*)p[0];
  float* out = (float*)p[1];
  const int backsub = (int)n[4], stages = (int)n[5];
  auto st = (cudaStream_t)stream;
  return focal ? launch_product<8>(k[0], k[1], nk, v, backsub, G, out,
                                   stages, st)
               : launch_product<6>(k[0], k[1], nk, v, backsub, G, out,
                                   stages, st);
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
