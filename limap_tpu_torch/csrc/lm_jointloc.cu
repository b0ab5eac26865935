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
// Bound: operations.  Per (row, iteration, masked match) one Jet<6>
// residual (7 lanes of each operation) with its products and sums, and
// one float residual for the new cost.  See testing/lm_checks.py for the
// counts.  What sets the time is latency: a solve is 50 serial
// iterations, each a pass over a chain's active matches (on the LO's
// chains 9 to ~860) and a team sum.
//
// The kernel (lm_jointloc_kernel), a block a chain:
//   A.1 the chain's active matches are compacted once a solve: the team
//       counts its threads' active matches, places them by a prefix sum
//       over the threads and stages their data in shared memory (10
//       floats a line, 5 a point; their indices past 227 KB, and past
//       ~57,000 matches the indices go to a global scratch), so every
//       pass runs over the active matches only.  BALANCED deals them
//       round robin, the lines on the first warps and the points on the
//       others where that lowers the slowest lane's cost (a line costs
//       2-4 points by cost function; a warp's lanes wait for its slowest,
//       the block for its slowest warp); OWNER keeps the first design's
//       distribution (match i on thread i mod S), each thread's matches
//       in its order.
//   A.2 each chain picks its team from its compacted counts: a warp (no
//       block barrier) while it holds 4 active matches a lane, else 4
//       warps while they hold 2 a lane, else 8 (ops/lm_jointloc.py::
//       team_for, from the sweep of testing/loc_kernels.py); the block's
//       other warps leave, and the team's barrier counts its own
//       threads.  The block is as wide as the launch's shapes need, so
//       nothing of the masks, and not the camera, comes to the host
//       before the launch.
//   A.3 one pass and one sum an iteration: the plain loop builds the
//       normal equations at the parameters, solves, retracts and compares
//       the cost at the trial point; here one pass at the trial point
//       gives both its float cost and its Jet normal equations, summed in
//       one team sum of 29 terms.  On an accepted step they are the next
//       iteration's; on a rejected one the current ones stay (the plain
//       loop rebuilds them at the same parameters, to the same bits).
//       The trial cost sums the Jets' values, which are the float
//       residuals bit for bit (no contraction); the last iteration's pass
//       evaluates the float residuals alone.
// With OWNER and 256 threads every thread's partial sums add the first
// design's terms in its order (masked matches add nothing), so the
// trajectory is the first design's bit for bit.  For that the file is
// built with -fmad=false (ops/cuda_build.py): nvcc contracts products
// and sums into FMAs by the inlining context, so the same residual
// inlined into the two kernels rounded differently (8 of the 10 seeded
// configurations parted); without contraction each operation rounds
// alone, as the plain version's eager ones do.  (Calling one
// __noinline__ copy from both kernels also kept the bits, at 35-45 % more
// time an iteration: its structs went through local memory.)
//
// The path's kernel takes no option of timing or holding: the holding
// variant (OWNER, the team fixed) is an instance of its own, and the
// variants that leave a part out are built only into the timing library
// (-DLM_JOINTLOC_PARTS, ops/lm_jointloc.py::launch_parts).
//
// lm_jointloc_scan_kernel is the first design, kept as the yardstick: a
// block of 256 threads a chain runs lm_common.cuh::lm_row, two passes
// over every match (masked ones skipped) and two block sums an
// iteration.  Rebuilt with this file's -fmad=false, it is slower than
// the same code was as the path's kernel, built with contraction
// (PERF.md gives both).  Only I runs the fused loop: kernels H, K, L and M keep
// lm_row, since a PR redesigns two kernels and their gates hold the bits
// lm_row gives.

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
// the parts of an iteration (the launches' ``stages``, to time a part
// alone): the normal-equation pass and its sum, the cost pass and its
// sum, the solve and retraction (the fused kernel's one pass is both
// passes, its one sum both sums; the first design always solves)
enum Stage { STAGE_NE_PASS = 1, STAGE_NE_SUM = 2, STAGE_COST_PASS = 4,
             STAGE_COST_SUM = 8, STAGE_SOLVE = 16, STAGES_ALL = 31 };

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

  // the line block before weighting, of the line with 3D endpoints A, B
  // and 2D endpoints a2, b2: returns R_l
  template <typename T>
  LM_FN int line_res(const Pose<T>& P, const float* A, const float* B,
                     const float* a2, const float* b2, T (&r)[4]) const {
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

  // the weighted blocks of a line and of a point (3D X, 2D x): the size
  template <typename T>
  LM_FN int line_block(const Pose<T>& P, const float* A, const float* B,
                       const float* a2, const float* b2, T (&r)[4]) const {
    const int R = line_res(P, A, B, a2, b2, r);
    weigh(r, R, wline);
    return R;
  }
  template <typename T>
  LM_FN int point_block(const Pose<T>& P, const float* X, const float* x2,
                        T (&r)[4]) const {
    const V2<T> x = project(P, X);
    r[0] = x.x - x2[0];
    r[1] = x.y - x2[1];
    weigh(r, 2, wpoint);
    return 2;
  }

  // match i's weighted block (lines first, then points): its size, 0
  // where the row masks the match
  template <typename T>
  LM_FN int block(const Pose<T>& P, int i, T (&r)[4]) const {
    if (i < nl) {
      if (!lmask[i]) return 0;
      return line_block(P, l3s + 3 * i, l3e + 3 * i, l2s + 2 * i,
                        l2e + 2 * i, r);
    }
    i -= nl;
    if (!pmask[i]) return 0;
    return point_block(P, p3 + 3 * i, p2 + 2 * i, r);
  }

  LM_FN void retract(const float (&p)[7], const float (&delta)[6],
                     float (&out)[7]) const {
    lm::retract_pose(p, delta, out);
  }

  // the pose at p with its Jacobian through the retraction at delta = 0,
  // and the pose at p
  LM_FN Pose<Jet<6>> jet_pose(const float (&p)[7]) const {
    Jet<6> delta[6], jp[7];
#pragma unroll
    for (int k = 0; k < 6; ++k) delta[k] = lm::jet_basis<6>(k);
    lm::retract_pose(p, delta, jp);
    return pose(jp);
  }
  LM_FN Pose<float> float_pose(const float (&p)[7]) const {
    return pose(p);
  }
};

// The first design's two passes for lm_common.cuh::lm_row, over every
// match (masked ones skipped), with the parts STAGES (Stage) run: the
// path's yardstick runs STAGES_ALL, the timing build the others.
template <int STAGES>
struct JointLocScan : JointLoc {
  template <class Team>
  LM_FN void normal_equations(Team& team, const float (&p)[7],
                              float (&acc)[lm::NE<6>::N]) const {
    const Pose<Jet<6>> P = jet_pose(p);
#pragma unroll
    for (int k = 0; k < lm::NE<6>::N; ++k) acc[k] = 0.f;
    if (STAGES & STAGE_NE_PASS)
      for (int i = team.rank(); i < nl + np; i += team.size()) {
        Jet<6> r[4];
        const int R = block(P, i, r);
        for (int k = 0; k < R; ++k) lm::accumulate(acc, r[k]);
      }
    if (STAGES & STAGE_NE_SUM) team.sum(acc);
  }

  template <class Team>
  LM_FN float cost(Team& team, const float (&p)[7]) const {
    const Pose<float> P = float_pose(p);
    float c = 0.f;
    if (STAGES & STAGE_COST_PASS)
      for (int i = team.rank(); i < nl + np; i += team.size()) {
        float r[4];
        const int R = block(P, i, r);
        for (int k = 0; k < R; ++k) c += r[k] * r[k];
      }
    return STAGES & STAGE_COST_SUM ? team.sum1(c) : c;
  }
};

}  // namespace

// The kernels and their launches; what precedes compiles as host C++ too.
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

struct Args {
  const float *params0, *l3s, *l3e, *l2s, *l2e, *p3, *p2;
  const uint8_t *lmask, *pmask;
  int T, nl, np, cf, wt, loss;
  float alpha, scale, scale2, wline, wpoint;
  lm::LMParams lp;
  float *params, *cost0, *cost;
  int* n_acc;
  float *trace, *ne;
  const float* kv;  // the camera, read on the card (no copy to the host)
  // the fused kernel's: whether the active matches' data sit in shared
  // memory (else their indices), the indices' global scratch [T, nl + np]
  // where they do not fit in shared memory either (else null), and where
  // each chain's team goes (may be null)
  int staged;
  int* idx;
  int* team_out;
};

__device__ JointLoc problem(const Args& a, int row) {
  return JointLoc{a.l3s, a.l3e, a.l2s, a.l2e, a.p3, a.p2,
                  a.lmask + (long long)row * a.nl,
                  a.pmask + (long long)row * a.np, a.nl, a.np,
                  a.kv[0], a.kv[1], a.kv[2], a.kv[3], a.cf, a.wt, a.loss,
                  a.alpha, a.scale, a.scale2, a.wline, a.wpoint};
}

constexpr int THREADS = 256;  // the first design's block; the largest team
constexpr int MAX_WARPS = THREADS / 32;
constexpr int TRI = lm::NE<6>::TRI;
constexpr int NNE = lm::NE<6>::N;  // the normal-equation terms
constexpr int NS = NNE + 1;        // and the cost: the fused sum
constexpr unsigned FULL = 0xffffffffu;
// a chain's team (ops/lm_jointloc.py::chain_team): a warp while it holds
// WARP_ITEMS active matches a lane, else 4 warps while they hold
// BLOCK_ITEMS a lane, else 8 (2 warps would take the chains of 65-128
// matches, which one warp takes at WARP_ITEMS)
constexpr int WARP_ITEMS = 4, BLOCK_ITEMS = 2;
LM_FN int team_warps(int active) {
  return active <= 32 * WARP_ITEMS ? 1
         : active <= 128 * BLOCK_ITEMS ? 4 : MAX_WARPS;
}
// a line's pass against a point's, by cost function (Cost): the ratio of
// their operation counts (testing/lm_checks.py::ops_jointloc), rounded
LM_FN int line_cost(int cf) {
  return cf <= MIDPOINT_ANGLE3 ? 2 : (cf <= PERP4 ? 3 : 4);
}

// ------------------------------------------------- the first design
template <int STAGES>
__global__ void __launch_bounds__(THREADS) lm_jointloc_scan_kernel(Args a) {
  __shared__ float scratch[(THREADS / 32) * NNE];
  const int row = blockIdx.x;
  JointLocScan<STAGES> pb;
  static_cast<JointLoc&>(pb) = problem(a, row);
  lm::BlockTeam<NNE> team{scratch, (int)threadIdx.x, (int)blockDim.x};
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

// ------------------------------------------------------ the kernel
// OWNER: match i (lines first, then points) on thread i mod S of a team
// of S threads, the first design's distribution; BALANCED: the chain's
// active matches in index order dealt round robin
enum Order { OWNER = 0, BALANCED = 1 };

// One chain's team: its S = blockDim.x threads (a warp, or up to 8), its
// compacted matches and its sums.
struct Team {
  float* scratch;  // [MAX_WARPS * NS], the block sum's
  int tid, S;
  // this thread's items in the compacted lists: lines q = l0, l0 + ls, ...
  // < l1, points likewise
  int l0, l1, ls, p0, p1, ps;

  LM_FN bool leader() const { return tid == 0; }
  // the team's S threads, the first of the block (the others may have left)
  __device__ void barrier() const {
    asm volatile("bar.sync 1, %0;" ::"r"(S) : "memory");
  }
  // a warp: lm::WarpTeam's sum; more: lm::BlockTeam's (the same butterflies,
  // then the warps' partials in warp order) over the team's barrier
  template <int N>
  __device__ void sum(float (&a)[N]) {
    if (S == 32) {
      lm::WarpTeam w{tid};
      w.sum(a);
      return;
    }
    const int lane = tid & 31, warp = tid >> 5, nw = S >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a[k] += __shfl_xor_sync(FULL, a[k], off);
    barrier();
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) scratch[warp * NS + k] = a[k];
    barrier();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = scratch[k];
      for (int w = 1; w < nw; ++w) s += scratch[w * NS + k];
      a[k] = s;
    }
  }
};

// exclusive prefix sums over the team's threads, in thread order, of two
// counts, and their totals (``tot``: 2 MAX_WARPS ints of shared memory)
__device__ void team_scan2(const Team& tm, int* tot, int& a, int& b,
                           int& ta, int& tb) {
  const int lane = tm.tid & 31, warp = tm.tid >> 5, nw = tm.S >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int xa = __shfl_up_sync(FULL, ia, off);
    const int xb = __shfl_up_sync(FULL, ib, off);
    if (lane >= off) {
      ia += xa;
      ib += xb;
    }
  }
  int oa = ia - a, ob = ib - b;
  ta = __shfl_sync(FULL, ia, 31);
  tb = __shfl_sync(FULL, ib, 31);
  if (nw > 1) {
    if (lane == 31) {
      tot[warp] = ia;
      tot[MAX_WARPS + warp] = ib;
    }
    __syncthreads();
    ta = tb = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) {
        oa += tot[w];
        ob += tot[MAX_WARPS + w];
      }
      ta += tot[w];
      tb += tot[MAX_WARPS + w];
    }
  }
  a = oa;
  b = ob;
}

// The shared memory of a chain: the sum's scratch, the scan's totals,
// then the compacted lines and points (staged: 10 floats a line, A, B, a2,
// b2, and 5 a point, X, x2; else their indices, in shared memory or in
// the launch's global scratch).
struct Staged {
  float* L;
  float* P;
  int* Li;
  int* Pi;
};

// One pass over the team's share of the compacted matches at p: the Jet
// residuals' normal-equation terms into acc[0, NNE) when ``jet``, and the
// cost into acc[NNE] (each as the first design's passes accumulate them,
// in this thread's item order).  With ``jet`` the cost sums the Jets'
// values: without contraction (-fmad=false) a Jet's value is computed by
// the same operations as the float residual, so it is that residual bit
// for bit, and the float evaluation is left out but at the last
// iteration.  STAGES (Stage) leaves out a pass for the timing build.
template <int STAGES>
__device__ void fused_pass(const JointLoc& pb, const Args& a,
                           const Team& tm, const Staged& st,
                           const float (&p)[7], bool jet,
                           float (&acc)[NS]) {
  using lm::Jet;
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.f;
  const bool do_jet = jet && (STAGES & STAGE_NE_PASS);
  constexpr bool do_flt = STAGES & STAGE_COST_PASS;
  Pose<Jet<6>> PJ;
  if (do_jet) PJ = pb.jet_pose(p);
  Pose<float> PF;
  if (!do_jet) PF = pb.float_pose(p);
  float c = 0.f;
  for (int q = tm.l0; q < tm.l1; q += tm.ls) {
    const float *A, *B, *a2, *b2;
    if (a.staged) {
      A = st.L + 10 * q;
      B = A + 3;
      a2 = A + 6;
      b2 = A + 8;
    } else {
      const int i = st.Li[q];
      A = a.l3s + 3 * i;
      B = a.l3e + 3 * i;
      a2 = a.l2s + 2 * i;
      b2 = a.l2e + 2 * i;
    }
    if (do_jet) {
      Jet<6> r[4];
      const int R = pb.line_block(PJ, A, B, a2, b2, r);
      for (int k = 0; k < R; ++k) lm::accumulate(acc, r[k]);
      if (do_flt)
        for (int k = 0; k < R; ++k) c += r[k].v * r[k].v;
    } else if (do_flt) {
      float r[4];
      const int R = pb.line_block(PF, A, B, a2, b2, r);
      for (int k = 0; k < R; ++k) c += r[k] * r[k];
    }
  }
  for (int q = tm.p0; q < tm.p1; q += tm.ps) {
    const float *X, *x2;
    if (a.staged) {
      X = st.P + 5 * q;
      x2 = X + 3;
    } else {
      const int j = st.Pi[q];
      X = a.p3 + 3 * j;
      x2 = a.p2 + 2 * j;
    }
    if (do_jet) {
      Jet<6> r[4];
      const int R = pb.point_block(PJ, X, x2, r);
      for (int k = 0; k < R; ++k) lm::accumulate(acc, r[k]);
      if (do_flt)
        for (int k = 0; k < R; ++k) c += r[k].v * r[k].v;
    } else if (do_flt) {
      float r[4];
      const int R = pb.point_block(PF, X, x2, r);
      for (int k = 0; k < R; ++k) c += r[k] * r[k];
    }
  }
  acc[NNE] = c;
}

// A chain a block of S = blockDim.x threads.  The chain's active matches
// are compacted once (A.1 of the header), then every iteration runs one
// pass and one sum at the trial parameters (A.3).  The path runs
// <STAGES_ALL, BALANCED, false>: each chain picks its team (A.2).  The
// holding variant <STAGES_ALL, OWNER, true> keeps the first design's
// distribution on the block's threads; the timing build adds the others
// (a part of an iteration left out, or a BALANCED team fixed at the
// block's width).
template <int STAGES, int ORDER, bool FIXED>
__global__ void __launch_bounds__(THREADS) lm_jointloc_kernel(Args a) {
  static_assert(ORDER == BALANCED || FIXED, "OWNER deals over the block");
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const JointLoc pb = problem(a, row);
  int S = blockDim.x;
  const int t = threadIdx.x;
  Team tm{smem, t, S, 0, 0, 1, 0, 0, 1};
  int* tot = reinterpret_cast<int*>(smem + MAX_WARPS * NS);
  float* data = smem + MAX_WARPS * NS + 2 * MAX_WARPS;
  int* idx = a.idx ? a.idx + (long long)row * (a.nl + a.np)
                   : reinterpret_cast<int*>(data);
  Staged st{data, data + 10 * a.nl, idx, idx + a.nl};

  // 1. compaction: count this thread's active matches, place them
  int li0, li1, lis, pj0, pj1, pjs;
  if (ORDER == OWNER) {
    li0 = t, li1 = a.nl, lis = S;
    pj0 = ((t - a.nl) % S + S) % S, pj1 = a.np, pjs = S;
  } else {
    const int cl = (a.nl + S - 1) / S, cp = (a.np + S - 1) / S;
    li0 = min(a.nl, t * cl), li1 = min(a.nl, li0 + cl), lis = 1;
    pj0 = min(a.np, t * cp), pj1 = min(a.np, pj0 + cp), pjs = 1;
  }
  int nlt = 0, npt = 0;
  for (int i = li0; i < li1; i += lis) nlt += pb.lmask[i] != 0;
  for (int j = pj0; j < pj1; j += pjs) npt += pb.pmask[j] != 0;
  int ol = nlt, op = npt, nla, npa;
  team_scan2(tm, tot, ol, op, nla, npa);
  for (int i = li0, q = ol; i < li1; i += lis) {
    if (!pb.lmask[i]) continue;
    if (a.staged) {
      float* d = st.L + 10 * q;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d[k] = a.l3s[3 * i + k];
        d[3 + k] = a.l3e[3 * i + k];
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        d[6 + k] = a.l2s[2 * i + k];
        d[8 + k] = a.l2e[2 * i + k];
      }
    } else {
      st.Li[q] = i;
    }
    ++q;
  }
  for (int j = pj0, q = op; j < pj1; j += pjs) {
    if (!pb.pmask[j]) continue;
    if (a.staged) {
      float* d = st.P + 5 * q;
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = a.p3[3 * j + k];
#pragma unroll
      for (int k = 0; k < 2; ++k) d[3 + k] = a.p2[2 * j + k];
    } else {
      st.Pi[q] = j;
    }
    ++q;
  }
  // the chain's team (A.2): the first warps of the block, the others leave
  int nw = S >> 5;
  if (!FIXED) nw = min(nw, team_warps(nla + npa));
  if (a.team_out && t == 0) a.team_out[row] = nw;
  __syncthreads();  // the compacted matches, before any warp leaves
  if (t >= 32 * nw) return;
  S = tm.S = 32 * nw;
  if (ORDER == OWNER) {  // a fixed team: S is the block
    tm.l0 = ol, tm.l1 = ol + nlt, tm.ls = 1;
    tm.p0 = op, tm.p1 = op + npt, tm.ps = 1;
  } else {
    // the lines on the first wl warps and the points on the others where
    // that lowers the slowest lane's cost (a line costs line_cost points),
    // else both dealt round robin over the team
    const int lc = line_cost(a.cf);
    int wl = 0, best = lc * ((nla + S - 1) / S) + (npa + S - 1) / S;
    for (int w = 1; w < nw && nla && npa; ++w) {
      const int c = max(lc * ((nla + 32 * w - 1) / (32 * w)),
                        (npa + 32 * (nw - w) - 1) / (32 * (nw - w)));
      if (c < best) best = c, wl = w;
    }
    if (wl && t < 32 * wl) {
      tm.l0 = t, tm.l1 = nla, tm.ls = 32 * wl;
      tm.p0 = 0, tm.p1 = 0, tm.ps = 1;
    } else if (wl) {
      tm.l0 = 0, tm.l1 = 0, tm.ls = 1;
      tm.p0 = t - 32 * wl, tm.p1 = npa, tm.ps = S - 32 * wl;
    } else {
      tm.l0 = t, tm.l1 = nla, tm.ls = S;
      tm.p0 = ((t - nla) % S + S) % S, tm.p1 = npa, tm.ps = S;
    }
  }

  // 2. the loop: one pass and one sum an iteration
  constexpr bool SUMS = STAGES & (STAGE_NE_SUM | STAGE_COST_SUM);
  float params[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) params[i] = a.params0[7 * row + i];
  float acc[NS], ne[NNE];
  fused_pass<STAGES>(pb, a, tm, st, params, true, acc);
  if (SUMS) tm.sum(acc);
#pragma unroll
  for (int k = 0; k < NNE; ++k) ne[k] = acc[k];
  float cost = acc[NNE];
  const float cost0 = cost;
  if (a.ne && tm.leader()) {
    float* out = a.ne + (long long)row * 43;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j <= i; ++j) {
        out[i * 6 + j] = ne[i * (i + 1) / 2 + j];
        out[j * 6 + i] = ne[i * (i + 1) / 2 + j];
      }
    for (int i = 0; i < 6; ++i) out[36 + i] = ne[TRI + i];
    out[42] = ne[TRI + 6];
  }
  const lm::LMParams& lp = a.lp;
  float lam = lp.lam_init;
  int n_acc = 0;
  const int n_iter = a.ne ? 0 : lp.n_iter;
  float* trace = a.trace ? a.trace + (long long)row * lp.n_iter * 16
                         : nullptr;
  for (int it = 0; it < n_iter; ++it) {
    // the step, as lm_common.cuh::lm_row takes it
    float np[7];
    if (STAGES & STAGE_SOLVE) {
      float A[6][6], b[6], x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          A[i][j] = ne[i * (i + 1) / 2 + j];
          A[j][i] = A[i][j];
        }
        b[i] = ne[TRI + i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
        A[i][i] = A[i][i] + lam * lm::clamp_min_(A[i][i], 1e-8f);
      lm::solve_spd<6>(A, b, x);
      float delta[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) delta[i] = lm::nan_to_num(-x[i]);
      pb.retract(params, delta, np);
    } else {
#pragma unroll
      for (int i = 0; i < 7; ++i) np[i] = params[i];
    }
    // the trial cost and, but at the last iteration, the normal
    // equations at np in one pass and one sum
    const bool last = it == n_iter - 1;
    fused_pass<STAGES>(pb, a, tm, st, np, !last, acc);
    if (SUMS) {
      if (last) {
        float c[1] = {acc[NNE]};
        tm.sum(c);
        acc[NNE] = c[0];
      } else {
        tm.sum(acc);
      }
    }
    const float new_cost = acc[NNE];
    const bool accept = new_cost < cost;
    if (trace && tm.leader()) {
      float* tr = trace + it * 16;
      tr[0] = cost;
      tr[1] = new_cost;
      for (int i = 0; i < 7; ++i) {
        tr[2 + i] = params[i];
        tr[9 + i] = np[i];
      }
    }
    if (accept) {
#pragma unroll
      for (int i = 0; i < 7; ++i) params[i] = np[i];
      cost = new_cost;
      ++n_acc;
#pragma unroll
      for (int k = 0; k < NNE; ++k) ne[k] = acc[k];
    }
    lam = accept ? lam * lp.lam_down : lam * lp.lam_up;
    lam = fminf(fmaxf(lam, lp.lam_min), lp.lam_max);
  }
  if (tm.leader()) {
#pragma unroll
    for (int i = 0; i < 7; ++i) a.params[7 * row + i] = params[i];
    a.cost0[row] = cost0;
    a.cost[row] = cost;
    a.n_acc[row] = n_acc;
  }
}

Args make_args(const float* params0, const float* l3s, const float* l3e,
               const float* l2s, const float* l2e, const uint8_t* lmask,
               const float* p3, const float* p2, const uint8_t* pmask,
               long long T, long long nl, long long np, const float* kv,
               const float* hp, const long long* ip, long long n_iter,
               float* params, float* cost0, float* cost, int* n_acc,
               float* trace, float* ne) {
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
  a.kv = kv;
  a.alpha = hp[0];
  a.scale = hp[1];
  a.scale2 = hp[2];
  a.wline = hp[3];
  a.wpoint = hp[4];
  a.lp = {(int)n_iter, hp[5], hp[6], hp[7], hp[8], hp[9]};
  a.params = params;
  a.cost0 = cost0;
  a.cost = cost;
  a.n_acc = n_acc;
  a.trace = trace;
  a.ne = ne;
  a.staged = 0;
  a.idx = nullptr;
  a.team_out = nullptr;
  return a;
}

// A fused kernel's launch: a block of ``warps`` warps a chain, the
// shared memory its compaction needs (the data staged, else the indices
// unless they go to the global scratch ``idx``).
template <int STAGES, int ORDER, bool FIXED>
int launch_fused(Args a, long long warps, long long staged, int* idx,
                 int* team_out, void* stream) {
  a.staged = (int)staged;
  a.idx = staged ? nullptr : idx;
  a.team_out = team_out;
  const size_t bytes =
      sizeof(float) * (MAX_WARPS * NS + 2 * MAX_WARPS) +
      (a.staged ? sizeof(float) * (10 * (size_t)a.nl + 5 * (size_t)a.np)
       : a.idx  ? 0
                : sizeof(int) * ((size_t)a.nl + a.np));
  auto kernel = lm_jointloc_kernel<STAGES, ORDER, FIXED>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)a.T, 32 * (unsigned)warps, bytes,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int STAGES>
int launch_scan(const Args& a, void* stream) {
  lm_jointloc_scan_kernel<STAGES><<<(unsigned)a.T, THREADS, 0,
                                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define LM_JOINTLOC_ARGS                                                   \
  const float *params0, const float *l3s, const float *l3e,               \
      const float *l2s, const float *l2e, const uint8_t *lmask,           \
      const float *p3, const float *p2, const uint8_t *pmask, long long T, \
      long long nl, long long np, const float *kv, const float *hp,        \
      const long long *ip, long long n_iter, float *params, float *cost0,  \
      float *cost, int *n_acc, float *trace, float *ne
#define LM_JOINTLOC_MAKE_ARGS                                              \
  make_args(params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, T, nl, np, \
            kv, hp, ip, n_iter, params, cost0, cost, n_acc, trace, ne)

// The common arguments (LM_JOINTLOC_ARGS): kv, the camera (fx, fy, cx,
// cy) on the card; hp: alpha, loss scale, loss scale^2, weight_line,
// weight_point, lambda init, up, down, min, max; ip: cost function,
// weight, loss (the orders of COST_FUNCTIONS, COST_WEIGHTS and (trivial,
// cauchy, huber)); trace [T, n_iter, 16] and ne [T, 43] may be null; with
// ne the kernel writes the normal equations at params0 and runs no
// iteration.
//
#ifndef LM_JOINTLOC_PARTS
// The path's kernel: a block of ``warps`` warps a chain (the launch's
// widest team), each chain its own team; staged (1: the active matches'
// data in shared memory, 0: their indices, in the global scratch ``idx``
// [T, nl + np] where it is not null); team_out [T] (may be null) gets
// each chain's warps.
extern "C" int lm_jointloc_launch(LM_JOINTLOC_ARGS, long long warps,
                                  long long staged, int* idx,
                                  int* team_out, void* stream) {
  return launch_fused<STAGES_ALL, BALANCED, false>(
      LM_JOINTLOC_MAKE_ARGS, warps, staged, idx, team_out, stream);
}

// The holding variant: a team of the whole block, match i on thread i
// mod its threads (the first design's distribution at 8 warps), for
// holding the fused loop to the first design bit for bit; arguments as
// lm_jointloc_launch's.
extern "C" int lm_jointloc_hold_launch(LM_JOINTLOC_ARGS, long long warps,
                                       long long staged, int* idx,
                                       int* team_out, void* stream) {
  return launch_fused<STAGES_ALL, OWNER, true>(
      LM_JOINTLOC_MAKE_ARGS, warps, staged, idx, team_out, stream);
}

// The first design: the common arguments.
extern "C" int lm_jointloc_scan_launch(LM_JOINTLOC_ARGS, void* stream) {
  return launch_scan<STAGES_ALL>(LM_JOINTLOC_MAKE_ARGS, stream);
}

#else
// The timing build (-DLM_JOINTLOC_PARTS, ops/lm_jointloc.py::launch_parts),
// which holds these variants only:
// the kernel with each chain's team and one part of an iteration left out
// (stages STAGES_ALL less one of NE_PASS, COST_PASS, the sums, SOLVE), or
// with a BALANCED team fixed at ``warps`` (fixed, STAGES_ALL); with
// ``scan`` the first design less one of NE_PASS, COST_PASS, NE_SUM,
// COST_SUM.  Other combinations return cudaErrorInvalidValue.
extern "C" int lm_jointloc_parts_launch(LM_JOINTLOC_ARGS, long long stages,
                                        long long warps, long long fixed,
                                        long long staged, int* idx,
                                        int* team_out, long long scan,
                                        void* stream) {
  const Args a = LM_JOINTLOC_MAKE_ARGS;
  constexpr int ALL = STAGES_ALL, SUMS = STAGE_NE_SUM | STAGE_COST_SUM;
  if (scan) {
    switch (stages) {
      case ALL & ~STAGE_NE_PASS:
        return launch_scan<ALL & ~STAGE_NE_PASS>(a, stream);
      case ALL & ~STAGE_COST_PASS:
        return launch_scan<ALL & ~STAGE_COST_PASS>(a, stream);
      case ALL & ~STAGE_NE_SUM:
        return launch_scan<ALL & ~STAGE_NE_SUM>(a, stream);
      case ALL & ~STAGE_COST_SUM:
        return launch_scan<ALL & ~STAGE_COST_SUM>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (fixed)
    return stages == ALL ? launch_fused<ALL, BALANCED, true>(
                               a, warps, staged, idx, team_out, stream)
                         : (int)cudaErrorInvalidValue;
  switch (stages) {
    case ALL & ~STAGE_NE_PASS:
      return launch_fused<ALL & ~STAGE_NE_PASS, BALANCED, false>(
          a, warps, staged, idx, team_out, stream);
    case ALL & ~STAGE_COST_PASS:
      return launch_fused<ALL & ~STAGE_COST_PASS, BALANCED, false>(
          a, warps, staged, idx, team_out, stream);
    case ALL & ~SUMS:
      return launch_fused<ALL & ~SUMS, BALANCED, false>(
          a, warps, staged, idx, team_out, stream);
    case ALL & ~STAGE_SOLVE:
      return launch_fused<ALL & ~STAGE_SOLVE, BALANCED, false>(
          a, warps, staged, idx, team_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
#endif  // LM_JOINTLOC_PARTS
#endif  // __CUDACC__
