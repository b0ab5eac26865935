// The root finder of the point-line minimal pose solvers, batched.
//
// Replaces the jitted XLA program of solve_two_trace_constraints
// (limap_tpu/estimators/pnl_solvers.py:142, vmapped by p3ll / p1p2ll /
// p2p1ll): per instance, all rotations with n1.(R v1) = 0, Tr(C2 R) = 0
// and Tr(C3 R) = 0, as the roots of the smooth function G(alpha) of the
// rotation family (see limap_tpu_torch/ops/trace_roots.py).
//
// Bound: operations.  Any design evaluates G about 900 times an instance
// (the grid, 48 bisection steps per simple root, 2 x 48 ternary steps per
// double root), each some 300 fp32 operations with a sin, a cos, an atan2
// and four square roots; it reads 96 bytes and writes 2 n_roots x 37.  The
// bound counts that work, not the extra nodes a tree below evaluates.
//
// The kernel (trace_roots_warp_kernel): one warp an instance, four
// instances a block, G of the grid in the warp's slice of shared memory.
// What bounds one instance is its chain of dependent evaluations of G,
// so the design shortens that chain:
//   1. the grid across the lanes (lane l evaluates points l, l + 32, ...);
//      the scales max |G| and max |det| by warp butterflies of the
//      NaN-propagating max, which gives the same value in any order;
//   2. the first n_roots sign changes by ballots over chunks of 32 cells,
//      taken in index order; the n_roots interior minima of |G| with the
//      smallest |G| by n_roots warp arg-min reductions on (|G|, index)
//      after the previous pick, which is the serial scan's order;
//   3. the 48 steps of every root as trees walked bit for bit: the
//      interval at a node of the bisection tree depends only on the path
//      to it, so a lane replays the halvings mid = 0.5f * (lo + hi) along
//      its node's path and evaluates its node's midpoint (a ternary node
//      takes two lanes, m1 and m2, replayed as the serial loop writes
//      them); then the lanes of the root walk the levels with the serial
//      rule (glo * gm < 0, or h1 * h1 < h2 * h2).  A root of depth d
//      takes 2^d - 1 lanes (twice that for a ternary root) and d steps a
//      round.  The host's plan (ops/trace_roots.py::plan) gives each phase
//      the depths of the simple and of the double roots that fit in 32
//      lanes at once and minimizes the rounds: 32 rounds for 4 roots (24
//      with the double roots two levels deep and the simple one level,
//      then 8 with the simple three levels deep), 48 for 8 roots (one
//      level each, 24 lanes), against 48 x 3 serial evaluations;
//   4. the rotations at the 2 n_roots roots, one root a lane.
// G is evaluated through one __noinline__ function (family_eval), and
// the rotations through another (finish_root), shared with the first
// design: nvcc's contraction of products and sums into FMAs can differ
// between inlining contexts, and compiled once it cannot, so the grid,
// the trees and the first design round alike and the roots, rotations
// and flags are the first design's bit for bit.  (Without contraction,
// -fmad=false, the designs also agree, but G loses the accuracy that
// phase 8's near-double roots need: two bisected roots of its input
// were then no float64 roots.)
//
// trace_roots_scan_kernel is the first design, kept as the yardstick:
// one thread runs one instance from the grid to the rotations, with the
// grid of G in local memory.  Rebuilt on the shared __noinline__ G and
// rotations, it is slower than the same code was as the path's kernel,
// with G inlined (PERF.md gives both).
//
// Semantics kept from the JAX program: the grid is an input (the f32
// jnp.linspace grid, bit for bit); the first n_roots sign changes in
// index order, missing ones at index 0 with the sign test of cell 0 as
// their flag (jnp.nonzero with size and fill_value 0); the n_roots
// interior local minima of |G| with the smallest |G|, ties and missing
// ones in index order (a stable argsort, inf for the non-minima); the
// scales max |G| and max |det| propagate NaN as jnp.max does.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxGrid = 1024;
constexpr int kMaxRoots = 8;
constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // instances a block of the warp kernel
constexpr int kMaxPhases = 2;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 normalize3(V3 v) {
  float n = sqrtf(dot3(v, v)) + kEps;
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ V3 any_perp(V3 v) {
  V3 ref = fabsf(v.x) > 0.9f ? V3{0.f, 1.f, 0.f} : V3{1.f, 0.f, 0.f};
  return normalize3(cross3(v, ref));
}

// unit quaternion (w, x, y, z), normalized first -> row-major R
__device__ void quat_to_rotmat(float w, float x, float y, float z,
                               float R[9]) {
  float n = sqrtf(w * w + x * x + y * y + z * z) + kEps;
  w /= n; x /= n; y /= n; z /= n;
  float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  float wx = w * x, wy = w * y, wz = w * z;
  float xy = x * y, xz = x * z, yz = y * z;
  R[0] = ww + xx - yy - zz; R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = ww - xx + yy - zz; R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = ww - xx - yy + zz;
}

// R a = b for unit vectors; a pi-rotation about a perpendicular axis when
// a ~ -b
__device__ void rot_between(V3 a, V3 b, float R[9]) {
  V3 v = cross3(a, b);
  float w = 1.f + dot3(a, b);
  if (w < 1e-6f) {
    v = any_perp(a);
    w = 0.f;
  }
  float n = sqrtf(w * w + dot3(v, v)) + kEps;
  quat_to_rotmat(w / n, v.x / n, v.y / n, v.z / n, R);
}

__device__ __forceinline__ void skew(V3 d, float K[9]) {
  K[0] = 0.f;  K[1] = -d.z; K[2] = d.y;
  K[3] = d.z;  K[4] = 0.f;  K[5] = -d.x;
  K[6] = -d.y; K[7] = d.x;  K[8] = 0.f;
}

// Tr((R0 C) Rot(d, b)) = a cos(b) + s sin(b) + c
__device__ void trace_coeffs(const float R0[9], const float C[9], V3 d,
                             const float K[9], float* a, float* s,
                             float* c) {
  float M[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] = R0[3 * i] * C[j] + R0[3 * i + 1] * C[3 + j] +
                     R0[3 * i + 2] * C[6 + j];
  float dv[3] = {d.x, d.y, d.z};
  float trM = M[0] + M[4] + M[8];
  float dMd = 0.f, sK = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      dMd += dv[i] * M[3 * i + j] * dv[j];
      sK += M[3 * i + j] * K[3 * j + i];
    }
  *a = trM - dMd;
  *s = sK;
  *c = dMd;
}

struct Family {
  V3 v1, u, w;
  float C2[9], C3[9];
};

struct Eval {
  float G, beta, det;
  V3 d;
  float R0[9];
};

// the one evaluation of G of both designs (see the header)
__device__ __noinline__ void family_eval(const Family& f, float alpha,
                                         Eval* e) {
  float ca = cosf(alpha), sa = sinf(alpha);
  e->d = {ca * f.u.x + sa * f.w.x, ca * f.u.y + sa * f.w.y,
          ca * f.u.z + sa * f.w.z};
  rot_between(f.v1, e->d, e->R0);
  float K[9];
  skew(e->d, K);
  float a2, b2, c2, a3, b3, c3;
  trace_coeffs(e->R0, f.C2, e->d, K, &a2, &b2, &c2);
  trace_coeffs(e->R0, f.C3, e->d, K, &a3, &b3, &c3);
  e->det = a2 * b3 - a3 * b2;
  float Nc = c3 * b2 - c2 * b3;
  float Ns = c2 * a3 - c3 * a2;
  e->G = Nc * Nc + Ns * Ns - e->det * e->det;
  e->beta = atan2f(Ns * e->det, Nc * e->det);
}

__device__ __forceinline__ float G_at(const Family& f, float alpha) {
  Eval e;
  family_eval(f, alpha, &e);
  return e.G;
}

// max that propagates NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float acc, float x) {
  return (isnan(x) || x > acc) ? x : acc;
}

__device__ __forceinline__ Family load_family(const float* v1,
                                              const float* n1,
                                              const float* C2,
                                              const float* C3,
                                              long long b) {
  Family f;
  f.v1 = {v1[3 * b], v1[3 * b + 1], v1[3 * b + 2]};
  V3 n = {n1[3 * b], n1[3 * b + 1], n1[3 * b + 2]};
  for (int k = 0; k < 9; ++k) {
    f.C2[k] = C2[9 * b + k];
    f.C3[k] = C3[9 * b + k];
  }
  f.u = any_perp(n);
  f.w = cross3(n, f.u);
  return f;
}

// The rotation at a root with the conditioning and finiteness checks; a
// double root's flag also needs |G| small at the root.  Both designs.
__device__ __noinline__ void finish_root(const Family& f, float root,
                                         bool ok, bool is_double,
                                         float g_scale, float det_scale,
                                         float* out, unsigned char* ok_out) {
  Eval e;
  family_eval(f, root, &e);
  if (is_double) ok = ok && fabsf(e.G) < 1e-2f * g_scale;
  bool good = ok && fabsf(e.det) > 1e-9f * det_scale;
  float K[9], KK[9], Rot[9], R[9];
  skew(e.d, K);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] +
                      K[3 * i + 2] * K[6 + j];
  float s = sinf(e.beta), c = cosf(e.beta);
  for (int k = 0; k < 9; ++k)
    Rot[k] = ((k % 4 == 0) ? 1.f : 0.f) + s * K[k] + (1.f - c) * KK[k];
  bool finite = true;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float v = Rot[3 * i] * e.R0[j] + Rot[3 * i + 1] * e.R0[3 + j] +
                Rot[3 * i + 2] * e.R0[6 + j];
      R[3 * i + j] = v;
      finite = finite && isfinite(v);
    }
  for (int k = 0; k < 9; ++k)
    out[k] = finite ? R[k] : ((k % 4 == 0) ? 1.f : 0.f);
  *ok_out = (good && finite) ? 1 : 0;
}

// ------------------------------------------------- the first design
__global__ void trace_roots_scan_kernel(const float* __restrict__ v1,
                                        const float* __restrict__ n1,
                                        const float* __restrict__ C2,
                                        const float* __restrict__ C3,
                                        const float* __restrict__ alphas,
                                        long long B, int n_grid,
                                        int n_bisect, int n_roots,
                                        float* __restrict__ R_out,
                                        unsigned char* __restrict__ ok_out) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Family f = load_family(v1, n1, C2, C3, b);

  float G[kMaxGrid + 1];
  float g_scale = 0.f, det_scale = 0.f;
  for (int k = 0; k <= n_grid; ++k) {
    Eval e;
    family_eval(f, alphas[k], &e);
    G[k] = e.G;
    g_scale = nan_max(g_scale, fabsf(e.G));
    det_scale = nan_max(det_scale, fabsf(e.det));
  }
  g_scale += kEps;
  det_scale += kEps;

  float root[2 * kMaxRoots];
  bool ok[2 * kMaxRoots];

  // simple roots: the first n_roots sign changes, bisected
  int found = 0;
  int idx[kMaxRoots];
  for (int k = 0; k < n_grid && found < n_roots; ++k)
    if (G[k] * G[k + 1] < 0.f) idx[found++] = k;
  bool sc0 = G[0] * G[1] < 0.f;
  for (int r = 0; r < n_roots; ++r) {
    int k = r < found ? idx[r] : 0;
    ok[r] = r < found ? true : sc0;
    float lo = alphas[k], hi = alphas[k + 1], glo = G[k];
    for (int it = 0; it < n_bisect; ++it) {
      float mid = 0.5f * (lo + hi);
      float gm = G_at(f, mid);
      if (glo * gm < 0.f) {
        hi = mid;
      } else {
        lo = mid;
        glo = gm;
      }
    }
    root[r] = 0.5f * (lo + hi);
  }

  // (near-)double roots: interior minima of |G|, smallest |G| first
  float prev_v = -INFINITY;
  int prev_i = -1;
  for (int r = 0; r < n_roots; ++r) {
    float best_v = INFINITY;
    int best_i = -1;
    bool best_ext = false;
    for (int i = 0; i < n_grid - 1; ++i) {
      float g = fabsf(G[i + 1]);
      bool ext = g <= fabsf(G[i]) && g <= fabsf(G[i + 2]);
      float v = ext ? g : INFINITY;
      bool after = v > prev_v || (v == prev_v && i > prev_i);
      if (!after) continue;
      if (best_i < 0 || v < best_v) {
        best_v = v;
        best_i = i;
        best_ext = ext;
      }
    }
    prev_v = best_v;
    prev_i = best_i;
    float lo = alphas[best_i], hi = alphas[best_i + 2];
    for (int it = 0; it < n_bisect; ++it) {
      float m1 = lo + (hi - lo) / 3.f;
      float m2 = hi - (hi - lo) / 3.f;
      float h1 = G_at(f, m1), h2 = G_at(f, m2);
      if (h1 * h1 < h2 * h2) {
        hi = m2;
      } else {
        lo = m1;
      }
    }
    root[n_roots + r] = 0.5f * (lo + hi);
    ok[n_roots + r] = best_ext;
  }

  // rotations at the roots, with the conditioning and finiteness checks
  for (int r = 0; r < 2 * n_roots; ++r)
    finish_root(f, root[r], ok[r], r >= n_roots, g_scale, det_scale,
                R_out + (b * 2 * n_roots + r) * 9,
                ok_out + b * 2 * n_roots + r);
}

// ------------------------------------------------------ the kernel
// Per phase: the depth of the simple roots' trees and of the double
// roots' (0: that kind waits), and the rounds it runs.
struct Plan {
  int n_phases;
  int ds[kMaxPhases], dd[kMaxPhases], rounds[kMaxPhases];
};

// floats of a warp's slice: G, then the roots' intervals (lo, hi), the
// simple roots' G(lo) and the flags
__host__ __device__ constexpr int slice_floats(int n_grid) {
  return n_grid + 1 + 2 * (2 * kMaxRoots) + kMaxRoots + 2 * kMaxRoots;
}

__global__ void __launch_bounds__(32 * kWarps)
trace_roots_warp_kernel(const float* __restrict__ v1,
                        const float* __restrict__ n1,
                        const float* __restrict__ C2,
                        const float* __restrict__ C3,
                        const float* __restrict__ alphas, long long B,
                        int n_grid, int n_bisect, int n_roots, Plan plan,
                        float* __restrict__ R_out,
                        unsigned char* __restrict__ ok_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp
  float* G = smem + warp * slice_floats(n_grid);
  float* jlo = G + n_grid + 1;         // [2 kMaxRoots], simple then double
  float* jhi = jlo + 2 * kMaxRoots;
  float* jglo = jhi + 2 * kMaxRoots;   // [kMaxRoots]
  int* jok = reinterpret_cast<int*>(jglo + kMaxRoots);
  const Family f = load_family(v1, n1, C2, C3, b);

  // 1. G on the grid across the lanes, the scales by butterflies
  float g_scale = 0.f, det_scale = 0.f;
  for (int k = lane; k <= n_grid; k += 32) {
    Eval e;
    family_eval(f, alphas[k], &e);
    G[k] = e.G;
    g_scale = nan_max(g_scale, fabsf(e.G));
    det_scale = nan_max(det_scale, fabsf(e.det));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g_scale = nan_max(g_scale, __shfl_xor_sync(kFull, g_scale, off));
    det_scale = nan_max(det_scale, __shfl_xor_sync(kFull, det_scale, off));
  }
  g_scale += kEps;
  det_scale += kEps;
  __syncwarp();

  // 2. the roots' cells by votes, in index order
  {
    int found = 0;
    for (int base = 0; base < n_grid && found < n_roots; base += 32) {
      const int k = base + lane;
      const bool sc = k < n_grid && G[k] * G[k + 1] < 0.f;
      const unsigned m = __ballot_sync(kFull, sc);
      const int rank = found + __popc(m & ((1u << lane) - 1u));
      if (sc && rank < n_roots) {
        jlo[rank] = alphas[k];
        jhi[rank] = alphas[k + 1];
        jglo[rank] = G[k];
        jok[rank] = 1;
      }
      found += __popc(m);
    }
    const bool sc0 = G[0] * G[1] < 0.f;
    if (lane >= found && lane < n_roots) {
      jlo[lane] = alphas[0];
      jhi[lane] = alphas[1];
      jglo[lane] = G[0];
      jok[lane] = sc0;
    }
    float prev_v = -INFINITY;
    int prev_i = -1;
    for (int r = 0; r < n_roots; ++r) {
      float bv = INFINITY;
      int bi = INT_MAX;
      for (int i = lane; i < n_grid - 1; i += 32) {
        const float g = fabsf(G[i + 1]);
        const bool ext = g <= fabsf(G[i]) && g <= fabsf(G[i + 2]);
        const float v = ext ? g : INFINITY;
        const bool after = v > prev_v || (v == prev_v && i > prev_i);
        if (after && (v < bv || (v == bv && i < bi))) {
          bv = v;
          bi = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      prev_v = bv;
      prev_i = bi;
      if (lane == r) {
        const float g = fabsf(G[bi + 1]);
        jlo[n_roots + r] = alphas[bi];
        jhi[n_roots + r] = alphas[bi + 2];
        jok[n_roots + r] = g <= fabsf(G[bi]) && g <= fabsf(G[bi + 2]);
      }
    }
  }
  __syncwarp();

  // 3. the steps of every root as trees (see the header)
  int done_s = 0, done_d = 0;
  for (int ph = 0; ph < plan.n_phases; ++ph) {
    const int ds = plan.ds[ph], dd = plan.dd[ph];
    const int ws = ds ? (1 << ds) - 1 : 0;
    const int wd = dd ? 2 * ((1 << dd) - 1) : 0;
    // this lane's root (kind 1 simple, 2 double), its first lane, node
    // (1 the root of the tree, 2n and 2n + 1 its children) and point
    int kind = 0, job = 0, base = lane, node = 1, which = 0;
    if (lane < n_roots * ws) {
      kind = 1;
      job = lane / ws;
      base = job * ws;
      node = lane - base + 1;
    } else if (lane - n_roots * ws < n_roots * wd) {
      kind = 2;
      const int o = lane - n_roots * ws, jd = o / wd;
      job = n_roots + jd;
      base = n_roots * ws + jd * wd;
      node = (o - jd * wd) / 2 + 1;
      which = (o - jd * wd) & 1;
    }
    float lo = kind ? jlo[job] : 0.f, hi = kind ? jhi[job] : 0.f;
    float glo = kind == 1 ? jglo[job] : 0.f;
    const int level = 31 - __clz(node);
    for (int rd = 0; rd < plan.rounds[ph]; ++rd) {
      const int Ls = ds ? min(ds, n_bisect - done_s) : 0;
      const int Ld = dd ? min(dd, n_bisect - done_d) : 0;
      const int L = kind == 1 ? Ls : (kind == 2 ? Ld : 0);
      float g = 0.f;
      if (kind && level < L) {
        float a = lo, c = hi;
        for (int bit = level - 1; bit >= 0; --bit) {
          const bool right = (node >> bit) & 1;
          if (kind == 1) {
            const float mid = 0.5f * (a + c);
            if (right) a = mid; else c = mid;
          } else {
            const float m1 = a + (c - a) / 3.f;
            const float m2 = c - (c - a) / 3.f;
            if (right) a = m1; else c = m2;
          }
        }
        const float x = kind == 1 ? 0.5f * (a + c)
                                  : (which ? c - (c - a) / 3.f
                                           : a + (c - a) / 3.f);
        g = G_at(f, x);
      }
      int at = 1;
      const int Lmax = max(Ls, Ld);
      for (int l = 0; l < Lmax; ++l) {
        const int src = kind == 1 ? base + at - 1
                        : (kind == 2 ? base + 2 * (at - 1) : lane);
        const float h1 = __shfl_sync(kFull, g, src);
        const float h2 = __shfl_sync(kFull, g, kind == 2 ? src + 1 : lane);
        if (l < L) {
          if (kind == 1) {
            const float mid = 0.5f * (lo + hi);
            if (glo * h1 < 0.f) {
              hi = mid;
              at = 2 * at;
            } else {
              lo = mid;
              glo = h1;
              at = 2 * at + 1;
            }
          } else {
            const float m1 = lo + (hi - lo) / 3.f;
            const float m2 = hi - (hi - lo) / 3.f;
            if (h1 * h1 < h2 * h2) {
              hi = m2;
              at = 2 * at;
            } else {
              lo = m1;
              at = 2 * at + 1;
            }
          }
        }
      }
      done_s += Ls;
      done_d += Ld;
    }
    __syncwarp();
    if (kind && lane == base) {
      jlo[job] = lo;
      jhi[job] = hi;
      if (kind == 1) jglo[job] = glo;
    }
    __syncwarp();
  }

  // 4. the rotations, one root a lane
  if (lane < 2 * n_roots)
    finish_root(f, 0.5f * (jlo[lane] + jhi[lane]), jok[lane] != 0,
                lane >= n_roots, g_scale, det_scale,
                R_out + (b * 2 * n_roots + lane) * 9,
                ok_out + b * 2 * n_roots + lane);
}

}  // namespace

// plan: n_phases, then per phase (simple depth, double depth, rounds).
extern "C" int trace_roots_launch(const void* v1, const void* n1,
                                  const void* C2, const void* C3,
                                  const void* alphas, long long B,
                                  long long n_grid, long long n_bisect,
                                  long long n_roots, const long long* plan,
                                  void* R, void* ok,
                                  void* stream) {
  Plan p;
  p.n_phases = (int)plan[0];
  for (int i = 0; i < kMaxPhases; ++i) {
    p.ds[i] = (int)plan[1 + 3 * i];
    p.dd[i] = (int)plan[2 + 3 * i];
    p.rounds[i] = (int)plan[3 + 3 * i];
  }
  const long long blocks = (B + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * slice_floats((int)n_grid);
  trace_roots_warp_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                            (cudaStream_t)stream>>>(
      (const float*)v1, (const float*)n1, (const float*)C2,
      (const float*)C3, (const float*)alphas, B, (int)n_grid,
      (int)n_bisect, (int)n_roots, p, (float*)R,
      (unsigned char*)ok);
  return (int)cudaGetLastError();
}

extern "C" int trace_roots_scan_launch(const void* v1, const void* n1,
                                       const void* C2, const void* C3,
                                       const void* alphas, long long B,
                                       long long n_grid, long long n_bisect,
                                       long long n_roots, void* R, void* ok,
                                       void* stream) {
  const int threads = 64;
  long long blocks = (B + threads - 1) / threads;
  trace_roots_scan_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)v1, (const float*)n1, (const float*)C2,
      (const float*)C3, (const float*)alphas, B, (int)n_grid,
      (int)n_bisect, (int)n_roots, (float*)R, (unsigned char*)ok);
  return (int)cudaGetLastError();
}
