// The root finder of the point-line minimal pose solvers, batched.
//
// Replaces the jitted XLA program of solve_two_trace_constraints
// (limap_tpu/estimators/pnl_solvers.py:142, vmapped by p3ll / p1p2ll /
// p2p1ll): per instance, all rotations with n1.(R v1) = 0, Tr(C2 R) = 0
// and Tr(C3 R) = 0, as the roots of the smooth function G(alpha) of the
// rotation family (see limap_tpu_torch/ops/trace_roots.py).
//
// Bound: operations.  An instance evaluates G about 900 times (the grid,
// 48 bisection steps per simple root, 2 x 48 ternary steps per double
// root), each some 300 fp32 operations with a sin, a cos, an atan2 and
// four square roots; it reads 96 bytes and writes 2 n_roots x 37.  The eager
// version pays some 30 launches per step of every loop; here one thread
// runs one instance from the grid to the final rotations, with the grid
// of G in local memory, so the whole batch of one solver type is one
// launch.
//
// Semantics kept from the JAX program: the grid is an input (the f32
// jnp.linspace grid, bit for bit); the first n_roots sign changes in
// index order, missing ones at index 0 with the sign test of cell 0 as
// their flag (jnp.nonzero with size and fill_value 0); the n_roots
// interior local minima of |G| with the smallest |G|, ties and missing
// ones in index order (a stable argsort, inf for the non-minima); the
// scales max |G| and max |det| propagate NaN as jnp.max does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxGrid = 1024;
constexpr int kMaxRoots = 8;
constexpr float kEps = 1e-12f;

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

__device__ void family_eval(const Family& f, float alpha, Eval* e) {
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

__global__ void trace_roots_kernel(const float* __restrict__ v1,
                                   const float* __restrict__ n1,
                                   const float* __restrict__ C2,
                                   const float* __restrict__ C3,
                                   const float* __restrict__ alphas,
                                   long long B, int n_grid, int n_bisect,
                                   int n_roots, float* __restrict__ R_out,
                                   unsigned char* __restrict__ ok_out) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  Family f;
  f.v1 = {v1[3 * b], v1[3 * b + 1], v1[3 * b + 2]};
  V3 n = {n1[3 * b], n1[3 * b + 1], n1[3 * b + 2]};
  for (int k = 0; k < 9; ++k) {
    f.C2[k] = C2[9 * b + k];
    f.C3[k] = C3[9 * b + k];
  }
  f.u = any_perp(n);
  f.w = cross3(n, f.u);

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
    float er = 0.5f * (lo + hi);
    root[n_roots + r] = er;
    ok[n_roots + r] = best_ext && fabsf(G_at(f, er)) < 1e-2f * g_scale;
  }

  // rotations at the roots, with the conditioning and finiteness checks
  for (int r = 0; r < 2 * n_roots; ++r) {
    Eval e;
    family_eval(f, root[r], &e);
    bool good = ok[r] && fabsf(e.det) > 1e-9f * det_scale;
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
    float* out = R_out + (b * 2 * n_roots + r) * 9;
    for (int k = 0; k < 9; ++k)
      out[k] = finite ? R[k] : ((k % 4 == 0) ? 1.f : 0.f);
    ok_out[b * 2 * n_roots + r] = (good && finite) ? 1 : 0;
  }
}

}  // namespace

extern "C" int trace_roots_launch(const void* v1, const void* n1,
                                  const void* C2, const void* C3,
                                  const void* alphas, long long B,
                                  long long n_grid, long long n_bisect,
                                  long long n_roots, void* R, void* ok,
                                  void* stream) {
  const int threads = 64;
  long long blocks = (B + threads - 1) / threads;
  trace_roots_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)v1, (const float*)n1, (const float*)C2,
      (const float*)C3, (const float*)alphas, B, (int)n_grid,
      (int)n_bisect, (int)n_roots, (float*)R, (unsigned char*)ok);
  return (int)cudaGetLastError();
}
