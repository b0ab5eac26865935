// Kernel R: the log-domain Sinkhorn solver with dustbins, the whole
// solve in one launch.
//
// Replaces the jitted log_sinkhorn (limap_tpu/point2d/matching.py:19, loop
// body :43-49), which SuperGlue's optimal-transport head runs for 100
// iterations on an [M+1, N+1] coupling (2,049 x 2,049 at 2,048 keypoints)
// and the Sinkhorn endpoint matcher for 50 on its line scores.  In:
// scores [M, N] f32, the dustbin score and the three marginal constants
// (computed by the wrapper in float32 as the reference does); out: Z
// [M+1, N+1] f32 = couplings + u + v - norm.
//
// Bound: operations.  Each iteration takes a logsumexp over every row
// (the u-pass) and then over every column (the v-pass): per element and
// pass an add, a max, a subtraction, an exp and an add, so some
// 10 iters (M+1)(N+1) fp32 operations against 4 (M N + (M+1)(N+1)) bytes
// in and out (ops/log_sinkhorn.py::work counts them).  A 2,049^2 coupling
// is 16.8 MB: it stays in the 50 MB L2 for all the passes.
//
// Design: one cooperative launch, as many blocks as are resident.  The
// coupling is written twice, into Z and transposed into Zt (33.6 MB at
// 2,049^2: both stay in L2), so that both passes read rows: the u-pass a
// warp a row of Z, the v-pass a warp a row of Zt (a column of Z), its
// lanes strided along the row (coalesced), max then sum of exps, each a
// warp-shuffle butterfly; a grid barrier after each pass; a last pass
// writes the result over Z.  Every reduction has a fixed order, so the
// kernel repeats itself bit for bit.  logsumexp is the reference's: the
// max, taken as 0 where it is not finite, then log(sum exp(x - max)) +
// max.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* scores;  // [M, N]
  float* Z;             // [M+1, N+1]
  float* Zt;            // [N+1, M+1], the coupling transposed
  float* u;             // [M+1]
  float* v;             // [N+1]
  int M, N, iters;
  float bin, norm, mu_bin, nu_bin;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// the butterfly leaves the same sum in every lane (a + b == b + a)
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// log_marg - logsumexp_k(row[k] + pot[k]) over k < n, by one warp
__device__ __forceinline__ float potential(const float* row, const float* pot,
                                          int n, float log_marg, int lane) {
  float m = -INFINITY;
#pragma unroll 4
  for (int k = lane; k < n; k += 32) m = fmaxf(m, __fadd_rn(row[k], pot[k]));
  m = warp_max(m);
  if (!isfinite(m)) m = 0.f;
  float s = 0.f;
#pragma unroll 4
  for (int k = lane; k < n; k += 32)
    s = __fadd_rn(s, expf(__fsub_rn(__fadd_rn(row[k], pot[k]), m)));
  s = warp_sum(s);
  return __fsub_rn(log_marg, __fadd_rn(logf(s), m));
}

__global__ void __launch_bounds__(THREADS) sinkhorn_kernel(Args a) {
  auto grid = cooperative_groups::this_grid();
  const int lane = threadIdx.x & 31;
  const int R = a.M + 1, C = a.N + 1;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nw = (long long)gridDim.x * WARPS;
  const long long gt = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * THREADS;

  // the coupling: scores, a column and a row of dustbins
  for (long long k = gt; k < (long long)R * C; k += nt) {
    const int i = (int)(k / C), j = (int)(k % C);
    const float z =
        (i < a.M && j < a.N) ? a.scores[(long long)i * a.N + j] : a.bin;
    a.Z[k] = z;
    a.Zt[(long long)j * R + i] = z;
  }
  for (long long j = gt; j < C; j += nt) a.v[j] = 0.f;
  for (long long i = gt; i < R; i += nt) a.u[i] = 0.f;
  grid.sync();

  for (int it = 0; it < a.iters; ++it) {
    // u_i = log_mu_i - logsumexp_j(Z_ij + v_j)
    for (long long i = gw; i < R; i += nw) {
      const float u = potential(a.Z + i * C, a.v, C,
                                i < a.M ? a.norm : a.mu_bin, lane);
      if (lane == 0) a.u[i] = u;
    }
    grid.sync();
    // v_j = log_nu_j - logsumexp_i(Z_ij + u_i), over the rows of Zt
    for (long long j = gw; j < C; j += nw) {
      const float v = potential(a.Zt + j * R, a.u, R,
                                j < a.N ? a.norm : a.nu_bin, lane);
      if (lane == 0) a.v[j] = v;
    }
    grid.sync();
  }

  // Z = ((couplings + u) + v) - norm
  for (long long k = gt; k < (long long)R * C; k += nt) {
    const int i = (int)(k / C), j = (int)(k % C);
    a.Z[k] = __fsub_rn(__fadd_rn(__fadd_rn(a.Z[k], a.u[i]), a.v[j]), a.norm);
  }
}

}  // namespace

// scores [M, N], Z [M+1, N+1], Zt [N+1, M+1] (scratch), u [M+1], v [N+1];
// f: bin, norm, the row dustbin's log_mu, the column dustbin's log_nu.
extern "C" int log_sinkhorn_launch(const float* scores, int M, int N,
                                   int iters, const float* f, float* Z,
                                   float* Zt, float* u, float* v,
                                   void* stream) {
  Args a{scores, Z, Zt, u, v, M, N, iters, f[0], f[1], f[2], f[3]};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_kernel,
                                                THREADS, 0);
  const long long lines = (M > N ? M : N) + 1;   // a warp a row or column
  long long want = (lines + WARPS - 1) / WARPS;
  const long long most = (long long)sms * per_sm;
  if (want > most) want = most;
  if (want < 1) want = 1;
  void* ptrs[] = {(void*)&a};
  const int err = (int)cudaLaunchCooperativeKernel(
      (const void*)sinkhorn_kernel, dim3((unsigned)want), dim3(THREADS), ptrs,
      0, (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}
