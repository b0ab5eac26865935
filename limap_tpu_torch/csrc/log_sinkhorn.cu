// Kernel R: the log-domain Sinkhorn solver with dustbins, the whole
// solve in one launch, the coupling held in shared memory.
//
// Replaces the jitted log_sinkhorn (limap_tpu/point2d/matching.py:19, loop
// body :43-49), which SuperGlue's optimal-transport head runs for 100
// iterations on an [M+1, N+1] coupling (2,049 x 2,049 at 2,048 keypoints),
// the learned endpoint matchers, GlueStick and the Sinkhorn runner for 50
// on their line scores (a few hundred lines a side).  In: scores [M, N]
// f32, the dustbin score and the three marginal constants (computed by
// the wrapper in float32 as the reference does); out: Z [M+1, N+1] f32 =
// couplings + u + v - norm.
//
// Bound.  Each iteration takes a logsumexp over every row (the u-pass)
// and then over every column (the v-pass): per element and pass an add,
// a max, a subtraction, an exp and an add, 10 iters (M+1)(N+1) fp32
// operations against 4 (M N + (M+1)(N+1)) bytes in and out.  The exps
// set the floor: expf is one MUFU ex2 an element, and the special
// function units retire 16 a clock an SM, so 2 iters (M+1)(N+1) exps
// take at least 2 iters cells / (16 x SMs x clock): ~8 us for the
// runner's 557 x 566 pair (3.15e7 exps) and ~0.20-0.23 ms at 2,049^2
// (8.4e8 exps) on 132 SMs at 1.755-1.98 GHz (ops/log_sinkhorn.py::work
// counts both).
//
// Design.  The coupling never changes during a solve, so it is written
// once, in row bands, into the shared memory of the CTAs that own them
// (227 KB a CTA), and each iteration reads it from there:
// - the u-pass is local to a band: a warp a row (two rows at once where
//   a warp has two, their chains interleaved), its lanes strided along
//   the row in ACC accumulators, max then sum of exps, each a
//   warp-shuffle butterfly, with the CTA's own copy of v;
// - then each CTA writes, for every column j, the partial of its rows
//   with the new u (a thread a column, row li in accumulator li % ACC):
//   the raw maximum M_b of x_ij = Z_ij + u_i over the band, and s_b =
//   sum_i exp(x_ij - m_b), m_b = M_b or 0 where M_b is not finite;
// - the merge of a column takes its partials in a fixed order: M = max_b
//   M_b, m = M or 0 where M is not finite, s = sum_b s_b exp(m_b - m) over
//   the bands with s_b > 0 (a band of -inf entries adds nothing, and is
//   skipped so that 0 x exp(huge) cannot make a NaN), then v_j = log_nu_j
//   - (log s + m).  The coupling is not written transposed.
// Rounding of the merge against the reference's single max-then-sum:
// with M finite, m is the reference's max, and exp(x - m_b) exp(m_b - m)
// = exp(x - m) exactly in real arithmetic.  The band sums hold terms <= 1
// with the band's largest term 1, so s_b >= 1 for the band that holds M
// (whose factor exp(0) = 1 is exact) and each other band adds one more
// rounding of its factor and one of its product, a few ulp of s; a
// factor that underflows belongs to a band whose terms are below
// e^-87 of the largest, which the reference's sum rounds away too.  With
// M = +inf both sides give +inf, with M = -inf (an all -inf column) both
// take m = 0, s = 0 and give log_nu + inf.
// The grid: one cooperative launch, a CTA an SM, each band in its CTA's
// shared memory (rows past what fits there, a multiple of ROWS_ALIGN in
// it, stay in global memory, in Z, read with the same arithmetic and
// order).  The partials go to global memory [bands, C]; after a grid
// barrier each CTA merges a slice of the columns, 16 columns at a time,
// the bands spread over groups of threads (a thread's bands in order,
// then the groups in order through shared memory); after a second
// barrier each CTA copies v.  Where v [C] itself does not fit a CTA's
// shared memory (past ~57,000 columns), it stays in global memory too
// and the passes read it from L2 (make_plan decides from the shape,
// log_sinkhorn_plan reports it), so that every shape the first design
// took is taken.
// One thread-block cluster for small couplings (partials through
// distributed shared memory, cluster barriers) was tried and dropped: on
// an H100 it lost to this grid from ~250^2 on (the runner's pairs: 0.46
// ms in a cluster of 16 against 0.33 ms) and to the first design below
// ~200^2 (PERF.md).
// A CTA has as many threads as spread the columns evenly over rounds of
// at most 1,024 (the v-partials take a thread a column).
// Every reduction has a fixed order, so the kernel repeats itself bit for
// bit.  logsumexp is the reference's: the max, taken as 0 where it is not
// finite, then log(sum exp(x - max)) + max, with expf and logf.
// Measured (PERF.md): the kernel is not bound by the exps: a row's
// reduction chain, the merge and the barriers set the pace at the
// runner's sizes.
//
// The first design, a warp a row of Z and then a warp a row of Zt (the
// coupling transposed, both in global memory) with a grid barrier after
// each pass, stays below as sinkhorn_scan_kernel (log_sinkhorn_scan_launch),
// the yardstick for timing and holding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

// ------------------------------------------------ the band design
constexpr int MAX_THREADS = 1024;
constexpr int MCOLS = 16;      // the merge: columns a round
constexpr int MGROUPS = MAX_THREADS / MCOLS;
constexpr int MAXB = 8;        // the merge: bands a thread
constexpr int ACC = 4;         // accumulators a lane or thread (a power of 2;
                               // 2 and 8 measured no faster)
constexpr int ROWS_ALIGN = 8;  // a band's rows in shared memory, where it
                               // does not fit: a multiple of ACC
static_assert(ROWS_ALIGN % ACC == 0, "rows of a band split at ACC");
// the kernel's parts (a template argument), to time a part alone: the
// barriers, the u-pass, the v-partials, the merge (which needs the
// barriers); the path's launch takes them all
constexpr int PART_SYNC = 1, PART_U = 2, PART_V = 4, PART_MERGE = 8,
              PARTS_ALL = 15;

struct Args {
  const float* scores;  // [M, N]
  float* Z;             // [M+1, N+1]: the output; the rows past rows_smem
  float* pm;            // [bands, C] the bands' raw column maxima
  float* ps;            // [bands, C] the bands' column sums
  float* v;             // [C] the merged v
  int M, N, iters;
  int rows_smem;        // rows of a band held in shared memory
  int rows_max;         // rows of the largest band
  float bin, norm, mu_bin, nu_bin;
};

// first row (or column) of band b of n over R
__device__ __forceinline__ int band_first(int b, int n, int R) {
  return (int)(((long long)b * R) / n);
}

// v read from global memory through L2 (another CTA wrote it before the
// last grid barrier)
struct GlobalV {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const {
    return __ldcg(p + k);
  }
};

// shared memory: v [C] (where it lives there, VS), u [rows_max], then the
// band [rows_smem, C]
struct Smem {
  float *v, *u, *z;
};

// the passes' v: the CTA's copy in shared memory, or the merged v in
// global memory
__device__ __forceinline__ const float* v_reader(std::true_type,
                                                 const Smem& s,
                                                 const Args&) {
  return s.v;
}

__device__ __forceinline__ GlobalV v_reader(std::false_type, const Smem&,
                                            const Args& a) {
  return GlobalV{a.v};
}

template <bool VS>
__device__ __forceinline__ Smem carve(float* base, const Args& a, int C) {
  Smem s;
  const int nv = VS ? C : 0;
  s.v = base;
  s.u = base + nv;
  s.z = base + nv + ((a.rows_max + 3) & ~3);
  return s;
}

// the coupling (scores, then the dustbin column and row) into the band,
// u = 0
__device__ void load_band(const Args& a, const Smem& s, int r0, int rows,
                          int C) {
  const int nt = blockDim.x;
  for (long long k = threadIdx.x; k < (long long)rows * C; k += nt) {
    const int li = (int)(k / C), j = (int)(k - (long long)li * C);
    const int i = r0 + li;
    const float z =
        (i < a.M && j < a.N) ? a.scores[(long long)i * a.N + j] : a.bin;
    if (li < a.rows_smem)
      s.z[k] = z;
    else
      a.Z[(long long)i * C + j] = z;
  }
  for (int li = threadIdx.x; li < rows; li += nt) s.u[li] = 0.f;
}

// the sum of ACC accumulators as a balanced tree in a fixed order:
// ((a0 + a1) + (a2 + a3)) + ...
template <int N>
__device__ __forceinline__ float tree_sum(const float* t) {
  if constexpr (N == 1)
    return t[0];
  else
    return __fadd_rn(tree_sum<N / 2>(t), tree_sum<N / 2>(t + N / 2));
}

template <int N>
__device__ __forceinline__ float tree_max(const float* t) {
  if constexpr (N == 1)
    return t[0];
  else
    return fmaxf(tree_max<N / 2>(t), tree_max<N / 2>(t + N / 2));
}

// log_marg - logsumexp_k(row[k] + pot[k]) over k < n, by one warp, with
// ACC accumulators a lane (element k + 32 c of each 32 ACC in accumulator
// c, the rest in accumulator 0) so that ACC loads and exps are in
// flight: the max is exact in any order, the sums are added as a tree
// (tree_sum), then the butterfly.  pot: v in shared memory (a pointer)
// or in global memory (GlobalV)
template <class P>
__device__ __forceinline__ float row_potential(const float* row, P pot,
                                              int n, float log_marg,
                                              int lane) {
  float t[ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) t[c] = -INFINITY;
  int k = lane;
  for (; k + 32 * (ACC - 1) < n; k += 32 * ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c)
      t[c] = fmaxf(t[c], __fadd_rn(row[k + 32 * c], pot[k + 32 * c]));
  for (; k < n; k += 32) t[0] = fmaxf(t[0], __fadd_rn(row[k], pot[k]));
  float m = warp_max(tree_max<ACC>(t));
  if (!isfinite(m)) m = 0.f;
#pragma unroll
  for (int c = 0; c < ACC; ++c) t[c] = 0.f;
  k = lane;
  for (; k + 32 * (ACC - 1) < n; k += 32 * ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c)
      t[c] = __fadd_rn(t[c], expf(__fsub_rn(
                                 __fadd_rn(row[k + 32 * c], pot[k + 32 * c]),
                                 m)));
  for (; k < n; k += 32)
    t[0] = __fadd_rn(t[0], expf(__fsub_rn(__fadd_rn(row[k], pot[k]), m)));
  const float s = warp_sum(tree_sum<ACC>(t));
  return __fsub_rn(log_marg, __fadd_rn(logf(s), m));
}

// row_potential of two rows at once, their loops interleaved (the same
// arithmetic and order as two calls)
template <class P>
__device__ __forceinline__ void row_potential2(const float* ra,
                                               const float* rb, P pot, int n,
                                               float marg_a, float marg_b,
                                               int lane, float& ua,
                                               float& ub) {
  float ta[ACC], tb[ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) ta[c] = tb[c] = -INFINITY;
  int k = lane;
  for (; k + 32 * (ACC - 1) < n; k += 32 * ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c) {
      const float p = pot[k + 32 * c];
      ta[c] = fmaxf(ta[c], __fadd_rn(ra[k + 32 * c], p));
      tb[c] = fmaxf(tb[c], __fadd_rn(rb[k + 32 * c], p));
    }
  for (; k < n; k += 32) {
    const float p = pot[k];
    ta[0] = fmaxf(ta[0], __fadd_rn(ra[k], p));
    tb[0] = fmaxf(tb[0], __fadd_rn(rb[k], p));
  }
  float ma = tree_max<ACC>(ta), mb = tree_max<ACC>(tb);
  for (int o = 16; o > 0; o >>= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
  }
  if (!isfinite(ma)) ma = 0.f;
  if (!isfinite(mb)) mb = 0.f;
#pragma unroll
  for (int c = 0; c < ACC; ++c) ta[c] = tb[c] = 0.f;
  k = lane;
  for (; k + 32 * (ACC - 1) < n; k += 32 * ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c) {
      const float p = pot[k + 32 * c];
      ta[c] = __fadd_rn(ta[c], expf(__fsub_rn(__fadd_rn(ra[k + 32 * c], p),
                                              ma)));
      tb[c] = __fadd_rn(tb[c], expf(__fsub_rn(__fadd_rn(rb[k + 32 * c], p),
                                              mb)));
    }
  for (; k < n; k += 32) {
    const float p = pot[k];
    ta[0] = __fadd_rn(ta[0], expf(__fsub_rn(__fadd_rn(ra[k], p), ma)));
    tb[0] = __fadd_rn(tb[0], expf(__fsub_rn(__fadd_rn(rb[k], p), mb)));
  }
  float sa = tree_sum<ACC>(ta), sb = tree_sum<ACC>(tb);
  for (int o = 16; o > 0; o >>= 1) {
    sa = __fadd_rn(sa, __shfl_xor_sync(FULL, sa, o));
    sb = __fadd_rn(sb, __shfl_xor_sync(FULL, sb, o));
  }
  ua = __fsub_rn(marg_a, __fadd_rn(logf(sa), ma));
  ub = __fsub_rn(marg_b, __fadd_rn(logf(sb), mb));
}

// u_i = log_mu_i - logsumexp_j(Z_ij + v_j) for the band's rows, a warp a
// row (rows in shared memory through a shared pointer, so that the loads
// are LDS with immediate offsets)
template <class P>
__device__ void u_pass(const Args& a, const Smem& s, P v, int r0, int rows,
                       int C) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  // a warp's two rows li and li + nw at once where both are in shared
  // memory, so that their dependent chains overlap
  for (int li = threadIdx.x >> 5; li < rows; li += 2 * nw) {
    const int lb = li + nw;
    if (lb < rows && lb < a.rows_smem) {
      float ua, ub;
      row_potential2(s.z + li * C, s.z + lb * C, v, C,
                     r0 + li < a.M ? a.norm : a.mu_bin,
                     r0 + lb < a.M ? a.norm : a.mu_bin, lane, ua, ub);
      if (lane == 0) {
        s.u[li] = ua;
        s.u[lb] = ub;
      }
      continue;
    }
    for (int lj = li; lj < rows && lj <= lb; lj += nw) {
      const float marg = r0 + lj < a.M ? a.norm : a.mu_bin;
      const float u =
          lj < a.rows_smem
              ? row_potential(s.z + lj * C, v, C, marg, lane)
              : row_potential(a.Z + (long long)(r0 + lj) * C, v, C, marg,
                              lane);
      if (lane == 0) s.u[lj] = u;
    }
  }
}
// rows [lo, hi) of a column (lo a multiple of ACC): row li into
// accumulator li % ACC wherever the row lives, so that the result does
// not depend on how many rows shared memory holds
template <class X>
__device__ __forceinline__ void col_max(X x, int lo, int hi,
                                        float (&m)[ACC]) {
  int li = lo;
  for (; li + ACC - 1 < hi; li += ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c) m[c] = fmaxf(m[c], x(li + c));
#pragma unroll
  for (int c = 0; c < ACC - 1; ++c)
    if (li + c < hi) m[c] = fmaxf(m[c], x(li + c));
}

template <class X>
__device__ __forceinline__ void col_sum(X x, int lo, int hi, float m,
                                        float (&t)[ACC]) {
  int li = lo;
  for (; li + ACC - 1 < hi; li += ACC)
#pragma unroll
    for (int c = 0; c < ACC; ++c)
      t[c] = __fadd_rn(t[c], expf(__fsub_rn(x(li + c), m)));
#pragma unroll
  for (int c = 0; c < ACC - 1; ++c)
    if (li + c < hi) t[c] = __fadd_rn(t[c], expf(__fsub_rn(x(li + c), m)));
}

// the band's partial of every column with the new u, a thread a column:
// the raw max, and the sum of exps from the max (0 where it is not
// finite), row li in accumulator li % ACC, the accumulators added as a
// tree.  The rows shared memory holds (a multiple of ROWS_ALIGN when the
// band does not fit) come first, then the rest from global memory.
__device__ void v_partials(const Args& a, const Smem& s, int r0, int rows,
                           int C, float* pm, float* ps) {
  const int rs = rows < a.rows_smem ? rows : a.rows_smem;
  const float* su = s.u;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float* zs = s.z + j;
    const float* zg = a.Z + (long long)r0 * C + j;
    auto xs = [&](int li) { return __fadd_rn(zs[li * C], su[li]); };
    auto xg = [&](int li) {
      return __fadd_rn(zg[(long long)li * C], su[li]);
    };
    float t[ACC];
#pragma unroll
    for (int c = 0; c < ACC; ++c) t[c] = -INFINITY;
    col_max(xs, 0, rs, t);
    col_max(xg, rs, rows, t);
    const float mx = tree_max<ACC>(t);
    const float m = isfinite(mx) ? mx : 0.f;
#pragma unroll
    for (int c = 0; c < ACC; ++c) t[c] = 0.f;
    col_sum(xs, 0, rs, m, t);
    col_sum(xg, rs, rows, m, t);
    pm[j] = mx;
    ps[j] = tree_sum<ACC>(t);
  }
}

// a band's share of the merged sum: s_b exp(m_b - m), nothing where the
// band's entries are all -inf
__device__ __forceinline__ float band_term(float pb, float sb, float m) {
  return sb > 0.f ? __fmul_rn(sb, expf(__fsub_rn(isfinite(pb) ? pb : 0.f, m)))
                  : 0.f;
}

__device__ __forceinline__ float v_of(const Args& a, int j, float m,
                                      float s) {
  return __fsub_rn(j < a.N ? a.norm : a.nu_bin, __fadd_rn(logf(s), m));
}

// Z = ((couplings + u) + v) - norm over the band
template <class P>
__device__ void write_band(const Args& a, const Smem& s, P v, int r0,
                           int rows, int C) {
  for (long long k = threadIdx.x; k < (long long)rows * C; k += blockDim.x) {
    const int li = (int)(k / C), j = (int)(k - (long long)li * C);
    const float z = li < a.rows_smem ? s.z[k]
                                     : a.Z[(long long)(r0 + li) * C + j];
    a.Z[(long long)(r0 + li) * C + j] = __fsub_rn(
        __fadd_rn(__fadd_rn(z, s.u[li]), v[j]), a.norm);
  }
}

// VS: v in shared memory (else read from global memory, a.v); PARTS: the
// parts run (PARTS_ALL on the path)
template <bool VS, int PARTS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sinkhorn_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[MGROUPS][MCOLS + 1];
  __shared__ float mcol[MCOLS];
  auto grid = cg::this_grid();
  const int R = a.M + 1, C = a.N + 1;
  const int b = blockIdx.x, nb = gridDim.x;
  const int r0 = band_first(b, nb, R), rows = band_first(b + 1, nb, R) - r0;
  const int c0 = band_first(b, nb, C), c1 = band_first(b + 1, nb, C);
  const Smem s = carve<VS>(reinterpret_cast<float*>(smem4), a, C);
  load_band(a, s, r0, rows, C);
  if (VS) {
    for (int j = threadIdx.x; j < C; j += blockDim.x) s.v[j] = 0.f;
  } else {
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) a.v[j] = 0.f;
    grid.sync();
  }
  __syncthreads();
  const auto v = v_reader(std::integral_constant<bool, VS>{}, s, a);
  const int groups = blockDim.x / MCOLS;
  const int jj = threadIdx.x % MCOLS, grp = threadIdx.x / MCOLS;
  for (int it = 0; it < a.iters; ++it) {
    if (PARTS & PART_U) u_pass(a, s, v, r0, rows, C);
    __syncthreads();
    if (PARTS & PART_V)
      v_partials(a, s, r0, rows, C, a.pm + (long long)b * C,
                 a.ps + (long long)b * C);
    if (PARTS & PART_SYNC) grid.sync();
    // this CTA's slice of the columns, MCOLS at a time: a thread's bands
    // (grp, grp + groups, ...; at most MAXB) read once into registers
    if (PARTS & PART_MERGE)
      for (int base = c0; base < c1; base += MCOLS) {
        const int j = base + jj;
        const bool live = j < c1;
        float pb[MAXB], sb[MAXB];
        float mx = -INFINITY;
#pragma unroll
        for (int q = 0; q < MAXB; ++q) {
          const int bb = grp + q * groups;
          pb[q] = -INFINITY;
          sb[q] = 0.f;
          if (live && bb < nb) {
            pb[q] = __ldcg(a.pm + (long long)bb * C + j);
            sb[q] = __ldcg(a.ps + (long long)bb * C + j);
          }
          mx = fmaxf(mx, pb[q]);
        }
        red[grp][jj] = mx;
        __syncthreads();
        if (threadIdx.x < MCOLS) {
          float x = -INFINITY;
          for (int g = 0; g < groups; ++g) x = fmaxf(x, red[g][threadIdx.x]);
          mcol[threadIdx.x] = isfinite(x) ? x : 0.f;
        }
        __syncthreads();
        const float m = mcol[jj];
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < MAXB; ++q) t = __fadd_rn(t, band_term(pb[q], sb[q], m));
        red[grp][jj] = t;
        __syncthreads();
        if (threadIdx.x < MCOLS && live) {
          float x = 0.f;
          for (int g = 0; g < groups; ++g) x = __fadd_rn(x, red[g][threadIdx.x]);
          a.v[j] = v_of(a, j, m, x);
        }
        __syncthreads();
      }
    if (PARTS & PART_SYNC) grid.sync();
    if (VS && (PARTS & PART_MERGE))
      for (int k = threadIdx.x; k < C; k += blockDim.x)
        s.v[k] = __ldcg(a.v + k);
    __syncthreads();
  }
  write_band(a, s, v, r0, rows, C);
}

// ------------------------------------------- the first design (yardstick)
constexpr int SCAN_WARPS = 8;
constexpr int SCAN_THREADS = 32 * SCAN_WARPS;

struct ScanArgs {
  const float* scores;  // [M, N]
  float* Z;             // [M+1, N+1]
  float* Zt;            // [N+1, M+1], the coupling transposed
  float* u;             // [M+1]
  float* v;             // [N+1]
  int M, N, iters;
  float bin, norm, mu_bin, nu_bin;
};

__global__ void __launch_bounds__(SCAN_THREADS)
    sinkhorn_scan_kernel(ScanArgs a) {
  auto grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int R = a.M + 1, C = a.N + 1;
  const long long gw = (long long)blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  const long long nw = (long long)gridDim.x * SCAN_WARPS;
  const long long gt = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * SCAN_THREADS;

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

// ---------------------------------------------------------- the launches
// The kernel's instantiations: the path's two (v in shared memory or
// not), then the parts that learned_checks.sinkhorn_split times (v in
// shared memory).
using Kernel = void (*)(Args);
constexpr int TIMED_PARTS[] = {PART_SYNC, PART_SYNC | PART_U,
                               PART_SYNC | PART_U | PART_V};
const Kernel KERNELS[] = {sinkhorn_kernel<true, PARTS_ALL>,
                          sinkhorn_kernel<false, PARTS_ALL>,
                          sinkhorn_kernel<true, TIMED_PARTS[0]>,
                          sinkhorn_kernel<true, TIMED_PARTS[1]>,
                          sinkhorn_kernel<true, TIMED_PARTS[2]>};

// What a device offers, queried once a device and process.
struct Device {
  bool ready;
  int sms;
  int smem;         // dynamic shared memory a CTA (the kernel has static
                    // shared memory too)
  int scan_blocks;  // the first design's resident blocks
  int err;
};

constexpr int MAX_DEVICES = 64;
Device devices[MAX_DEVICES];

const Device& device_info() {
  int dev = 0;
  cudaGetDevice(&dev);
  Device& d = devices[dev < MAX_DEVICES ? dev : 0];
  if (d.ready) return d;
  d = Device{};
  int optin = 0, per_sm = 0;
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes fa{};
  cudaFuncGetAttributes(&fa, KERNELS[0]);
  d.smem = optin - (int)fa.sharedSizeBytes;
  for (Kernel k : KERNELS)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         d.smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_scan_kernel,
                                                SCAN_THREADS, 0);
  d.scan_blocks = d.sms * per_sm;
  d.err = (int)cudaGetLastError();
  d.ready = d.err == 0;
  return d;
}

// shared memory bytes of a band of ``rows`` rows, ``rows_smem`` of them
// held there, with v there or not
long long band_bytes(int rows, int rows_smem, int C, bool vs) {
  return 4LL * ((vs ? C : 0) + ((rows + 3) & ~3) +
                (long long)rows_smem * C);
}

int div_up(long long a, long long b) { return (int)((a + b - 1) / b); }

// Threads a CTA: as many as spread the columns evenly over rounds of at
// most MAX_THREADS (the v-partials take a thread a column), at least
// ``least``.
int threads_for(int C, int least) {
  const int rounds = div_up(C, MAX_THREADS);
  int nt = 32 * div_up(div_up(C, rounds), 32);
  if (nt < least) nt = least;
  return nt < MAX_THREADS ? nt : MAX_THREADS;
}

// How an (M+1) x (N+1) coupling runs (see the header).  rows_cap >= 0
// caps the rows a band holds in shared memory (to test the rows read
// from global memory).  plan: CTAs, rows in shared memory a band (a
// multiple of ROWS_ALIGN where the band does not fit), dynamic shared
// memory bytes, rows of the largest band, threads a CTA, v in shared
// memory (1) or in global memory (0).
void make_plan(const Device& d, int M, int N, int rows_cap,
               long long* plan) {
  const int R = M + 1, C = N + 1;
  const int nb = d.sms < R ? d.sms : R;
  const int rows = div_up(R, nb);
  const bool vs = band_bytes(rows, 0, C, true) <= d.smem;
  long long fit = (d.smem - band_bytes(rows, 0, C, vs)) / (4LL * C);
  if (rows_cap >= 0 && fit > rows_cap) fit = rows_cap;
  if (fit >= rows)
    fit = rows;
  else
    fit -= fit % ROWS_ALIGN;
  plan[0] = nb;
  plan[1] = fit;
  plan[2] = band_bytes(rows, (int)fit, C, vs);
  plan[3] = rows;
  // the merge holds at most MAXB bands a thread, MCOLS threads a band
  // group
  plan[4] = threads_for(C, 512 > 16 * div_up(nb, MAXB) ? 512
                                                      : 16 * div_up(nb, MAXB));
  plan[5] = vs;
}

int launch(Kernel k, const float* scores, int M, int N, int iters,
           const float* f, float* Z, float* scratch, const long long* plan,
           void* stream) {
  const int C = N + 1, nb = (int)plan[0];
  Args a{scores, Z, scratch, scratch + (long long)nb * C,
         scratch + 2LL * nb * C, M, N, iters, (int)plan[1], (int)plan[3],
         f[0], f[1], f[2], f[3]};
  void* ptrs[] = {(void*)&a};
  const int err = (int)cudaLaunchCooperativeKernel(
      (const void*)k, dim3(nb), dim3((unsigned)plan[4]), ptrs,
      (size_t)plan[2], (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// The plan of an (M+1) x (N+1) coupling on the current device (see
// make_plan); returns a CUDA error code.
extern "C" int log_sinkhorn_plan(int M, int N, int rows_cap,
                                 long long* plan) {
  const Device& d = device_info();
  if (d.err) return d.err;
  make_plan(d, M, N, rows_cap, plan);
  return 0;
}

// scores [M, N], Z [M+1, N+1]; scratch: pm and ps [CTAs, N+1], then v
// [N+1]; f: bin, norm, the row dustbin's log_mu, the column dustbin's
// log_nu; rows_cap as log_sinkhorn_plan's (-1 on the path).
extern "C" int log_sinkhorn_launch(const float* scores, int M, int N,
                                   int iters, const float* f, float* Z,
                                   float* scratch, int rows_cap,
                                   void* stream) {
  const Device& d = device_info();
  if (d.err) return d.err;
  long long plan[6];
  make_plan(d, M, N, rows_cap, plan);
  return launch(KERNELS[plan[5] ? 0 : 1], scores, M, N, iters, f, Z, scratch,
                plan, stream);
}

// The kernel with some of its parts only, to time them (v in shared
// memory; the rows as planned): parts one of TIMED_PARTS, else
// cudaErrorInvalidValue.  The arguments as log_sinkhorn_launch's.
extern "C" int log_sinkhorn_parts_launch(const float* scores, int M, int N,
                                         int iters, const float* f, float* Z,
                                         float* scratch, int parts,
                                         void* stream) {
  const Device& d = device_info();
  if (d.err) return d.err;
  long long plan[6];
  make_plan(d, M, N, -1, plan);
  for (int i = 0; i < 3; ++i)
    if (parts == TIMED_PARTS[i] && plan[5])
      return launch(KERNELS[2 + i], scores, M, N, iters, f, Z, scratch, plan,
                    stream);
  return (int)cudaErrorInvalidValue;
}

// The first design.  scores [M, N], Z [M+1, N+1], Zt [N+1, M+1]
// (scratch), u [M+1], v [N+1]; f as log_sinkhorn_launch's.
extern "C" int log_sinkhorn_scan_launch(const float* scores, int M, int N,
                                        int iters, const float* f, float* Z,
                                        float* Zt, float* u, float* v,
                                        void* stream) {
  const Device& d = device_info();
  if (d.err) return d.err;
  ScanArgs a{scores, Z, Zt, u, v, M, N, iters, f[0], f[1], f[2], f[3]};
  const long long lines = (M > N ? M : N) + 1;  // a warp a row or column
  long long want = (lines + SCAN_WARPS - 1) / SCAN_WARPS;
  if (want > d.scan_blocks) want = d.scan_blocks;
  if (want < 1) want = 1;
  void* ptrs[] = {(void*)&a};
  const int err = (int)cudaLaunchCooperativeKernel(
      (const void*)sinkhorn_scan_kernel, dim3((unsigned)want),
      dim3(SCAN_THREADS), ptrs, 0, (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}
