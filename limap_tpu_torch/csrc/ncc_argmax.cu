// Kernel W: the row and the column argmax and max of a correlation matrix
// that is never written.
//
// Replaces the jitted _ncc_flow (limap_tpu/line2d/dense.py:57), f1 @ f2.T
// followed by argmax and max over each row, which the dense matcher calls
// once a direction (:112-117); the second direction's matrix f2 @ f1.T is
// the first one's transpose, so one pass over f1 @ f2.T gives both.  In:
// f1 [N1, D], f2 [N2, D] f32 (D <= 64; the dense matcher's 8 x 8
// patches); out: index [N1] int64 and score [N1] f32 a row, index [N2]
// and score [N2] a column, the first index among equal maxima.
//
// Bound: operations (2 N1 N2 D fp32 for both directions, 7.2e9 for
// 7,500 x 7,500 x 64; the inputs are 3.8 MB).
//
// Design (ncc_both_kernel).  A block owns a 128 x 128 tile of the
// product; the grid covers N1 x N2.  Both operand tiles (128 rows x D)
// are staged once in shared memory, transposed to [d][row] so that a
// thread reads four consecutive rows of one channel as a float4.  Each
// of 256 threads accumulates an 8 x 8 register tile: rows
// 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns likewise with tx (tx,
// ty = the thread's position in a 16 x 16 grid), so a quarter warp's
// float4 reads of the B tile cover 128 consecutive bytes (no bank
// conflict) and the A tile's are broadcasts: 4 shared loads a channel for
// 64 multiply-adds, where the row scan made 2 loads a multiply-add.
// Each dot is a chain of fp32 fmaf over d = 0..D-1 in order from 0.f,
// the chain the row scan computes (fmaf(a, b, s) = fmaf(b, a, s)), so a
// column's dots equal those of f2 @ f1.T by the row scan bit for bit.  No
// TF32: it would move the argmax.
//
// Epilogue.  A score and its index go into one 64-bit key: the high word
// is the score mapped to an order-preserving unsigned integer (-0.0
// first made +0.0, which torch.max holds equal to it), the low word
// 0xFFFFFFFF - index, so the larger key is the larger score and, among
// equal scores, the smaller index.  A thread keeps the largest key of
// each of its rows and columns; the 16 threads of a row combine theirs
// by shuffles, the columns by a shuffle and then across the 8 warps in
// shared memory; one 64-bit atomicMax a row and a column a block
// publishes them into keys [N1 + N2], zeroed by the launch
// (cudaMemsetAsync: 0 is below every key).  ncc_unpack_kernel turns the
// keys into indices and scores.  On finite inputs the result is
// torch.max's on the kernel's dots.  Three launches a pair in all.
//
// ncc_rowscan_kernel is the first design, kept as the yardstick of the
// time (no path launches it): a block 32 rows of f1 in shared memory
// over f2's tiles of 64 rows, each thread one dot at a time, one
// direction a launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 64;

// ---------------------------------------------------------------- both
constexpr int TILE = 128;             // rows of f1 and of f2 a block
constexpr int LD = TILE + 4;          // a channel's row in shared memory
constexpr int BOTH_THREADS = 256;     // a 16 x 16 grid of 8 x 8 tiles
constexpr int BOTH_SMEM = 2 * MAXD * LD * (int)sizeof(float);
typedef unsigned long long nkey;

__device__ __forceinline__ uint32_t ordered(float s) {
  s = s == 0.f ? 0.f : s;             // -0.0 -> +0.0
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ nkey make_key(uint32_t o, int index) {
  return ((nkey)o << 32) | (nkey)(0xffffffffu - (uint32_t)index);
}

__device__ __forceinline__ nkey kmax(nkey a, nkey b) {
  return a > b ? a : b;
}

// the thread's i-th row (or column) of the block's tile
__device__ __forceinline__ int sub(int i, int t) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

__global__ void __launch_bounds__(BOTH_THREADS, 2)
    ncc_both_kernel(const float* __restrict__ f1, int N1,
                    const float* __restrict__ f2, int N2, int D,
                    nkey* __restrict__ row_keys,
                    nkey* __restrict__ col_keys) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                   // [MAXD][LD]: f1's tile, transposed
  float* Bs = smem + MAXD * LD;       // [MAXD][LD]: f2's tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  // stage both tiles: consecutive threads read consecutive floats
  for (int t = tid; t < TILE * D; t += BOTH_THREADS) {
    const int r = t / D, d = t - r * D;
    const int gi = row0 + r, gj = col0 + r;
    As[d * LD + r] = gi < N1 ? f1[(long long)gi * D + d] : 0.f;
    Bs[d * LD + r] = gj < N2 ? f2[(long long)gj * D + d] : 0.f;
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[d * LD + 4 * ty]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&As[d * LD + 64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[d * LD + 4 * tx]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&Bs[d * LD + 64 + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }

  // the thread's best key of each of its rows and columns (0: none)
  nkey rk[8], ck[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rk[i] = ck[i] = 0ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + sub(i, ty);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = col0 + sub(j, tx);
      if (gi < N1 && gj < N2) {
        const uint32_t o = ordered(acc[i][j]);
        rk[i] = kmax(rk[i], make_key(o, gj));
        ck[j] = kmax(ck[j], make_key(o, gi));
      }
    }
  }

  // rows: the 16 threads of a row group are one half warp
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      rk[i] = kmax(rk[i], __shfl_xor_sync(0xffffffffu, rk[i], o));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + sub(i, ty);
    if (tx == i && gi < N1 && rk[i]) atomicMax(&row_keys[gi], rk[i]);
  }

  // columns: the two row groups of a warp by a shuffle, then the 8 warps
  // through shared memory (the operand tiles are no longer read)
#pragma unroll
  for (int j = 0; j < 8; ++j)
    ck[j] = kmax(ck[j], __shfl_xor_sync(0xffffffffu, ck[j], 16));
  __syncthreads();
  nkey* part = reinterpret_cast<nkey*>(smem);   // [8 warps][TILE]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j) part[warp * TILE + sub(j, tx)] = ck[j];
  }
  __syncthreads();
  if (tid < TILE) {
    nkey k = 0ull;
#pragma unroll
    for (int w = 0; w < BOTH_THREADS / 32; ++w)
      k = kmax(k, part[w * TILE + tid]);
    const int gj = col0 + tid;
    if (gj < N2 && k) atomicMax(&col_keys[gj], k);
  }
}

__global__ void ncc_unpack_kernel(const nkey* __restrict__ keys, int N1,
                                  int N2, int64_t* __restrict__ idx12,
                                  float* __restrict__ s12,
                                  int64_t* __restrict__ idx21,
                                  float* __restrict__ s21) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N1 + N2) return;
  const nkey key = keys[k];
  const int64_t index =
      (int64_t)(0xffffffffu - (uint32_t)(key & 0xffffffffull));
  const float score = unordered((uint32_t)(key >> 32));
  if (k < N1) {
    idx12[k] = index;
    s12[k] = score;
  } else {
    idx21[k - N1] = index;
    s21[k - N1] = score;
  }
}

// ------------------------------------------------------- row scan
constexpr int ROWS = 32;       // rows of f1 a block
constexpr int COLS = 64;       // rows of f2 a tile
constexpr int LANES = 8;       // threads a row
constexpr int THREADS = ROWS * LANES;

__global__ void __launch_bounds__(THREADS)
    ncc_rowscan_kernel(const float* __restrict__ f1, int N1,
                       const float* __restrict__ f2, int N2, int D,
                       int64_t* __restrict__ idx_out,
                       float* __restrict__ score_out) {
  __shared__ float a[ROWS][MAXD + 1];
  __shared__ float b[COLS][MAXD + 1];
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + row;
  for (int t = threadIdx.x; t < ROWS * D; t += THREADS) {
    const int r = t / D, d = t % D;
    const int gi = blockIdx.x * ROWS + r;
    a[r][d] = gi < N1 ? f1[(long long)gi * D + d] : 0.f;
  }
  float best = -INFINITY;
  int best_j = 0x7fffffff;
  for (int base = 0; base < N2; base += COLS) {
    __syncthreads();
    for (int t = threadIdx.x; t < COLS * D; t += THREADS) {
      const int r = t / D, d = t % D;
      const int gj = base + r;
      b[r][d] = gj < N2 ? f2[(long long)gj * D + d] : 0.f;
    }
    __syncthreads();
    for (int c = lane; c < COLS; c += LANES) {
      const int j = base + c;
      if (j >= N2) break;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(a[row][d], b[c][d], s);
      // columns come in increasing order: keep the first best
      if (best_j == 0x7fffffff || s > best) {
        best = s;
        best_j = j;
      }
    }
  }
  // combine the LANES threads of a row (consecutive lanes of one warp)
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o, LANES);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, o, LANES);
    if (ob > best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
  }
  if (lane == 0 && i < N1) {
    idx_out[i] = best_j;
    score_out[i] = best;
  }
}

}  // namespace

// keys: scratch of N1 + N2 64-bit words; the launch zeroes it
extern "C" int ncc_argmax_both_launch(const float* f1, int N1, const float* f2,
                                      int N2, int D, void* keys,
                                      int64_t* idx12, float* s12,
                                      int64_t* idx21, float* s21,
                                      void* stream) {
  if (N1 <= 0 || N2 <= 0) return 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        ncc_both_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BOTH_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      keys, 0, sizeof(nkey) * ((size_t)N1 + (size_t)N2), s);
  if (e != cudaSuccess) return (int)e;
  nkey* k = (nkey*)keys;
  const dim3 grid((N2 + TILE - 1) / TILE, (N1 + TILE - 1) / TILE);
  ncc_both_kernel<<<grid, BOTH_THREADS, BOTH_SMEM, s>>>(f1, N1, f2, N2, D, k,
                                                        k + N1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = N1 + N2;
  ncc_unpack_kernel<<<(n + 255) / 256, 256, 0, s>>>(k, N1, N2, idx12, s12,
                                                    idx21, s21);
  return (int)cudaGetLastError();
}

extern "C" int ncc_argmax_rowscan_launch(const float* f1, int N1,
                                         const float* f2, int N2, int D,
                                         int64_t* idx, float* score,
                                         void* stream) {
  if (N1 <= 0 || N2 <= 0) return 0;
  const int blocks = (N1 + ROWS - 1) / ROWS;
  ncc_rowscan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      f1, N1, f2, N2, D, idx, score);
  return (int)cudaGetLastError();
}
