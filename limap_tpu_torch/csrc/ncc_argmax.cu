// Kernel W: the row argmax and max of a correlation matrix that is never
// written.
//
// Replaces the jitted _ncc_flow (limap_tpu/line2d/dense.py:57), f1 @ f2.T
// followed by argmax and max over each row.  In: f1 [N1, D], f2 [N2, D]
// f32 (D <= 64; the dense matcher's 8 x 8 patches); out: index [N1] int64,
// score [N1] f32, the first index among equal maxima.
//
// Bound: operations (2 N1 N2 D fp32, 7.2e9 for 7,500 x 7,500 x 64; the
// inputs are 3.8 MB).  Design: a block 32 rows of f1, kept in shared
// memory with f2's tiles of 64 rows; thread (row, lane8) takes every 8th
// column of a tile, each dot a chain of fp32 fmaf over d in order (no
// TF32); a thread keeps its first best, and the 8 threads of a row
// combine theirs (larger score, then smaller index).  The dots round
// otherwise than the plain version's matrix product, so a row's index may
// differ from it where its two best dots lie within float32 rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 64;
constexpr int ROWS = 32;       // rows of f1 a block
constexpr int COLS = 64;       // rows of f2 a tile
constexpr int LANES = 8;       // threads a row
constexpr int THREADS = ROWS * LANES;

__global__ void __launch_bounds__(THREADS)
    ncc_kernel(const float* __restrict__ f1, int N1,
               const float* __restrict__ f2, int N2, int D,
               int64_t* __restrict__ idx_out, float* __restrict__ score_out) {
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

extern "C" int ncc_argmax_launch(const float* f1, int N1, const float* f2,
                                 int N2, int D, int64_t* idx, float* score,
                                 void* stream) {
  if (N1 <= 0 || N2 <= 0) return 0;
  const int blocks = (N1 + ROWS - 1) / ROWS;
  ncc_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(f1, N1, f2, N2, D,
                                                           idx, score);
  return (int)cudaGetLastError();
}
