// Kernel X: TP-LSD's decoding of its centre and displacement maps.
//
// Replaces the jitted tplsd_decode (limap_tpu/line2d/tp_lsd.py:129).  In:
// the centre map [H, W] f32, the displacements [H, W, 4] f32 (dx1, dy1,
// dx2, dy2); out: segments [K, 5] f32 (x1, y1, x2, y2, score), K =
// max_segs, and the count of peaks among them.  A pixel is a peak where
// it equals the maximum of its (2r+1)^2 window (pixels outside the image
// count as -inf) and exceeds the threshold.  The rows are the top-K of
// the score map (the centre at a peak, 0 elsewhere), ordered by score,
// lower index first among equal scores (lax.top_k's order): the peaks
// first, then non-peak pixels in index order with score 0.
//
// Bound: bytes (the centre map read once, the chosen rows' displacements
// read and the rows written).  Design, five launches on the stream, no
// host synchronisation:
//   1. a thread a pixel: the window maximum, the peak flag, a count a block;
//   2. one block: the exclusive scan of the block counts;
//   3. a thread a pixel: the within-block rank (warp ballots) gives each
//      peak its slot among the peaks in index order, and each non-peak
//      its rank among the non-peaks (kept only where below K);
//   4. a thread a peak: its rank in (score desc, index asc) order counted
//      over all peaks (tiles in shared memory); rank < K writes its row;
//   5. a thread a row beyond the peaks: the next non-peak pixel, score 0.
// Every value is copied or added once with the _rn intrinsics, so the
// rows equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
    peaks_kernel(const float* __restrict__ center, int H, int W, int r,
                 float thresh, unsigned char* __restrict__ flag,
                 int* __restrict__ block_count) {
  __shared__ int warp_counts[THREADS / 32];
  const int N = H * W;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool peak = false;
  if (i < N) {
    const int y = i / W, x = i % W;
    const float c = center[i];
    float m = -INFINITY;
    for (int yy = max(y - r, 0); yy <= min(y + r, H - 1); ++yy)
      for (int xx = max(x - r, 0); xx <= min(x + r, W - 1); ++xx)
        m = fmaxf(m, center[yy * W + xx]);
    peak = (c == m) && (c > thresh);
    flag[i] = peak ? 1 : 0;
  }
  const unsigned ballot = __ballot_sync(FULL, peak);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_counts[w];
    block_count[blockIdx.x] = s;
  }
}

// one block: exclusive scan of n block counts, the total at offset[n]
__global__ void __launch_bounds__(1024)
    scan_kernel(const int* __restrict__ count, int n, int* __restrict__ offset) {
  __shared__ int part[1024];
  const int t = threadIdx.x;
  const int per = (n + 1023) / 1024;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int j = lo; j < hi; ++j) s += count[j];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {
    const int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = t ? part[t - 1] : 0;
  for (int j = lo; j < hi; ++j) {
    offset[j] = run;
    run += count[j];
  }
  if (t == 1023) offset[n] = part[1023];
}

__global__ void __launch_bounds__(THREADS)
    compact_kernel(const unsigned char* __restrict__ flag, int N,
                   const int* __restrict__ offset, int K,
                   int* __restrict__ peak_idx, int* __restrict__ rest_idx) {
  __shared__ int warp_prefix[THREADS / 32];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool peak = i < N && flag[i];
  const unsigned ballot = __ballot_sync(FULL, peak);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_prefix[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = warp_prefix[w];
      warp_prefix[w] = s;
      s += c;
    }
  }
  __syncthreads();
  if (i >= N) return;
  const int before = offset[blockIdx.x] + warp_prefix[warp]
                     + __popc(ballot & ((1u << lane) - 1u));
  if (peak) {
    peak_idx[before] = i;
  } else {
    const int rank = i - before;  // non-peaks before this pixel
    if (rank < K) rest_idx[rank] = i;
  }
}

__device__ __forceinline__ void write_row(const float* __restrict__ disp,
                                          int W, int idx, float score,
                                          float* __restrict__ row) {
  const float x = (float)(idx % W), y = (float)(idx / W);
  const float* d = disp + 4LL * idx;
  row[0] = __fadd_rn(x, d[0]);
  row[1] = __fadd_rn(y, d[1]);
  row[2] = __fadd_rn(x, d[2]);
  row[3] = __fadd_rn(y, d[3]);
  row[4] = score;
}

__global__ void __launch_bounds__(THREADS)
    rank_kernel(const float* __restrict__ center,
                const float* __restrict__ disp, int W,
                const int* __restrict__ peak_idx,
                const int* __restrict__ total, int K,
                float* __restrict__ segs) {
  __shared__ float tile_s[THREADS];
  __shared__ int tile_i[THREADS];
  const int P = *total;
  if (blockIdx.x * THREADS >= P) return;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool live = p < P;
  const int my_i = live ? peak_idx[p] : 0;
  const float my_s = live ? center[my_i] : 0.f;
  int rank = 0;
  for (int base = 0; base < P; base += THREADS) {
    const int q = base + threadIdx.x;
    if (q < P) {
      tile_i[threadIdx.x] = peak_idx[q];
      tile_s[threadIdx.x] = center[tile_i[threadIdx.x]];
    }
    __syncthreads();
    const int n = min(THREADS, P - base);
    if (live)
      for (int j = 0; j < n; ++j) {
        const float s = tile_s[j];
        rank += (s > my_s) || (s == my_s && tile_i[j] < my_i);
      }
    __syncthreads();
  }
  if (live && rank < K) write_row(disp, W, my_i, my_s, segs + 5LL * rank);
}

__global__ void __launch_bounds__(THREADS)
    fill_kernel(const float* __restrict__ disp, int W,
                const int* __restrict__ rest_idx,
                const int* __restrict__ total, int K,
                float* __restrict__ segs, int* __restrict__ count) {
  const int P = *total;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s == 0) *count = min(P, K);
  if (s >= K || s < P) return;
  write_row(disp, W, rest_idx[s - P], 0.f, segs + 5LL * s);
}

}  // namespace

// scratch: flag [N] u8, block_count [B], offset [B + 1], peak_idx [N],
// rest_idx [K] (B = ceil(N / 256))
extern "C" int tplsd_decode_launch(const float* center, const float* disp,
                                   int H, int W, int K, float thresh, int r,
                                   unsigned char* flag, int* block_count,
                                   int* offset, int* peak_idx, int* rest_idx,
                                   float* segs, int* count, void* stream) {
  const int N = H * W;
  if (N <= 0 || K <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = (N + THREADS - 1) / THREADS;
  peaks_kernel<<<B, THREADS, 0, st>>>(center, H, W, r, thresh, flag,
                                      block_count);
  scan_kernel<<<1, 1024, 0, st>>>(block_count, B, offset);
  compact_kernel<<<B, THREADS, 0, st>>>(flag, N, offset, K, peak_idx,
                                        rest_idx);
  rank_kernel<<<B, THREADS, 0, st>>>(center, disp, W, peak_idx, offset + B,
                                     K, segs);
  fill_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      disp, W, rest_idx, offset + B, K, segs, count);
  return (int)cudaGetLastError();
}
