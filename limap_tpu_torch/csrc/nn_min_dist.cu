// Nearest-neighbour distance of query points to a point cloud, for sm_90a.
//
// Replaces the Pallas TPU kernel limap_tpu/ops/pallas/nn_distance.py
// (min_dist_pallas / _kernel): out[i] = min_j ||q_i - p_j||.
//
// Two kernels.  nn_filter_kernel (entry nn_min_dist_launch) is the one
// the port runs.  nn_min_dist_scalar_kernel (entry
// nn_min_dist_scalar_launch) is the CUDA-core kernel it is timed against.
//
// What bounds the function.  Operations, not bytes: S * M pairs against
// 12 bytes a point and 16 a query.  On the CUDA cores a pair in the exact
// difference form takes 7 instructions (3 FADD, 1 FMUL, 2 FFMA, 1 FMNMX)
// and a shared-memory load, and no tiling gets under that.  So the bulk
// of the pairs goes to the tensor cores, and the CUDA cores see a pair
// only where it may matter.
//
// Design of nn_filter_kernel: the tensor cores filter, the CUDA cores
// confirm.  The wrapper (ops/nn_distance.py) centres queries and cloud,
// rounds every cloud point to TF32 (p~) and splits every query
// coordinate into two TF32 pieces.  For a 16 x 8 tile of (query, point)
// pairs ONE mma.sync.m16n8k8 (TF32 in, fp32 out; all its products are
// exact) computes
//   d = pp_hi + pp_lo - 2 (s_hi + s_lo).p~ - thr
//     ~ ||s' - p~||^2 - ||s'||^2 - thr,
// with -thr of the pair's query row as the accumulator input.  Every
// query row keeps best, the smallest exact squared distance it has
// confirmed, and
//   thr = (sqrt(best) + delta)^2 + E - ||s'||^2,
// where delta = max ||p' - p~|| is how far rounding moved a point and E
// bounds the arithmetic error of d (derived in ops/nn_distance.py).  A
// pair with d >= 0 cannot beat best and costs nothing more: the epilogue
// ORs the bit patterns of all the d of a step and branches on the sign.
// A pair with d < 0 is rare (the running minimum's transient and the few
// points within about sqrt(E) + delta of the nearest one's distance): its
// thread reads the raw query and the raw point from global memory, takes
// dx^2 + dy^2 + dz^2 in fp32 as the scalar kernel does, and lowers best
// and thr.  The nearest point always passes, so the final best is the
// exact minimum, bit for bit the scalar kernel's.  Output
// sqrt(max(best, 0)).
//
// Why one product.  A loop of independent mma.sync.m16n8k8 TF32 alone
// takes 6.6 clocks an instruction on each of an SM's four tensor cores
// (H100, 1.98 GHz), two thirds of the data sheet's rate, and nothing in
// this kernel overlaps with it fully, so every mma counts.  The usual
// 3xTF32 split of both operands needs k = 11 and so two products a tile.
// Rounding the cloud instead costs no accuracy of the result, only a
// threshold that is delta wider.
//
// Layout.  A block of 8 warps owns 256 queries; a warp owns 2 row tiles
// of 16 queries, whose A fragments (4 registers a tile) stay in registers
// for the whole scan; three blocks share an SM.  The block walks the cloud
// operand [M_pad, 8] in stages of 1024 points (32 KB), double-buffered
// with cp.async in dynamic shared memory.  The wrapper stores the operand
// in fragment order: for every two tiles of 8 points the four words a
// lane feeds to its two mma stand together, so a stage is a straight copy
// and a lane's fragments are one conflict-free 16-byte load.  All the
// independent mma of a step (4 cloud tiles x 2 row tiles) are issued back
// to back and one branch covers the step: a warp issues in order, and a
// branch per row tile would put an mma's whole latency between two of
// them.  The four lanes that share a query row each see two of a tile's
// eight points and keep their own best / thr; they exchange best after
// every stage and at the end.  Query rows past S carry thr = -inf and
// never pass; cloud rows past M carry pp_hi = 1e30 and are refused by
// index where thr is still +inf.
//
// What is in the way now.  Per mma the epilogue is two 3-input ORs on
// the half-rate integer pipe, and with them, the shared-memory loads and
// the barriers a step takes about twice its tensor time: issue order and
// latency, not one unit's throughput, bound the kernel.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 fragments, with
// g = lane >> 2, t = lane & 3:
//   a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
//   b0 = B[k=t][n=g], b1 = B[k=t+4][n=g];
//   d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
// nn_filter_tile_kernel writes D (with a zero accumulator input) out
// through the same staging and fragment code, so a test can hold this
// layout to a matrix product.
//
// Later work: wgmma in place of mma.sync (asynchronous, 64-row tiles, the
// only way to the card's full TF32 rate), with the sign test of one tile
// under the next tile's product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// Tensor-core filter with exact confirm
// ---------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kFilterThreads = kWarps * 32;
constexpr int kRowTiles = 2;                          // per warp
constexpr int kBlockRows = kWarps * kRowTiles * 16;   // query padding
constexpr int kChunk = 1024;                          // cloud padding
constexpr int kTilesPerStep = 4;  // 8-point tiles between two branches
constexpr int kStageWords = kChunk * 8;
constexpr int kSmemBytes = 2 * kStageWords * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem, const float4* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies one stage of the cloud operand (kStageWords words from `rows`).
__device__ __forceinline__ void stage_load(float* stage, const float4* rows,
                                           int tid) {
  for (int idx = tid; idx < kStageWords / 4; idx += kFilterThreads)
    cp_async16(stage + idx * 4, rows + idx);
}

// The A fragment of the 16 query rows from `row`.
__device__ __forceinline__ void load_a(const float* __restrict__ A,
                                       long long row, int g, int t,
                                       uint32_t (&a)[4]) {
  const float* lo = A + (row + g) * 8 + t;
  const float* hi = lo + 8 * 8;
  a[0] = __float_as_uint(lo[0]);
  a[1] = __float_as_uint(hi[0]);
  a[2] = __float_as_uint(lo[4]);
  a[3] = __float_as_uint(hi[4]);
}

// This lane's B fragments of the two tiles of 8 points from `tile` (even)
// in `stage`: the wrapper stores the operand in fragment order, the four
// words (b0, b1 of the one tile, b0, b1 of the other) of a lane together.
__device__ __forceinline__ void load_b(const float* stage, int tile, int lane,
                                       uint32_t (&b0)[2], uint32_t (&b1)[2]) {
  const float4 w =
      reinterpret_cast<const float4*>(stage)[(tile >> 1) * 32 + lane];
  b0[0] = __float_as_uint(w.x);
  b1[0] = __float_as_uint(w.y);
  b0[1] = __float_as_uint(w.z);
  b1[1] = __float_as_uint(w.w);
}

// d = a . b + (c_lo, c_lo, c_hi, c_hi): c_lo goes to row g, c_hi to g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, float c_lo,
                                         float c_hi) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%11,%11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c_lo), "f"(c_hi));
}

// -thr of a row whose confirmed minimum is `best` (>= 0, +inf at first):
// two_delta > 0, so best = +inf gives -inf and everything passes.
__device__ __forceinline__ float neg_threshold(float best, float two_delta,
                                               float off) {
  return -(best + two_delta * sqrtf(best) + off);
}

__global__ void __launch_bounds__(kFilterThreads, 3)
nn_filter_kernel(const float* __restrict__ A, const float* __restrict__ ss,
                 const float* __restrict__ err,
                 const float* __restrict__ delta, long long S,
                 const float* __restrict__ q, const float* __restrict__ B,
                 long long M_pad, long long M, const float* __restrict__ p,
                 float* __restrict__ out, unsigned long long* confirms) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * kBlockRows +
                         (tid >> 5) * (kRowTiles * 16);
  const float two_delta = 2.f * delta[0];

  uint32_t a[kRowTiles][4];
  // per query row g + 8 h of row tile r: the confirmed minimum, the
  // constant part of its threshold, and minus the threshold
  float best[kRowTiles][2], off[kRowTiles][2], nthr[kRowTiles][2];
#pragma unroll
  for (int r = 0; r < kRowTiles; ++r) {
    load_a(A, row0 + r * 16, g, t, a[r]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + r * 16 + g + 8 * h;
      best[r][h] = INFINITY;
      off[r][h] = delta[0] * delta[0] + err[row] - ss[row];
      nthr[r][h] = row < S ? -INFINITY : INFINITY;
    }
  }
  unsigned n_confirms = 0;

  // d of one step: kTilesPerStep cloud tiles x kRowTiles row tiles
  float d[kTilesPerStep][kRowTiles][4];

  // All the step's independent mma, back to back: d = filter value minus
  // the row's threshold as it stands.
  auto issue = [&](const float* stage, int tile) {
    uint32_t b0[kTilesPerStep / 2][2], b1[kTilesPerStep / 2][2];
#pragma unroll
    for (int u = 0; u < kTilesPerStep / 2; ++u)
      load_b(stage, tile + 2 * u, lane, b0[u], b1[u]);
#pragma unroll
    for (int u = 0; u < kTilesPerStep; ++u)
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
        mma_tf32(d[u][r], a[r], b0[u >> 1][u & 1], b1[u >> 1][u & 1],
                 nthr[r][0], nthr[r][1]);
  };

  // One branch for the step whose first point is `j0`: the sign of the
  // OR of all its d.  Behind it, the exact confirm of every pair with
  // d < 0.  d is against the threshold of the step's start; a threshold
  // lowered on the way only makes a later confirm superfluous.
  auto check = [&](long long j0) {
    // one OR chain per cloud tile, so that a chain is short and starts
    // as soon as its tile's mma are done
    uint32_t signs[kTilesPerStep];
#pragma unroll
    for (int u = 0; u < kTilesPerStep; ++u) {
      signs[u] = 0;
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) signs[u] |= __float_as_uint(d[u][r][k]);
    }
    uint32_t sign = 0;
#pragma unroll
    for (int u = 0; u < kTilesPerStep; ++u) sign |= signs[u];
    if (sign >> 31) {
#pragma unroll
      for (int u = 0; u < kTilesPerStep; ++u)
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int h = k >> 1;
            const long long j = j0 + u * 8 + 2 * t + (k & 1);
            if (d[u][r][k] < 0.f && j < M) {
              const float* qi = q + 3 * (row0 + r * 16 + g + 8 * h);
              const float* pj = p + 3 * j;
              const float dx = qi[0] - pj[0];
              const float dy = qi[1] - pj[1];
              const float dz = qi[2] - pj[2];
              best[r][h] =
                  fminf(best[r][h], fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
              nthr[r][h] = neg_threshold(best[r][h], two_delta, off[r][h]);
              ++n_confirms;
            }
          }
    }
  };

  const float4* rows = reinterpret_cast<const float4*>(B);
  const long long n_chunks = M_pad / kChunk;
  stage_load(smem, rows, tid);
  cp_async_commit();
  for (long long c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      stage_load(smem + ((c + 1) & 1) * kStageWords,
                 rows + (c + 1) * (kStageWords / 4), tid);
    cp_async_commit();   // an empty group after the last stage
    cp_async_wait<1>();  // all but the newest group: stage c has landed
    __syncthreads();
    const float* stage = smem + (c & 1) * kStageWords;
    for (int tile = 0; tile < kChunk / 8; tile += kTilesPerStep) {
      issue(stage, tile);
      check(c * kChunk + tile * 8);
    }
    // the four lanes of a row share what they found
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float b = best[r][h];
        b = fminf(b, __shfl_xor_sync(0xffffffffu, b, 1));
        b = fminf(b, __shfl_xor_sync(0xffffffffu, b, 2));
        best[r][h] = b;
        if (row0 + r * 16 + g + 8 * h < S)
          nthr[r][h] = neg_threshold(b, two_delta, off[r][h]);
      }
    }
    __syncthreads();  // stage c is free for the load of stage c + 2
  }

  if (t == 0) {
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + r * 16 + g + 8 * h;
        if (row < S) out[row] = sqrtf(fmaxf(best[r][h], 0.f));
      }
    }
  }
  n_confirms = __reduce_add_sync(0xffffffffu, n_confirms);
  if (lane == 0 && n_confirms)
    atomicAdd(confirms, (unsigned long long)n_confirms);
}

// D [S_pad, kChunk]: the filter values (zero accumulator input) of every
// query row against the first stage of the cloud operand, by the staging
// and fragment code of nn_filter_kernel.
__global__ void __launch_bounds__(kFilterThreads)
nn_filter_tile_kernel(const float* __restrict__ A,
                      const float* __restrict__ B, float* __restrict__ D) {
  extern __shared__ __align__(16) float stage[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * kBlockRows +
                         (tid >> 5) * (kRowTiles * 16);
  stage_load(stage, reinterpret_cast<const float4*>(B), tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = 0; r < kRowTiles; ++r) {
    uint32_t a[4];
    load_a(A, row0 + r * 16, g, t, a);
    for (int tile = 0; tile < kChunk / 8; tile += 2) {
      uint32_t b0[2], b1[2];
      load_b(stage, tile, lane, b0, b1);
      for (int u = 0; u < 2; ++u) {
        float d[4];
        mma_tf32(d, a, b0[u], b1[u], 0.f, 0.f);
        float* lo =
            D + (row0 + r * 16 + g) * kChunk + (tile + u) * 8 + 2 * t;
        float* hi = lo + 8 * kChunk;
        lo[0] = d[0];
        lo[1] = d[1];
        hi[0] = d[2];
        hi[1] = d[3];
      }
    }
  }
}

// ---------------------------------------------------------------------
// CUDA-core kernel: the yardstick
// ---------------------------------------------------------------------
//
// One thread owns one query point and keeps the running minimum of
// dx^2 + dy^2 + dz^2 in a register.  A block of kThreads threads stages
// tiles of kTile cloud points in shared memory (as float4, so each point
// is one broadcast 16-byte load) and walks the whole cloud tile by tile.
// The ragged last tile is masked by its index; nothing is padded.
// Bound: about 8 fp32 operations per pair, so S * M * 8 / fp32 peak at
// the fused multiply-add rate; in issue slots 7 instructions a pair
// against 132 SMs x 128 lanes x clock, about 1.75 times that.

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // 32 KB of float4 per block

__global__ void __launch_bounds__(kThreads)
nn_min_dist_scalar_kernel(const float* __restrict__ q, long long S,
                          const float* __restrict__ p, long long M,
                          float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < S) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = INFINITY;
  for (long long base = 0; base < M; base += kTile) {
    const int n = (int)(M - base < kTile ? M - base : kTile);
    __syncthreads();  // the previous tile is fully consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* pj = p + 3 * (base + j);
      tile[j] = make_float4(pj[0], pj[1], pj[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 c = tile[j];
      const float dx = qx - c.x;
      const float dy = qy - c.y;
      const float dz = qz - c.z;
      best = fminf(best, fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
    }
  }
  if (i < S) out[i] = sqrtf(fmaxf(best, 0.f));
}

bool grid_fits(long long blocks) { return blocks <= 0x7fffffffLL; }

// Lets `kernel` use `bytes` of dynamic shared memory (above the 48 KB a
// kernel may have without asking).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The tensor-core kernel.  A [S_pad, 8], ss [S_pad], err [S_pad],
// delta [1] (> 0) and B [M_pad, 8] as ops/nn_distance.py lays them out
// (S_pad a multiple of 256 rows, M_pad of 1024, B in fragment order);
// queries [S, 3], points [M, 3] raw, M >= 1; out [S]; confirms: one
// counter, incremented by the number of pairs confirmed exactly.  All
// contiguous on the device.  Launches on `stream` and returns a
// cudaError_t (0 on success).
extern "C" int nn_min_dist_launch(const float* A, const float* ss,
                                  const float* err, const float* delta,
                                  long long S_pad, long long S,
                                  const float* queries, const float* B,
                                  long long M_pad, long long M,
                                  const float* points, float* out,
                                  unsigned long long* confirms,
                                  void* stream) {
  if (S <= 0) return 0;
  if (M <= 0 || S > S_pad || M > M_pad || S_pad % kBlockRows ||
      M_pad % kChunk || !grid_fits(S_pad / kBlockRows))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_shared(nn_filter_kernel, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  nn_filter_kernel<<<(unsigned)(S_pad / kBlockRows), kFilterThreads,
                     kSmemBytes, (cudaStream_t)stream>>>(
      A, ss, err, delta, S, queries, B, M_pad, M, points, out, confirms);
  return (int)cudaGetLastError();
}

// D [S_pad, 1024] = filter values of A [S_pad, 8] against the first 1024
// rows of B [M_pad, 8] (in fragment order).
extern "C" int nn_filter_tile_launch(const float* A, long long S_pad,
                                     const float* B, long long M_pad,
                                     float* D, void* stream) {
  if (S_pad <= 0 || M_pad < kChunk || S_pad % kBlockRows ||
      !grid_fits(S_pad / kBlockRows))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_shared(nn_filter_tile_kernel, kSmemBytes / 2);
  if (e != cudaSuccess) return (int)e;
  nn_filter_tile_kernel<<<(unsigned)(S_pad / kBlockRows), kFilterThreads,
                          kSmemBytes / 2, (cudaStream_t)stream>>>(A, B, D);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel.  queries [S, 3], points [M, 3], out [S]:
// contiguous fp32 on the device.
extern "C" int nn_min_dist_scalar_launch(const float* queries, long long S,
                                         const float* points, long long M,
                                         float* out, void* stream) {
  if (S <= 0) return 0;
  const long long blocks = (S + kThreads - 1) / kThreads;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
  nn_min_dist_scalar_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(queries, S, points, M,
                                                      out);
  return (int)cudaGetLastError();
}
