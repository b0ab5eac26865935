// Nearest-neighbour distance of query points to a point cloud, for sm_90a.
//
// Replaces the Pallas TPU kernel limap_tpu/ops/pallas/nn_distance.py
// (min_dist_pallas / _kernel): out[i] = min_j ||q_i - p_j||.
//
// Design.  One thread owns one query point and keeps the running minimum
// of dx^2 + dy^2 + dz^2 in a register.  A block of kThreads threads stages
// tiles of kTile cloud points in shared memory (as float4, so each point
// is one broadcast 16-byte load) and walks the whole cloud tile by tile:
// this loop takes the place of the TPU grid's sequential cloud axis.  The
// distance is taken in the difference form, which is exact in fp32, not
// the expanded ||q||^2 + ||p||^2 - 2 q.p the TPU kernel needs for its
// matrix unit (that form cancels badly near zero).  The ragged last tile
// is masked by its index; nothing is padded.  Output: sqrt(max(min, 0)).
//
// Bound.  About 8 fp32 operations per (query, point) pair on the CUDA
// cores (3 subtractions, a multiply, two fused multiply-adds, a min),
// so S * M * 8 / fp32 peak; the bytes moved (12 per point read, 16 per
// query) are negligible beside that.  That bound counts every operation
// at the fused multiply-add rate (the 67 TFLOP/s peak counts an FMA as
// two).  In issue slots a pair takes 7 instructions (3 FADD, 1 FMUL,
// 2 FFMA, 1 FMNMX) against 132 SMs x 128 lanes x clock, about 1.75 times
// the operation bound.  Later work: the expanded form on
// tensor cores with split fp32 (3xTF32) via wgmma, several queries per
// thread to amortize each shared-memory load, TMA staging.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // 32 KB of float4 per block

__global__ void __launch_bounds__(kThreads)
nn_min_dist_kernel(const float* __restrict__ q, long long S,
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

}  // namespace

// queries [S, 3], points [M, 3], out [S]: contiguous fp32 on the device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nn_min_dist_launch(const float* queries, long long S,
                                  const float* points, long long M,
                                  float* out, void* stream) {
  if (S <= 0) return 0;
  const long long blocks = (S + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  nn_min_dist_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(queries, S, points, M, out);
  return (int)cudaGetLastError();
}
