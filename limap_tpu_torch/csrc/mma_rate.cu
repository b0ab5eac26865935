// Instruction rate of mma.sync on one card: a loop of independent
// mma.sync of one shape and type, nothing else, on every SM.  It tells
// how much of a kernel's time its tensor-core instructions alone
// explain (nn_min_dist.cu is timed beside it by
// limap_tpu_torch/testing/kernel_variants.py).  No kernel of the port's
// path is in this file.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// kind 0: m16n8k8 tf32, 1: m16n8k4 tf32, 2: m16n8k8 f16, 3: m16n8k16 f16
template <int KIND, int NACC>
__global__ void __launch_bounds__(kThreads)
mma_loop(float* out, int iters) {
  float d[NACC][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[i][k] = 0.f;
  const uint32_t z = 0;  // zero operands keep the sums finite
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(z));
      else if (KIND == 1)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%4}, {%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(z));
      else if (KIND == 2)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%4}, {%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(z));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(z));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NACC; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) s += d[i][k];
  if (s != 0.f) out[0] = s;  // never true; keeps the loop alive
}

template <int KIND>
float timed(float* out, int blocks, int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  mma_loop<KIND, 8><<<blocks, kThreads>>>(out, iters);  // warm-up
  cudaEventRecord(a);
  mma_loop<KIND, 8><<<blocks, kThreads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}

}  // namespace

// Milliseconds of `iters` x 8 independent mma.sync of `kind` a warp, 8
// warps a block, `blocks` blocks; -1 on a CUDA error.  `out`: one float
// on the device.
extern "C" float mma_rate_ms(int kind, float* out, int blocks, int iters) {
  switch (kind) {
    case 0: return timed<0>(out, blocks, iters);
    case 1: return timed<1>(out, blocks, iters);
    case 2: return timed<2>(out, blocks, iters);
    case 3: return timed<3>(out, blocks, iters);
  }
  return -1.f;
}
