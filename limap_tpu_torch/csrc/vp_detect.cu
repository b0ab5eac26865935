// Kernel J: vanishing-point detection, every image in one launch.
//
// Replaces the jitted program of limap_tpu/vplib/jlinkage.py:90
// (_detect_kernel): per image, VP hypotheses from pairs of lines, the
// inlier test of every (hypothesis, line) pair, then max_vps rounds of
// sequential best-model selection with an eigenvector refit.  The
// hypotheses and the distances follow limap_tpu_torch/ops/vp_detect.py
// operation for operation with the _rn intrinsics (no FMA contraction),
// so the inlier tests, counts and labels equal the plain version's.
//
// Design: one block an image.  The inlier test of all H x N pairs is
// computed once into a bit mask [H][ceil(N / 32)] (shared memory where it
// fits, else a global scratch slice of the block); a round then counts
// each hypothesis's inliers among the remaining lines by popcount of
// (mask row & remaining), takes the first maximum by a block reduction,
// and, when accepted, sums the inliers' moments c c^T in a fixed order
// (each thread its lines in index order, xor butterflies, the warps in
// warp order, in fp64), solves the 3 x 3 by cyclic Jacobi rotations in
// fp64 and takes the eigenvector of the least eigenvalue, its
// largest-magnitude component made positive.  The refit is in fp64
// because the moment matrix of homogeneous pixel lines is ill-conditioned:
// an fp32 eigensolver errs by up to ~1e-3 on a VP.  A round that accepts
// nothing ends the image.
//
// Bound: operations.  Per hypothesis 26 fp32 operations (cross product,
// norm, division); per (hypothesis, valid line) pair 22 (the line
// through the VP and the midpoint, its norm, the distance, the test);
// per round a popcount a mask word a hypothesis; per accepted inlier 12
// fp64 (its moments).  Counted in limap_tpu_torch/testing/vp_checks.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// the eigenvector of the least eigenvalue of the symmetric 3 x 3 with
// upper triangle m = (xx, xy, xz, yy, yz, zz), by cyclic Jacobi sweeps in
// fp64, its largest-magnitude component made positive
__device__ void least_eigenvector(const double* m, float* out) {
  double a[3][3] = {{m[0], m[1], m[2]}, {m[1], m[3], m[4]}, {m[2], m[4], m[5]}};
  double v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < 50; ++sweep) {
    if (fabs(a[0][1]) + fabs(a[0][2]) + fabs(a[1][2]) == 0.0) break;
    for (int r = 0; r < 3; ++r) {
      const int p = P[r], q = Q[r];
      const double apq = a[p][q];
      if (apq == 0.0) continue;
      const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
      double t = fabs(theta) > 1e150
                     ? 0.5 / theta
                     : 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
      if (theta < 0.0 && fabs(theta) <= 1e150) t = -t;
      const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
      // A <- J^T A J, V <- V J with J the rotation in the (p, q) plane
      for (int k = 0; k < 3; ++k) {
        const double akp = a[k][p], akq = a[k][q];
        a[k][p] = c * akp - s * akq;
        a[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        const double apk = a[p][k], aqk = a[q][k];
        a[p][k] = c * apk - s * aqk;
        a[q][k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {
        const double vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
  }
  int k = 0;
  if (a[1][1] < a[k][k]) k = 1;
  if (a[2][2] < a[k][k]) k = 2;
  double e[3] = {v[0][k], v[1][k], v[2][k]};
  const double n = sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
  int big = 0;
  if (fabs(e[1]) > fabs(e[big])) big = 1;
  if (fabs(e[2]) > fabs(e[big])) big = 2;
  const double s = e[big] < 0.0 ? -1.0 : 1.0;
  for (int c = 0; c < 3; ++c) out[c] = (float)(s * e[c] / n);
}

__global__ void __launch_bounds__(kThreads) vp_detect_kernel(
    const float* __restrict__ coords, const float* __restrict__ mids,
    const float* __restrict__ starts, const unsigned char* __restrict__ valid,
    const long long* __restrict__ offsets, const int* __restrict__ ia,
    const int* __restrict__ ib, int H, int max_vps, int min_supports, float th,
    int words, unsigned* __restrict__ scratch, int* __restrict__ labels,
    float* __restrict__ vps_out, int* __restrict__ n_found) {
  extern __shared__ float smem[];
  float* hv = smem;                                   // [H][3]
  int* hok = (int*)(hv + 3 * H);                      // [H]
  unsigned* rem = (unsigned*)(hok + H);               // [words]
  unsigned* inl = rem + words;                        // [words]
  __shared__ int w_cnt[kWarps], w_idx[kWarps];
  __shared__ double w_mom[kWarps][6];
  __shared__ int s_best, s_cnt;

  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = offsets[img];
  const int N = (int)(offsets[img + 1] - n0);
  const int W = (N + 31) >> 5;
  unsigned* mask = scratch ? scratch + (size_t)img * H * (words > 0 ? words : 1)
                           : inl + words;             // [H][W]
  float* out = vps_out + (size_t)img * max_vps * 3;
  for (int k = tid; k < max_vps * 3; k += kThreads) out[k] = 0.f;
  for (int n = tid; n < N; n += kThreads) labels[n0 + n] = -1;
  if (N == 0) {
    if (tid == 0) n_found[img] = 0;
    return;
  }

  // hypotheses: unit(coords[ia] x coords[ib]), ok when both lines are valid
  // and the cross product is not zero (two copies of one line: the zero
  // "VP" would put every line through it)
  for (int h = tid; h < H; h += kThreads) {
    const int a = ia[(size_t)img * H + h], b = ib[(size_t)img * H + h];
    const float* p = coords + 3 * (n0 + a);
    const float* q = coords + 3 * (n0 + b);
    const float x = sub(mul(p[1], q[2]), mul(p[2], q[1]));
    const float y = sub(mul(p[2], q[0]), mul(p[0], q[2]));
    const float z = sub(mul(p[0], q[1]), mul(p[1], q[0]));
    const float len = __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
    const float nrm = add(len, kEps);
    hv[3 * h] = dvd(x, nrm);
    hv[3 * h + 1] = dvd(y, nrm);
    hv[3 * h + 2] = dvd(z, nrm);
    hok[h] = valid[n0 + a] && valid[n0 + b] && len > 0.f;
  }
  for (int w = tid; w < W; w += kThreads) {
    unsigned bits = 0u;
    for (int j = 0; j < 32; ++j) {
      const int n = 32 * w + j;
      if (n < N && valid[n0 + n]) bits |= 1u << j;
    }
    rem[w] = bits;
  }
  __syncthreads();

  // the inlier bit mask: dist(h, n) <= th for each valid line n
  for (int idx = tid; idx < H * W; idx += kThreads) {
    const int h = idx / W, w = idx - h * W;
    const float vx = hv[3 * h], vy = hv[3 * h + 1], vz = hv[3 * h + 2];
    unsigned bits = 0u;
    for (int j = 0; j < 32; ++j) {
      const int n = 32 * w + j;
      if (n >= N || !valid[n0 + n]) continue;
      const float mx = mids[2 * (n0 + n)], my = mids[2 * (n0 + n) + 1];
      const float a = sub(vy, mul(vz, my));
      const float b = sub(mul(vz, mx), vx);
      const float c = sub(mul(vx, my), mul(vy, mx));
      const float den = __fsqrt_rn(add(add(mul(a, a), mul(b, b)), kEps));
      const float sx = starts[2 * (n0 + n)], sy = starts[2 * (n0 + n) + 1];
      const float d = dvd(fabsf(add(add(mul(a, sx), mul(b, sy)), c)), den);
      if (d <= th) bits |= 1u << j;
    }
    mask[(size_t)h * W + w] = bits;
  }
  __syncthreads();

  int k = 0;
  for (; k < max_vps; ++k) {
    // the first hypothesis with the most remaining inliers (-1 if not ok)
    int bc = -2, bi = H;
    for (int h = tid; h < H; h += kThreads) {
      int c = -1;
      if (hok[h]) {
        c = 0;
        for (int w = 0; w < W; ++w) c += __popc(mask[(size_t)h * W + w] & rem[w]);
      }
      if (c > bc) {
        bc = c;
        bi = h;
      }
    }
    for (int off = 16; off; off >>= 1) {
      const int oc = __shfl_down_sync(0xffffffffu, bc, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (oc > bc || (oc == bc && oi < bi)) {
        bc = oc;
        bi = oi;
      }
    }
    if (lane == 0) {
      w_cnt[warp] = bc;
      w_idx[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      int c = w_cnt[0], i = w_idx[0];
      for (int w = 1; w < kWarps; ++w)
        if (w_cnt[w] > c || (w_cnt[w] == c && w_idx[w] < i)) {
          c = w_cnt[w];
          i = w_idx[w];
        }
      s_cnt = c;
      s_best = i;
    }
    __syncthreads();
    if (s_cnt < min_supports) break;  // uniform over the block
    const int best = s_best;
    for (int w = tid; w < W; w += kThreads)
      inl[w] = mask[(size_t)best * W + w] & rem[w];
    __syncthreads();

    // moments of the inliers' coords, and their label
    double m[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int n = tid; n < N; n += kThreads) {
      if (!((inl[n >> 5] >> (n & 31)) & 1u)) continue;
      const float* cf = coords + 3 * (n0 + n);
      const double c[3] = {cf[0], cf[1], cf[2]};
      m[0] = __dadd_rn(m[0], __dmul_rn(c[0], c[0]));
      m[1] = __dadd_rn(m[1], __dmul_rn(c[0], c[1]));
      m[2] = __dadd_rn(m[2], __dmul_rn(c[0], c[2]));
      m[3] = __dadd_rn(m[3], __dmul_rn(c[1], c[1]));
      m[4] = __dadd_rn(m[4], __dmul_rn(c[1], c[2]));
      m[5] = __dadd_rn(m[5], __dmul_rn(c[2], c[2]));
      labels[n0 + n] = k;
    }
    for (int off = 16; off; off >>= 1)
      for (int j = 0; j < 6; ++j)
        m[j] = __dadd_rn(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
    if (lane == 0)
      for (int j = 0; j < 6; ++j) w_mom[warp][j] = m[j];
    __syncthreads();
    if (tid == 0) {
      double s[6];
      for (int j = 0; j < 6; ++j) {
        s[j] = w_mom[0][j];
        for (int w = 1; w < kWarps; ++w) s[j] = __dadd_rn(s[j], w_mom[w][j]);
      }
      least_eigenvector(s, out + 3 * k);
    }
    for (int w = tid; w < W; w += kThreads) rem[w] &= ~inl[w];
    __syncthreads();
  }
  if (tid == 0) n_found[img] = k;
}

}  // namespace

// coords [N, 3], mids / starts [N, 2] f32, valid [N] u8, offsets [I + 1]
// i64, ia / ib [I, H] i32; words = ceil(max lines of an image / 32);
// scratch: null (mask in shared memory) or [I, H, max(words, 1)] u32.
extern "C" int vp_detect_launch(const void* coords, const void* mids,
                                const void* starts, const void* valid,
                                const void* offsets, const void* ia,
                                const void* ib, long long I, long long H,
                                long long max_vps, long long min_supports,
                                float th, long long words, void* scratch,
                                void* labels, void* vps, void* n_found,
                                void* stream) {
  size_t shmem = sizeof(float) * 3 * H + sizeof(int) * H +
                 2 * sizeof(unsigned) * words;
  if (!scratch) shmem += sizeof(unsigned) * H * words;
  cudaError_t e = cudaFuncSetAttribute(
      vp_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  vp_detect_kernel<<<(unsigned)I, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)coords, (const float*)mids, (const float*)starts,
      (const unsigned char*)valid, (const long long*)offsets, (const int*)ia,
      (const int*)ib, (int)H, (int)max_vps, (int)min_supports, th, (int)words,
      (unsigned*)scratch, (int*)labels, (float*)vps, (int*)n_found);
  return (int)cudaGetLastError();
}
