// Kernel G: the scoring of the line triangulator (one launch for all the
// lines of a group of images).
//
// Replaces the scoring half of the jitted bucket program
// (limap_tpu/triangulation/triangulator.py:342-420), the reference's
// O(tris^2) loop (global_line_triangulator.cc:71-161).  Per line n, for
// each of its proposals i with ok: over every proposal j with ok and
// another slot, s = min(score_3d(i, j), score_2d(i projected into j's
// neighbour view, j's 2D segment)) with the shared-parent 3D linker
// (angle + scale-invariant endpoints) and the 2D linker; the score of i
// is the per-slot maximum of s, summed over the slots in slot order; -1
// when i is not ok.  Then the best proposal (first index on ties), the
// valid edges (ok, score >= fullscore_th, rank < max_valid_conns with
// ties by index) and their stable pack.  The linker functions follow
// limap_tpu_torch/base/line_dists.py and line_linker.py operation for
// operation, with the _rn intrinsics (no FMA contraction).
//
// Design: one block a line; a thread a proposal i, its per-slot maxima
// in shared memory [K][threads]; the proposals j stream through shared
// memory in tiles, every thread reading the same j.  i's projection into
// a slot's view is computed when the slot changes (the bucket holds a
// line's proposals in slot order, so once a slot).  A pair stops at
// s_3d = 0 or s_3d <= the slot's running maximum, since then s cannot
// raise it.  The [T, T] pair grid never exists.
//
// Bound: operations (limap_tpu_torch/testing/tri_checks.py::OPS_G).  Per
// ordered pair with ok on both ends and different slots, the 3D angle (17
// fp32 operations with its acos and exp); a pair within the 3D angle adds
// the scale-invariant distance (30) and, when it can raise the maximum,
// the 2D linker (130).  The bytes: ok and the score of every bucket slot,
// the row and word of an ok proposal, the floats and ints of each line.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;
constexpr float kEps = 1e-12f;
constexpr float kMaxDist = 1e12f;
constexpr float kRad2Deg = 57.295779513082320876798154814105f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? add(a, b) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? add(a, b) : fmaxf(a, b);
}

template <int D>
struct Seg {
  float s[D], e[D], dir[D], len;
};

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float r = mul(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) r = add(r, mul(a[c], b[c]));
  return r;
}

template <int D>
__device__ __forceinline__ void finish(Seg<D>& l) {
  float d[D];
#pragma unroll
  for (int c = 0; c < D; ++c) d[c] = sub(l.e[c], l.s[c]);
  l.len = __fsqrt_rn(dot<D>(d, d));
  float n = add(l.len, kEps);
#pragma unroll
  for (int c = 0; c < D; ++c) l.dir[c] = dvd(d[c], n);
}

template <int D>
__device__ __forceinline__ float angle(const float* da, const float* db) {
  float c = fabsf(dot<D>(da, db));
  if (!isnan(c)) c = fminf(fmaxf(c, -1.f), 1.f);
  return mul(acosf(c), kRad2Deg);
}

// exp(-(val / sigma)^2 / 2), zero below the threshold
__device__ __forceinline__ float gated(float val, float sigma, float th) {
  float t = dvd(val, sigma);
  float s = expf(mul(-mul(t, t), 0.5f));
  return s < th ? 0.f : s;
}

template <int D>
__device__ __forceinline__ float overlap(const Seg<D>& l1, const Seg<D>& l2) {
  float ds[D], de[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    ds[c] = sub(l1.s[c], l2.s[c]);
    de[c] = sub(l1.e[c], l2.s[c]);
  }
  float den = add(l2.len, kEps);
  float p1 = dvd(dot<D>(ds, l2.dir), den), p2 = dvd(dot<D>(de, l2.dir), den);
  float lo = nmin(p1, p2), hi = nmax(p1, p2);
  return sub(nmin(hi, 1.f), nmax(lo, 0.f));
}

template <int D>
__device__ __forceinline__ float perp_point(const float* p, const float* o,
                                            const float* dir) {
  float disp[D];
#pragma unroll
  for (int c = 0; c < D; ++c) disp[c] = sub(p[c], o[c]);
  float along = dot<D>(disp, dir);
  return __fsqrt_rn(nmax(sub(dot<D>(disp, disp), mul(along, along)), 0.f));
}

template <int D>
__device__ __forceinline__ float dist_perp(const Seg<D>& a, const Seg<D>& b) {
  float ab = nmax(perp_point<D>(a.s, b.s, b.dir), perp_point<D>(a.e, b.s, b.dir));
  float ba = nmax(perp_point<D>(b.s, a.s, a.dir), perp_point<D>(b.e, a.s, a.dir));
  return nmax(ab, ba);
}

template <int D>
__device__ __forceinline__ bool innerseg(const Seg<D>& l1, const Seg<D>& l2,
                                         Seg<D>& out) {
  float seg2[D], ds[D], de[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    seg2[c] = sub(l2.e[c], l2.s[c]);
    ds[c] = sub(l1.s[c], l2.s[c]);
    de[c] = sub(l1.e[c], l2.s[c]);
  }
  float den = add(dot<D>(seg2, l1.dir), kEps);
  float t1 = dvd(dot<D>(ds, l1.dir), den), t2 = dvd(dot<D>(de, l1.dir), den);
  float tlo = nmin(t1, t2), thi = nmax(t1, t2);
  float a = nmax(tlo, 0.f), b = nmin(thi, 1.f);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    out.s[c] = add(l2.s[c], mul(seg2[c], a));
    out.e[c] = add(l2.s[c], mul(seg2[c], b));
  }
  finish<D>(out);
  return tlo < 1.f && thi > 0.f;
}

template <int D>
__device__ __forceinline__ float dist_innerseg(const Seg<D>& l1,
                                               const Seg<D>& l2) {
  Seg<D> s1, s2;
  bool ok1 = innerseg<D>(l2, l1, s1);
  bool ok2 = innerseg<D>(l1, l2, s2);
  float d = dist_perp<D>(s1, s2);
  return (ok1 && ok2) ? d : kMaxDist;
}

struct Params {
  // 2D linker
  float th2, angle2, overlap2, smartoverlap2, smartangle2, perp2, innerseg2,
      mult2, smart_den2, smart_span2, sigma_angle2, sigma_perp2,
      sigma_innerseg2;
  bool use_angle2, use_overlap2, use_smartangle2, use_perp2, use_innerseg2;
  // 3D shared-parent linker (angle + scale-invariant endpoints)
  float th3, sigma_angle3, sigma_scaleinv3;
  float fullscore_th;
};

// score_2d of the projection a against the 2D segment b
__device__ float score_2d(const Seg<2>& a, const Seg<2>& b, const Params& P) {
  float score = 1.f;
  float ang = 0.f, bio = 0.f;
  if (P.use_angle2) {
    ang = angle<2>(a.dir, b.dir);
    score = nmin(score, gated(ang, P.sigma_angle2, P.th2));
    if (score == 0.f) return 0.f;
  }
  if (P.use_overlap2) {
    bio = nmax(overlap<2>(a, b), overlap<2>(b, a));
    score = nmin(score, bio > P.overlap2 ? 1.f : 0.f);
    if (score == 0.f) return 0.f;
  }
  if (P.use_angle2 && P.use_overlap2 && P.use_smartangle2) {
    float ratio = nmin(dvd(sub(P.smartoverlap2, bio), P.smart_den2), 1.f);
    float th = bio < P.smartoverlap2 ? sub(P.angle2, mul(ratio, P.smart_span2))
                                     : P.angle2;
    score = nmin(score, gated(ang, mul(th, P.mult2), P.th2));
    if (score == 0.f) return 0.f;
  }
  if (P.use_perp2) {
    score = nmin(score, gated(dist_perp<2>(a, b), P.sigma_perp2, P.th2));
    if (score == 0.f) return 0.f;
  }
  if (P.use_innerseg2)
    score = nmin(score, gated(dist_innerseg<2>(a, b), P.sigma_innerseg2, P.th2));
  return score;
}

// CameraViewsBatch.project: quat_rotate(q, p) + t, then the pinhole
__device__ __forceinline__ void project(const float* cam, const float* p,
                                        float* out) {
  const float* u = cam + 5;
  float w = cam[4];
  float uv[3] = {sub(mul(u[1], p[2]), mul(u[2], p[1])),
                 sub(mul(u[2], p[0]), mul(u[0], p[2])),
                 sub(mul(u[0], p[1]), mul(u[1], p[0]))};
  float uuv[3] = {sub(mul(u[1], uv[2]), mul(u[2], uv[1])),
                  sub(mul(u[2], uv[0]), mul(u[0], uv[2])),
                  sub(mul(u[0], uv[1]), mul(u[1], uv[0]))};
  float pc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    pc[c] = add(add(p[c], mul(2.f, add(mul(w, uv[c]), uuv[c]))), cam[8 + c]);
  float z = add(pc[2], kEps);
  out[0] = add(mul(cam[0], dvd(pc[0], z)), cam[2]);
  out[1] = add(mul(cam[1], dvd(pc[1], z)), cam[3]);
}

// a proposal j as the tile holds it
struct Prop {
  float s[3], e[3], dir[3];
  Seg<2> l2;  // its 2D segment in its neighbour view
  int slot;
  bool ok;
};

__global__ void __launch_bounds__(kThreads) tri_score_kernel(
    const float* __restrict__ l2d, const float* __restrict__ cam,
    const int* __restrict__ meta, const int* __restrict__ words,
    const float* __restrict__ tri, const unsigned char* __restrict__ okp,
    Params P, int L, int K, int T, int max_valid_conns,
    float* __restrict__ floats, int* __restrict__ ints,
    float* __restrict__ scores) {
  extern __shared__ float smem[];
  float* per_slot = smem;                          // [K][kThreads]
  float* cams = per_slot + K * kThreads;           // [K][12]
  Prop* tile = (Prop*)(cams + K * 12);             // [kTile]
  __shared__ int s_width, s_best, s_base;
  __shared__ float s_best_score;
  __shared__ int warp_counts[kThreads / 32];

  const long long n = blockIdx.x;
  const int g = (int)(n / L);
  const int* mrow = meta + g * (K + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* wrow = words + n * T;
  const float* trow = tri + n * T * 9;
  const unsigned char* orow = okp + n * T;
  float* srow = scores + n * T;

  for (int k = tid; k < K * 12; k += kThreads)
    cams[k] = cam[12 * max(mrow[k / 12], 0) + k % 12];
  if (tid == 0) s_width = 0;
  __syncthreads();
  // the proposals past the last ok one score -1 and pair with nothing
  int wmax = 0;
  for (int t = tid; t < T; t += kThreads)
    if (orow[t]) wmax = t + 1;
  atomicMax(&s_width, wmax);
  __syncthreads();
  const int width = s_width;

  for (int i0 = 0; i0 < width; i0 += kThreads) {
    const int i = i0 + tid;
    const bool live = i < width && orow[i];
    int slot_i = -1;
    float si[3], ei[3], diri[3], zi[2];
    if (live) {
      for (int c = 0; c < 3; ++c) {
        si[c] = trow[9 * i + c];
        ei[c] = trow[9 * i + 3 + c];
      }
      zi[0] = trow[9 * i + 6];
      zi[1] = trow[9 * i + 7];
      Seg<3> l;
      for (int c = 0; c < 3; ++c) {
        l.s[c] = si[c];
        l.e[c] = ei[c];
      }
      finish<3>(l);
      for (int c = 0; c < 3; ++c) diri[c] = l.dir[c];
      slot_i = min(max(wrow[i], 0) & 0x7F, K - 1);
    }
    for (int k = 0; k < K; ++k) per_slot[k * kThreads + tid] = 0.f;
    int proj_slot = -1;
    Seg<2> proj;

    for (int j0 = 0; j0 < width; j0 += kTile) {
      __syncthreads();
      for (int j = j0 + tid; j < min(j0 + kTile, width); j += kThreads) {
        Prop& p = tile[j - j0];
        p.ok = orow[j] != 0;
        int w = max(wrow[j], 0);
        p.slot = min(w & 0x7F, K - 1);
        if (p.ok) {
          Seg<3> l;
          for (int c = 0; c < 3; ++c) {
            l.s[c] = p.s[c] = trow[9 * j + c];
            l.e[c] = p.e[c] = trow[9 * j + 3 + c];
          }
          finish<3>(l);
          for (int c = 0; c < 3; ++c) p.dir[c] = l.dir[c];
          const float* q = l2d + 6 * ((long long)max(mrow[p.slot], 0) * L +
                                      (w >> 7));
          p.l2.s[0] = q[0];
          p.l2.s[1] = q[1];
          p.l2.e[0] = q[2];
          p.l2.e[1] = q[3];
          finish<2>(p.l2);
        }
      }
      __syncthreads();
      if (!live) continue;
      const int jn = min(kTile, width - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const Prop& p = tile[jj];
        if (!p.ok || p.slot == slot_i) continue;
        float& best = per_slot[p.slot * kThreads + tid];
        // score_3d, shared-parent: the angle, then the scale-invariant
        // endpoint distance over i's depths
        float s3 = gated(angle<3>(diri, p.dir), P.sigma_angle3, P.th3);
        if (!(s3 > best)) continue;
        float ds[3], de[3];
        for (int c = 0; c < 3; ++c) {
          ds[c] = sub(si[c], p.s[c]);
          de[c] = sub(ei[c], p.e[c]);
        }
        float dsi = nmax(dvd(__fsqrt_rn(dot<3>(ds, ds)), add(zi[0], kEps)),
                         dvd(__fsqrt_rn(dot<3>(de, de)), add(zi[1], kEps)));
        s3 = nmin(s3, gated(dsi, P.sigma_scaleinv3, P.th3));
        if (!(s3 > best)) continue;
        if (p.slot != proj_slot) {
          const float* cv = cams + 12 * p.slot;
          project(cv, si, proj.s);
          project(cv, ei, proj.e);
          finish<2>(proj);
          proj_slot = p.slot;
        }
        best = nmax(best, nmin(s3, score_2d(proj, p.l2, P)));
      }
    }
    if (i < T) {
      float total = 0.f;
      for (int k = 0; k < K; ++k) total = add(total, per_slot[k * kThreads + tid]);
      srow[i] = live ? total : -1.f;
    }
  }
  for (int t = width + tid; t < T; t += kThreads) srow[t] = -1.f;
  __syncthreads();

  // best proposal: the largest score, the first index on ties
  if (tid == 0) {
    s_best = 0;
    s_best_score = T ? srow[0] : -1.f;
  }
  __syncthreads();
  {
    float bv = -INFINITY;
    int bi = T;
    for (int t = tid; t < T; t += kThreads) {
      float v = srow[t];
      if (v > bv) {
        bv = v;
        bi = t;
      }
    }
    for (int off = 16; off; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    __shared__ float wv[kThreads / 32];
    __shared__ int wi[kThreads / 32];
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < kThreads / 32; ++w)
        if (wv[w] > s_best_score || (wv[w] == s_best_score && wi[w] < s_best)) {
          s_best_score = wv[w];
          s_best = wi[w];
        }
    }
  }
  __syncthreads();
  const int best = s_best;
  if (tid < 10) {
    float v;
    const bool has_any = T && orow[best];
    if (tid < 8)
      v = T ? trow[9 * best + tid] : 0.f;
    else if (tid == 8)
      v = has_any ? trow[9 * best + 8] : 1e30f;
    else
      v = has_any ? srow[best] : -1.f;
    floats[n * 10 + tid] = v;
  }

  // valid edges, packed in index order
  int* irow = ints + n * (T + 1);
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < T; t0 += kThreads) {
    const int t = t0 + tid;
    bool v = false;
    if (t < T && orow[t]) {
      const float st = srow[t];
      v = st >= P.fullscore_th;
      if (v && max_valid_conns < T) {
        int rank = 0;
        for (int u = 0; u < T; ++u) {
          float su = srow[u];
          rank += (su > st) || (su == st && u < t);
        }
        v = rank < max_valid_conns;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_counts[warp] = __popc(bal);
    __syncthreads();
    if (v) {
      int pos = s_base + __popc(bal & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += warp_counts[w];
      const int word = wrow[t];
      const int slot = min(word & 0x7F, K - 1);
      if (pos < T)
        irow[pos] = max(mrow[slot], 0) * L + (word >> 7);
    }
    __syncthreads();
    if (tid == 0)
      for (int w = 0; w < kThreads / 32; ++w) s_base += warp_counts[w];
    __syncthreads();
  }
  const int cnt = min(s_base, T);
  for (int t = cnt + tid; t < T; t += kThreads) irow[t] = -1;
  if (tid == 0) irow[T] = cnt;
}

}  // namespace

// params: host floats, see ops/tri_score.py::config_params.
extern "C" int tri_score_launch(const void* l2d, const void* cam,
                                const void* meta, const void* words,
                                const void* tri, const void* ok,
                                const void* params, long long G, long long L,
                                long long K, long long T,
                                long long max_valid_conns, void* floats,
                                void* ints, void* scores, void* stream) {
  const float* p = (const float*)params;
  Params P;
  P.th2 = p[0];
  P.angle2 = p[1];
  P.overlap2 = p[2];
  P.smartoverlap2 = p[3];
  P.smartangle2 = p[4];
  P.perp2 = p[5];
  P.innerseg2 = p[6];
  P.mult2 = p[7];
  P.smart_den2 = p[8];
  P.smart_span2 = p[9];
  P.sigma_angle2 = p[10];
  P.sigma_perp2 = p[11];
  P.sigma_innerseg2 = p[12];
  P.use_angle2 = p[13] != 0.f;
  P.use_overlap2 = p[14] != 0.f;
  P.use_smartangle2 = p[15] != 0.f;
  P.use_perp2 = p[16] != 0.f;
  P.use_innerseg2 = p[17] != 0.f;
  P.th3 = p[18];
  P.sigma_angle3 = p[19];
  P.sigma_scaleinv3 = p[20];
  P.fullscore_th = p[21];
  size_t shmem = sizeof(float) * (K * kThreads + K * 12) + sizeof(Prop) * kTile;
  cudaError_t e = cudaFuncSetAttribute(
      tri_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (e != cudaSuccess) return (int)e;
  tri_score_kernel<<<(unsigned)(G * L), kThreads, shmem,
                     (cudaStream_t)stream>>>(
      (const float*)l2d, (const float*)cam, (const int*)meta,
      (const int*)words, (const float*)tri, (const unsigned char*)ok, P,
      (int)L, (int)K, (int)T, (int)max_valid_conns, (float*)floats,
      (int*)ints, (float*)scores);
  return (int)cudaGetLastError();
}
