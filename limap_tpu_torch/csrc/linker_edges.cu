// The edge test of fit-and-merge as bit masks (one launch for all images,
// their self pairs and their neighbour pairs).
//
// Replaces the jitted program merge_to_linetracks.build_edges
// (limap_tpu/merging/merging.py:76-114), which evaluates the joint
// linker on dense [I, L, L] (self) and [I, K, L, L] (cross) grids.  Per
// image i: the self pairs a < b, check_3d of the 3D segments and
// check_2d of the 2D segments; per neighbour slot k (image j =
// nbrs[i, k], live where nmask[i, k]): check_3d of line a of i against
// line b of j, check_2d of a projected into j against j's 2D line b, and
// check_2d of b projected into i against i's 2D line a.  Both masked by
// the line masks.  The linker functions follow limap_tpu_torch/base/
// line_dists.py and line_linker.py operation for operation, with the
// _rn intrinsics (no FMA contraction).
//
// Out: bit q of word w of row a holds the pair (a, 32 w + q): self
// [I, L, W] and cross [I, K, L, W] uint32, W = ceil(L / 32).  The dense
// [I, K, L, L] grid never exists in device memory.
//
// Bound: operations.  Every pair of valid lines needs the 3D angle test
// (11 fp32 operations with its acos); a pair that passes a test goes on
// to the next: the 3D overlap (50), smart angle (14) and inner-segment
// test (198), then one 2D check (~120) for a self pair or two for a
// cross pair.  Each line is projected once per neighbour slot (89 a
// segment); the output is one bit a pair.  Design: one block a (32-row
// tile of lines a, neighbour slot or the self slot, image); the tile's
// lines, their directions and their projections into the slot's image in
// shared memory; a warp takes 32 columns b at a time, each lane one
// column with its line, direction and projection into image i in
// registers, and writes one word a row by __ballot_sync.  A pair stops at
// its first failed test.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;
constexpr int kWarps = 4;
constexpr float kEps = 1e-12f;
constexpr float kMaxDist = 1e12f;
constexpr float kRad2Deg = 57.295779513082320876798154814105f;

struct Cfg {
  float score_th, th_angle, th_overlap, th_smartoverlap, th_smartangle,
      th_perp, th_innerseg, mult, smart_den, smart_span, sigma_perp,
      sigma_innerseg;
  bool use_angle, use_overlap, use_smartangle, use_perp, use_innerseg;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// min / max that keep a NaN, as torch.minimum / maximum / clamp keep it
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
__device__ __forceinline__ float angle(const Seg<D>& a, const Seg<D>& b) {
  float c = fabsf(dot<D>(a.dir, b.dir));
  if (!isnan(c)) c = fminf(fmaxf(c, -1.f), 1.f);
  return mul(acosf(c), kRad2Deg);
}

// signed overlap of l1 projected onto l2
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
__device__ __forceinline__ float bioverlap(const Seg<D>& a, const Seg<D>& b) {
  return nmax(overlap<D>(a, b), overlap<D>(b, a));
}

template <int D>
__device__ __forceinline__ float perp_point(const float* p, const float* o,
                                            const float* dir) {
  float disp[D];
#pragma unroll
  for (int c = 0; c < D; ++c) disp[c] = sub(p[c], o[c]);
  float along = dot<D>(disp, dir);
  float d2 = sub(dot<D>(disp, disp), mul(along, along));
  return __fsqrt_rn(nmax(d2, 0.f));
}

template <int D>
__device__ __forceinline__ float perp_oneway(const Seg<D>& a, const Seg<D>& b) {
  return nmax(perp_point<D>(a.s, b.s, b.dir), perp_point<D>(a.e, b.s, b.dir));
}

template <int D>
__device__ __forceinline__ float dist_perp(const Seg<D>& a, const Seg<D>& b) {
  return nmax(perp_oneway<D>(a, b), perp_oneway<D>(b, a));
}

// inner segment of l2 under l1's endpoints (line_dists._innerseg)
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

// exp(-(val / sigma)^2 / 2) >= score_th
__device__ __forceinline__ bool score_ok(float val, float sigma, float th) {
  float t = dvd(val, sigma);
  return expf(mul(-mul(t, t), 0.5f)) >= th;
}

// the joint test; u < 0 means "no uncertainty" (sigma from the config)
template <int D>
__device__ bool check(const Seg<D>& a, const Seg<D>& b, const Cfg& cfg,
                      float u1, float u2) {
  float ang = 0.f, bio = 0.f;
  if (cfg.use_angle) {
    ang = angle<D>(a, b);
    if (!(ang <= cfg.th_angle)) return false;
  }
  if (cfg.use_overlap) {
    bio = bioverlap<D>(a, b);
    if (!(bio > cfg.th_overlap)) return false;
  }
  if (cfg.use_angle && cfg.use_overlap && cfg.use_smartangle) {
    float ratio = nmin(dvd(sub(cfg.th_smartoverlap, bio), cfg.smart_den), 1.f);
    float th = bio < cfg.th_smartoverlap
                   ? sub(cfg.th_angle, mul(ratio, cfg.smart_span))
                   : cfg.th_angle;
    float t = dvd(ang, mul(th, cfg.mult));
    float s = expf(mul(-mul(t, t), 0.5f));
    if (s < cfg.score_th) s = 0.f;
    if (!(s >= cfg.score_th)) return false;
  }
  bool has_u = u1 >= 0.f;
  float u = nmin(u1, u2);
  if (cfg.use_perp) {
    float sigma = has_u ? mul(mul(cfg.th_perp, u), cfg.mult) : cfg.sigma_perp;
    if (!score_ok(dist_perp<D>(a, b), sigma, cfg.score_th)) return false;
  }
  if (cfg.use_innerseg) {
    float sigma =
        has_u ? mul(mul(cfg.th_innerseg, u), cfg.mult) : cfg.sigma_innerseg;
    if (!score_ok(dist_innerseg<D>(a, b), sigma, cfg.score_th)) return false;
  }
  return true;
}

struct View {
  float k[4], q[4], t[3];
};

// CameraViewsBatch.project: quat_rotate(q, p) + t (q as given), then the
// pinhole with +EPS
__device__ __forceinline__ void project(const View& v, const float* p,
                                        float* out) {
  const float* u = v.q + 1;
  float w = v.q[0];
  float uv[3] = {sub(mul(u[1], p[2]), mul(u[2], p[1])),
                 sub(mul(u[2], p[0]), mul(u[0], p[2])),
                 sub(mul(u[0], p[1]), mul(u[1], p[0]))};
  float uuv[3] = {sub(mul(u[1], uv[2]), mul(u[2], uv[1])),
                  sub(mul(u[2], uv[0]), mul(u[0], uv[2])),
                  sub(mul(u[0], uv[1]), mul(u[1], uv[0]))};
  float pc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    pc[c] = add(add(p[c], mul(2.f, add(mul(w, uv[c]), uuv[c]))), v.t[c]);
  float z = add(pc[2], kEps);
  out[0] = add(mul(v.k[0], dvd(pc[0], z)), v.k[2]);
  out[1] = add(mul(v.k[1], dvd(pc[1], z)), v.k[3]);
}

__device__ __forceinline__ View load_view(const float* kvec, const float* qvec,
                                          const float* tvec, int i) {
  View v;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v.k[c] = kvec[4 * i + c];
    v.q[c] = qvec[4 * i + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) v.t[c] = tvec[3 * i + c];
  return v;
}

__device__ __forceinline__ void load3(Seg<3>& l, const float* seg3, long long n) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    l.s[c] = seg3[6 * n + c];
    l.e[c] = seg3[6 * n + 3 + c];
  }
  finish<3>(l);
}

__device__ __forceinline__ void load2(Seg<2>& l, const float* seg2, long long n) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l.s[c] = seg2[4 * n + c];
    l.e[c] = seg2[4 * n + 2 + c];
  }
  finish<2>(l);
}

__device__ __forceinline__ void project_seg(const View& v, const Seg<3>& l,
                                            Seg<2>& out) {
  project(v, l.s, out.s);
  project(v, l.e, out.e);
  finish<2>(out);
}

struct Row {
  Seg<3> l3;
  Seg<2> l2, proj;  // own 2D segment; projection into the slot's image
  float u;
  bool ok;
};

__global__ void __launch_bounds__(kWarps * 32) linker_edges_kernel(
    const float* __restrict__ seg2, const float* __restrict__ seg3,
    const float* __restrict__ unc, const unsigned char* __restrict__ mask,
    const float* __restrict__ kvec, const float* __restrict__ qvec,
    const float* __restrict__ tvec, const int* __restrict__ nbrs,
    const unsigned char* __restrict__ nmask, Cfg cfg2, Cfg cfg3, int L, int K,
    unsigned* __restrict__ self_bits, unsigned* __restrict__ cross_bits) {
  __shared__ Row rows[kRows];
  const int a0 = blockIdx.x * kRows;
  const int slot = blockIdx.y;  // 0: self; k + 1: neighbour slot k
  const int i = blockIdx.z;
  const int W = (L + 31) / 32;
  const bool self = slot == 0;
  const int k = slot - 1;
  const bool live = self || nmask[i * K + k];
  const int j = self ? i : nbrs[i * K + k];
  unsigned* out = self ? self_bits + (size_t)i * L * W
                       : cross_bits + ((size_t)i * K + k) * L * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!live) return;  // the words stay zero

  const View vi = load_view(kvec, qvec, tvec, i);
  const View vj = load_view(kvec, qvec, tvec, j);
  if (threadIdx.x < kRows) {
    int a = a0 + threadIdx.x;
    Row& r = rows[threadIdx.x];
    r.ok = a < L && mask[(size_t)i * L + a];
    if (a < L) {
      long long n = (long long)i * L + a;
      load3(r.l3, seg3, n);
      load2(r.l2, seg2, n);
      r.u = unc ? unc[n] : -1.f;
      if (!self) project_seg(vj, r.l3, r.proj);
    }
  }
  __syncthreads();

  for (int w = warp; w < W; w += kWarps) {
    const int b = 32 * w + lane;
    const long long nb = (long long)j * L + b;
    const bool col_ok = b < L && mask[j * (size_t)L + (b < L ? b : 0)];
    Seg<3> c3;
    Seg<2> c2, cproj;
    float cu = -1.f;
    if (col_ok) {
      load3(c3, seg3, nb);
      load2(c2, seg2, nb);
      if (unc) cu = unc[nb];
      if (!self) project_seg(vi, c3, cproj);
    }
    for (int r = 0; r < kRows; ++r) {
      const int a = a0 + r;
      if (a >= L) break;  // uniform over the warp
      const Row& row = rows[r];
      bool hit = col_ok && row.ok && (!self || b > a);
      if (hit) hit = check<3>(row.l3, c3, cfg3, row.u, cu);
      if (hit) {
        if (self) {
          hit = check<2>(row.l2, c2, cfg2, -1.f, -1.f);
        } else {
          hit = check<2>(row.proj, c2, cfg2, -1.f, -1.f) &&
                check<2>(cproj, row.l2, cfg2, -1.f, -1.f);
        }
      }
      unsigned word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) out[(size_t)a * W + w] = word;
    }
  }
}

Cfg read_cfg(const float* p) {
  Cfg c;
  c.score_th = p[0];
  c.th_angle = p[1];
  c.th_overlap = p[2];
  c.th_smartoverlap = p[3];
  c.th_smartangle = p[4];
  c.th_perp = p[5];
  c.th_innerseg = p[6];
  c.mult = p[7];
  c.smart_den = p[8];
  c.smart_span = p[9];
  c.sigma_perp = p[10];
  c.sigma_innerseg = p[11];
  c.use_angle = p[12] != 0.f;
  c.use_overlap = p[13] != 0.f;
  c.use_smartangle = p[14] != 0.f;
  c.use_perp = p[15] != 0.f;
  c.use_innerseg = p[16] != 0.f;
  return c;
}

constexpr int kParams = 17;

}  // namespace

// params: host array of 2 x 17 floats, the 2D linker's then the 3D one's
extern "C" int linker_edges_launch(
    const void* seg2, const void* seg3, const void* unc, const void* mask,
    const void* kvec, const void* qvec, const void* tvec, const void* nbrs,
    const void* nmask, const void* params, long long I, long long L,
    long long K, void* self_bits, void* cross_bits, void* stream) {
  const float* p = (const float*)params;
  dim3 grid((unsigned)((L + kRows - 1) / kRows), (unsigned)(K + 1),
            (unsigned)I);
  linker_edges_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)seg2, (const float*)seg3, (const float*)unc,
      (const unsigned char*)mask, (const float*)kvec, (const float*)qvec,
      (const float*)tvec, (const int*)nbrs, (const unsigned char*)nmask,
      read_cfg(p), read_cfg(p + kParams), (int)L, (int)K,
      (unsigned*)self_bits, (unsigned*)cross_bits);
  return (int)cudaGetLastError();
}
