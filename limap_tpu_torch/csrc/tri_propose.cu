// Kernel F: the proposals of the line triangulator (one launch for all
// images of a group).
//
// Replaces the proposal half of the jitted bucket program
// (limap_tpu/triangulation/triangulator.py:221-327): for each pair of a
// line a of an image and a line b of one of its neighbours, the
// ray-plane angle cull at both endpoints of a, the epipolar IoU of b
// with a's band, algebraic (or endpoint) triangulation, the sensitivity
// cull in both views, score > 0, the scene ranges and the uncertainty
// min(u1, u2).  Every step follows limap_tpu_torch/ops/tri_propose.py::
// propose_rows operation for operation, with the _rn intrinsics (no FMA
// contraction).
//
// Modes: 0, the matcher paths: one thread per bucket slot (n, t) decodes
// its edge word ((b << 7) | slot, -1 empty) and writes the row [9] (start,
// end, depths, uncertainty) and ok, like the plain version also for a
// pair that fails a cull.  1 and 2, the exhaustive matcher: one block a
// line a enumerates (slot, b) in that order, slot-major, over every
// neighbour line; mode 1 counts the survivors, mode 2 writes them
// compacted in that order (ballot + block prefix, stable) into a bucket
// of width W, with the edge word, and the count.  A candidate stops at
// its first failed cull; the dense match table never exists.
//
// Bound: operations, counted in limap_tpu_torch/testing/tri_checks.py::
// OPS_F with each value once at the coarsest index it depends on: 24 fp32
// operations a candidate for the two ray angles, 47 past them for the
// IoU's band, 162 a triangulation; a line's rays (88) once a line, its
// epipolar lines (110) once a (line, slot).  This kernel recomputes those
// for every candidate, so it does several times the counted work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-12f;
constexpr float kRad2Deg = 57.295779513082320876798154814105f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// min / max / clamp that keep a NaN, as torch's do
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? add(a, b) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? add(a, b) : fmaxf(a, b);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return v3(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z));
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return v3(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z));
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return v3(mul(a.x, s), mul(a.y, s), mul(a.z, s));
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x)));
}
__device__ __forceinline__ float vnorm(V3 a) { return __fsqrt_rn(vdot(a, a)); }
// v / (|v| + EPS)
__device__ __forceinline__ V3 vunit(V3 a) {
  float n = add(vnorm(a), kEps);
  return v3(dvd(a.x, n), dvd(a.y, n), dvd(a.z, n));
}

struct View {
  float k[4], q[4];  // kvec, qvec (w, x, y, z)
  V3 t;
  float qc[4];  // quat_normalize(quat_conjugate(q))
};

__device__ View load_view(const float* cam) {
  View v;
  for (int c = 0; c < 4; ++c) {
    v.k[c] = cam[c];
    v.q[c] = cam[4 + c];
  }
  v.t = v3(cam[8], cam[9], cam[10]);
  float cq[4] = {v.q[0], -v.q[1], -v.q[2], -v.q[3]};
  float n = __fsqrt_rn(add(add(add(mul(cq[0], cq[0]), mul(cq[1], cq[1])),
                               mul(cq[2], cq[2])), mul(cq[3], cq[3])));
  n = add(n, kEps);
  for (int c = 0; c < 4; ++c) v.qc[c] = dvd(cq[c], n);
  return v;
}

// quat_rotate(q, v) = v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ V3 qrot(const float* q, V3 p) {
  V3 u = v3(q[1], q[2], q[3]);
  V3 uv = vcross(u, p);
  V3 uuv = vcross(u, uv);
  V3 s = vadd(vscale(uv, q[0]), uuv);
  return vadd(p, vscale(s, 2.f));
}

__device__ __forceinline__ V3 center(const View& v) {
  return qrot(v.qc, v3(-v.t.x, -v.t.y, -v.t.z));
}

__device__ __forceinline__ float projdepth(const View& v, V3 p) {
  return add(qrot(v.q, p).z, v.t.z);
}

__device__ __forceinline__ void project(const View& v, V3 p, float& x,
                                        float& y) {
  V3 pc = vadd(qrot(v.q, p), v.t);
  float z = add(pc.z, kEps);
  x = add(mul(v.k[0], dvd(pc.x, z)), v.k[2]);
  y = add(mul(v.k[1], dvd(pc.y, z)), v.k[3]);
}

__device__ __forceinline__ V3 ray(const View& v, float px, float py) {
  float u = dvd(sub(px, v.k[2]), v.k[0]);
  float w = dvd(sub(py, v.k[3]), v.k[1]);
  return vunit(qrot(v.qc, v3(u, w, 1.f)));
}

// 90 - rad2deg(arccos(clamp(c, lo, 1)))
__device__ __forceinline__ float deg90(float c, float lo) {
  if (!isnan(c)) c = fminf(fmaxf(c, lo), 1.f);
  return sub(90.f, mul(acosf(c), kRad2Deg));
}

// F [p; 1] without F (functions.epipolar_line)
__device__ V3 epipolar_line(const View& v1, const View& v2, float px,
                            float py) {
  float u = dvd(sub(px, v1.k[2]), v1.k[0]);
  float w = dvd(sub(py, v1.k[3]), v1.k[1]);
  V3 rx = qrot(v2.q, qrot(v1.qc, v3(u, w, 1.f)));
  V3 rt = qrot(v2.q, qrot(v1.qc, v1.t));
  V3 ex = vcross(vsub(v2.t, rt), rx);
  float fx = v2.k[0], fy = v2.k[1], cx = v2.k[2], cy = v2.k[3];
  return v3(dvd(ex.x, fx), dvd(ex.y, fy),
            sub(sub(ex.z, mul(dvd(cx, fx), ex.x)), mul(dvd(cy, fy), ex.y)));
}

struct Seg2 {
  float sx, sy, ex, ey;
};

__device__ float epipolar_iou(const Seg2& l1, const View& v1, const Seg2& l2,
                              const View& v2) {
  V3 coor = vunit(vcross(v3(l2.sx, l2.sy, 1.f), v3(l2.ex, l2.ey, 1.f)));
  float dx = sub(l2.ex, l2.sx), dy = sub(l2.ey, l2.sy);
  float len2 = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
  float n2 = add(len2, kEps);
  float dirx = dvd(dx, n2), diry = dvd(dy, n2);
  float c[2];
  float px[2] = {l1.sx, l1.ex}, py[2] = {l1.sy, l1.ey};
  for (int k = 0; k < 2; ++k) {
    V3 ep = vunit(epipolar_line(v1, v2, px[k], py[k]));
    V3 ch = vcross(coor, ep);
    float z = add(ch.z, kEps);
    float ix = dvd(ch.x, z), iy = dvd(ch.y, z);
    c[k] = dvd(add(mul(sub(ix, l2.sx), dirx), mul(sub(iy, l2.sy), diry)), n2);
  }
  float lo = nmin(c[0], c[1]), hi = nmax(c[0], c[1]);
  return dvd(sub(nmin(hi, 1.f), nmax(lo, 0.f)),
             add(sub(nmax(hi, 1.f), nmin(lo, 0.f)), kEps));
}

struct Params {
  float angle_th, iou_th, sens_th, var2d;
  bool endpoints;
  bool has_ranges;
  float lo[3], hi[3];
};

// sensitivity of the 3D segment (s, e) in view v
__device__ float sensitivity(const View& v, V3 s, V3 e) {
  float sx, sy, ex, ey;
  project(v, s, sx, sy);
  project(v, e, ex, ey);
  V3 r = ray(v, mul(0.5f, add(sx, ex)), mul(0.5f, add(sy, ey)));
  V3 d = vunit(vsub(e, s));
  return deg90(fabsf(vdot(d, r)), -1.f);
}

// var2d * (0.5 (d1 + d2)) / (0.5 (fx + fy))
__device__ __forceinline__ float uncertainty(const View& v, V3 s, V3 e,
                                             float var2d) {
  float depth = mul(0.5f, add(projdepth(v, s), projdepth(v, e)));
  return dvd(mul(var2d, depth), mul(0.5f, add(v.k[0], v.k[1])));
}

__device__ __forceinline__ bool finite3(V3 p) {
  return isfinite(p.x) && isfinite(p.y) && isfinite(p.z);
}

// two-ray midpoint triangulation with cheirality (functions.triangulate_point)
__device__ V3 triangulate_point(const View& v1, V3 C1, V3 n1, const View& v2,
                                V3 C2, V3 n2, bool& valid) {
  float a11 = vdot(n1, n1);
  float a12 = -vdot(n1, n2);
  float a22 = vdot(n2, n2);
  float b1 = vdot(n1, vsub(C2, C1));
  float b2 = vdot(n2, vsub(C1, C2));
  float det = sub(mul(a11, a22), mul(a12, a12));
  bool small = fabsf(det) < kEps;
  float ds = small ? 1.f : det;
  float t1 = dvd(sub(mul(b1, a22), mul(b2, a12)), ds);
  float t2 = dvd(sub(mul(a11, b2), mul(a12, b1)), ds);
  V3 p = vscale(vadd(vadd(vadd(vscale(n1, t1), C1), vscale(n2, t2)), C2), 0.5f);
  valid = projdepth(v1, p) >= kEps && projdepth(v2, p) >= kEps && !small;
  return p;
}

// One proposal.  With need_row the row (start, end, depths, uncertainty)
// is computed whatever the culls say; without it the candidate stops at
// its first failed cull.  Returns ok.
__device__ bool propose(const Params& P, const Seg2& l1, bool own_ok,
                        const View& v1, const Seg2& l2, bool nb_ok,
                        const View& v2, bool need_row, float* row) {
  bool ok = own_ok && nb_ok;
  if (!ok && !need_row) return false;
  V3 c1s = ray(v1, l1.sx, l1.sy), c1e = ray(v1, l1.ex, l1.ey);
  V3 c2s = ray(v2, l2.sx, l2.sy), c2e = ray(v2, l2.ex, l2.ey);
  V3 n2 = vunit(vcross(c2s, c2e));
  ok = ok && deg90(fabsf(vdot(n2, c1s)), 0.f) >= P.angle_th &&
       deg90(fabsf(vdot(n2, c1e)), 0.f) >= P.angle_th;
  if (!ok && !need_row) return false;
  ok = ok && epipolar_iou(l1, v1, l2, v2) >= P.iou_th;
  if (!ok && !need_row) return false;

  V3 C1 = center(v1), C2 = center(v2);
  V3 ps, pe;
  float zs, ze;
  bool valid;
  if (P.endpoints) {
    bool ok_s, ok_e;
    ps = triangulate_point(v1, C1, c1s, v2, C2, c2s, ok_s);
    pe = triangulate_point(v1, C1, c1e, v2, C2, c2e, ok_e);
    zs = projdepth(v1, ps);
    ze = projdepth(v1, pe);
    valid = ok_s && ok_e;
  } else {
    V3 B = vsub(C2, C1);
    V3 n2u = vcross(c2s, c2e);
    float nume = vdot(B, n2u);
    float ds = vdot(c1s, n2u), de = vdot(c1e, n2u);
    float ts = dvd(nume, fabsf(ds) < kEps ? kEps : ds);
    float te = dvd(nume, fabsf(de) < kEps ? kEps : de);
    ps = vadd(vscale(c1s, ts), C1);
    pe = vadd(vscale(c1e, te), C1);
    zs = projdepth(v1, ps);
    ze = projdepth(v1, pe);
    valid = zs >= kEps && ze >= kEps && projdepth(v2, ps) >= kEps &&
            projdepth(v2, pe) >= kEps && finite3(ps) && finite3(pe);
  }
  if (!valid) {  // the invalid sentinel: start 0, end 1, depths -1
    ps = v3(0.f, 0.f, 0.f);
    pe = v3(1.f, 1.f, 1.f);
    zs = ze = -1.f;
  }
  ok = ok && valid;
  if (!ok && !need_row) return false;
  ok = ok && !(sensitivity(v1, ps, pe) > P.sens_th &&
               sensitivity(v2, ps, pe) > P.sens_th);
  if (P.has_ranges) {
    float s[3] = {ps.x, ps.y, ps.z}, e[3] = {pe.x, pe.y, pe.z};
    for (int c = 0; c < 3; ++c)
      ok = ok && s[c] >= P.lo[c] && s[c] <= P.hi[c] && e[c] >= P.lo[c] &&
           e[c] <= P.hi[c];
  }
  if (!ok && !need_row) return false;
  row[0] = ps.x;
  row[1] = ps.y;
  row[2] = ps.z;
  row[3] = pe.x;
  row[4] = pe.y;
  row[5] = pe.z;
  row[6] = zs;
  row[7] = ze;
  row[8] = nmin(uncertainty(v1, ps, pe, P.var2d),
                uncertainty(v2, ps, pe, P.var2d));
  return ok;
}

__device__ __forceinline__ Seg2 load_seg(const float* l2d, long long n,
                                         bool& ok) {
  const float* p = l2d + 6 * n;
  ok = p[4] > 0.5f;
  return {p[0], p[1], p[2], p[3]};
}

// mode 0: one thread a bucket slot
__global__ void __launch_bounds__(kThreads) propose_words_kernel(
    const float* __restrict__ l2d, const float* __restrict__ cam,
    const int* __restrict__ meta, const int* __restrict__ words, Params P,
    int G, int L, int K, int T, float* __restrict__ tri,
    unsigned char* __restrict__ ok_out) {
  long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (idx >= (long long)G * L * T) return;
  long long n = idx / T;
  int g = (int)(n / L), a = (int)(n % L);
  int word = words[idx];
  bool tvalid = word >= 0;
  int w = tvalid ? word : 0;
  int b = w >> 7, slot = w & 0x7F;
  int ng = meta[g * (K + 1) + min(max(slot, 0), K - 1)];
  tvalid = tvalid && ng >= 0;
  ng = max(ng, 0);
  int row = meta[g * (K + 1) + K];
  bool own_ok, nb_ok;
  Seg2 l1 = load_seg(l2d, (long long)row * L + a, own_ok);
  Seg2 l2 = load_seg(l2d, (long long)ng * L + b, nb_ok);
  View v1 = load_view(cam + 12 * row), v2 = load_view(cam + 12 * ng);
  float r[9];
  bool ok = propose(P, l1, own_ok && tvalid, v1, l2, nb_ok, v2, true, r);
  for (int c = 0; c < 9; ++c) tri[idx * 9 + c] = r[c];
  ok_out[idx] = ok;
}

// modes 1 and 2: one block a line, candidates (slot, b) slot-major
__global__ void __launch_bounds__(kThreads) propose_exhaustive_kernel(
    const float* __restrict__ l2d, const float* __restrict__ cam,
    const int* __restrict__ meta, Params P, int L, int K, int W, bool write,
    int* __restrict__ counts, int* __restrict__ words_out,
    float* __restrict__ tri, unsigned char* __restrict__ ok_out) {
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int base;
  const long long n = blockIdx.x;
  const int g = (int)(n / L), a = (int)(n % L);
  const int row = meta[g * (K + 1) + K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool own_ok;
  const Seg2 l1 = load_seg(l2d, (long long)row * L + a, own_ok);
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  if (!own_ok) {
    if (threadIdx.x == 0) counts[n] = 0;
    return;  // uniform over the block
  }
  const View v1 = load_view(cam + 12 * row);
  const int C = K * L;
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const int slot = c / L, b = c % L;
    float r[9];
    bool hit = false;
    if (c < C) {
      const int ng = meta[g * (K + 1) + slot];
      bool nb_ok;
      if (ng >= 0) {
        const Seg2 l2 = load_seg(l2d, (long long)ng * L + b, nb_ok);
        if (nb_ok) {
          const View v2 = load_view(cam + 12 * ng);
          hit = propose(P, l1, true, v1, l2, true, v2, false, r);
        }
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(bal);
    __syncthreads();
    if (write && hit) {
      int pos = base + __popc(bal & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += warp_counts[w];
      if (pos < W) {
        const long long o = n * W + pos;
        words_out[o] = (b << 7) | slot;
        for (int k = 0; k < 9; ++k) tri[o * 9 + k] = r[k];
        ok_out[o] = 1;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kThreads / 32; ++w) s += warp_counts[w];
      base += s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[n] = base;
}

}  // namespace

// params: host floats angle_th, iou_th, sens_th, var2d, endpoints (0/1);
// ranges: device [6] (lo, hi) or null.  mode 0: words [G, L, T] -> tri,
// ok [G * L, T]; mode 1: counts [G * L]; mode 2: counts, words_out, tri,
// ok [G * L, W].
extern "C" int tri_propose_launch(
    const void* l2d, const void* cam, const void* meta, const void* words,
    const void* ranges, const void* params, long long G, long long L,
    long long K, long long W, long long mode, void* counts, void* words_out,
    void* tri, void* ok, void* stream) {
  const float* p = (const float*)params;
  Params P;
  P.angle_th = p[0];
  P.iou_th = p[1];
  P.sens_th = p[2];
  P.var2d = p[3];
  P.endpoints = p[4] != 0.f;
  P.has_ranges = ranges != nullptr;
  if (P.has_ranges) {
    float h[6];
    cudaError_t e = cudaMemcpyAsync(h, ranges, sizeof(h),
                                    cudaMemcpyDeviceToHost,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    e = cudaStreamSynchronize((cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    for (int c = 0; c < 3; ++c) {
      P.lo[c] = h[c];
      P.hi[c] = h[3 + c];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    long long total = G * L * W;
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    propose_words_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)l2d, (const float*)cam, (const int*)meta,
        (const int*)words, P, (int)G, (int)L, (int)K, (int)W, (float*)tri,
        (unsigned char*)ok);
  } else {
    propose_exhaustive_kernel<<<(unsigned)(G * L), kThreads, 0, s>>>(
        (const float*)l2d, (const float*)cam, (const int*)meta, P, (int)L,
        (int)K, (int)W, mode == 2, (int*)counts, (int*)words_out,
        (float*)tri, (unsigned char*)ok);
  }
  return (int)cudaGetLastError();
}
