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
// Modes: 0, the matcher paths: one thread per bucket slot (n, t) and bank
// decodes its edge word ((b << 7) | slot, -1 empty) and writes the row [9]
// (start, end, depths, uncertainty) and ok, like the plain version also
// for a pair that fails a cull.  The banks are bank-major columns of the
// output, [algebraic T | VP of a T | VP of b T] (the first absent when
// algebraic triangulation is off): a VP bank (the JAX program's :302-314,
// replaced likewise) triangulates along the world direction of line a's
// VP in a's view or of line b's VP in b's view (the JAX program converts
// b's VP with a's view, which misses b's direction unless the two views
// share R and K), with no cull but the line's VP, then score > 0, the
// ranges and the uncertainty.
//
// The exhaustive matcher (tri_exhaustive_launch, modes 1 and 2): every
// line a of an image against every line b of each of its neighbours, in
// the order slot, then b.  Mode 1 counts each (line, slot)'s survivors;
// mode 2 writes them into a bucket of width W at the line's offset of the
// slot (the exclusive scan of the counts in slot order, taken by the
// wrapper) plus the survivor's rank in the slot, with the edge word, so
// each line's survivors come out slot-major, then by b.  A candidate stops
// at its first failed cull; the dense match table never exists.
//   1. A table launch (tri_exhaustive_tables, once for both passes)
//      writes what depends on one line and its own view, once a line slot
//      (the segment and its ok, the two rays, the plane normal unit and
//      not, the homogeneous line, its direction and length + eps) and
//      once an image (the loaded view and its centre).
//   2. The candidate launch: a block of WARPS_X warps takes one image and
//      WARPS_X of its lines, a warp a line.  For each slot, the block
//      stages the neighbour's table rows that the two culls read (12 floats
//      a row, B_TILE = 640 rows, 30 KB of shared memory as arrays of
//      fields), and each warp computes its line's two epipolar lines in the
//      neighbour once; the lanes then take the candidates b and run only
//      the ray-angle and IoU culls, from registers and shared memory.
//      Candidates that pass both go into the warp's queue in shared memory
//      in candidate order (ballot + prefix); 32 queued candidates are
//      triangulated, culled by sensitivity and ranges, and (mode 2)
//      written warp-dense, a lane each, in queue order.
//   Each value is the same _rn expression in the same order as the first
//   design's propose(), so the result is bit-equal to it.  Tile shape and
//   occupancy: 256 threads (8 lines) a block, 37 KB of shared memory
//   (staging 30 KB, queues 2 KB, the per-slot counts 4 KB), 4 blocks an
//   SM, 32 warps of 64, held by the registers (see X_BLOCKS).
// The first design (modes 1 and 2 of tri_propose_launch; the
// yardstick propose_exhaustive_scan, for timing and bit-equality only):
// one block a line a enumerates (slot, b), every candidate recomputing its
// rays, views and epipolar lines, and compacts the survivors by ballot +
// block prefix.
//
// Bound: operations, counted in limap_tpu_torch/testing/tri_checks.py::
// OPS_F with each value once at the coarsest index it depends on: 24 fp32
// operations a candidate for the two ray angles, 47 past them for the
// IoU's band, 162 a triangulation; a line's rays (88) once a line, its
// epipolar lines (110) once a (line, slot).  The tables and the staging
// reach that count but for the culls' two arccosines and seven IEEE
// divisions a candidate, which OPS_F counts as one operation each.

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

// the IoU of l2 (its homogeneous line coor, start (sx, sy), direction and
// length + eps n2) with the band between the epipolar lines ep_s and ep_e
// of l1's endpoints
__device__ __forceinline__ float band_iou(V3 coor, float sx, float sy,
                                          float dirx, float diry, float n2,
                                          V3 ep_s, V3 ep_e) {
  float c[2];
  for (int k = 0; k < 2; ++k) {
    V3 ch = vcross(coor, k ? ep_e : ep_s);
    float z = add(ch.z, kEps);
    float ix = dvd(ch.x, z), iy = dvd(ch.y, z);
    c[k] = dvd(add(mul(sub(ix, sx), dirx), mul(sub(iy, sy), diry)), n2);
  }
  float lo = nmin(c[0], c[1]), hi = nmax(c[0], c[1]);
  return dvd(sub(nmin(hi, 1.f), nmax(lo, 0.f)),
             add(sub(nmax(hi, 1.f), nmin(lo, 0.f)), kEps));
}

__device__ float epipolar_iou(const Seg2& l1, const View& v1, const Seg2& l2,
                              const View& v2) {
  V3 coor = vunit(vcross(v3(l2.sx, l2.sy, 1.f), v3(l2.ex, l2.ey, 1.f)));
  float dx = sub(l2.ex, l2.sx), dy = sub(l2.ey, l2.sy);
  float len2 = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
  float n2 = add(len2, kEps);
  float dirx = dvd(dx, n2), diry = dvd(dy, n2);
  return band_iou(coor, l2.sx, l2.sy, dirx, diry, n2,
                  vunit(epipolar_line(v1, v2, l1.sx, l1.sy)),
                  vunit(epipolar_line(v1, v2, l1.ex, l1.ey)));
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

// the unit world direction of a VP given in the pixels of view v:
// R^T K^-1 vp (functions.get_direction_from_vp)
__device__ __forceinline__ V3 direction_from_vp(const View& v, const float* vp) {
  float u = dvd(sub(vp[0], mul(v.k[2], vp[2])), v.k[0]);
  float w = dvd(sub(vp[1], mul(v.k[3], vp[2])), v.k[1]);
  return vunit(qrot(v.qc, v3(u, w, vp[2])));
}

// The proposal of a VP bank (functions.triangulate_line_with_direction):
// the line of direction d in l1's back-projection plane, placed by l2's
// plane, then score > 0, the ranges and the uncertainty; the row is
// written whatever ok says.  Returns ok.
__device__ bool propose_vp(const Params& P, const Seg2& l1, bool ok,
                           const View& v1, const Seg2& l2, const View& v2,
                           V3 d, float* row) {
  V3 v1s = ray(v1, l1.sx, l1.sy), v1e = ray(v1, l1.ex, l1.ey);
  V3 n1 = vunit(vcross(v1s, v1e));
  V3 direc = vsub(d, vscale(n1, vdot(n1, d)));
  float dnorm = vnorm(direc);
  float dn = add(dnorm, kEps);
  direc = v3(dvd(direc.x, dn), dvd(direc.y, dn), dvd(direc.z, dn));
  V3 perp = vcross(n1, direc);
  float a1s = vdot(v1s, perp), a1e = vdot(v1e, perp);
  if (a1s < 0.f) {
    a1s = -a1s;
    a1e = -a1e;
  }
  V3 C1 = center(v1), C2 = center(v2);
  V3 n2 = vunit(vcross(ray(v2, l2.sx, l2.sy), ray(v2, l2.ex, l2.ey)));
  float c1 = vdot(n2, v1s), c1e = vdot(n2, v1e);
  float b = vdot(n2, vsub(C2, C1));
  float c2 = dvd(mul(c1e, a1s), add(a1e, kEps));
  float d1s = dvd(mul(add(c1, c2), b),
                  add(add(mul(c1, c1), mul(c2, c2)), kEps));
  float d1e = dvd(mul(d1s, a1s), add(a1e, kEps));
  V3 ps = vadd(vscale(v1s, d1s), C1), pe = vadd(vscale(v1e, d1e), C1);
  float zs = projdepth(v1, ps), ze = projdepth(v1, pe);
  bool valid = dnorm >= kEps && a1s >= 0.001f && a1e >= 0.001f &&
               zs >= kEps && ze >= kEps && projdepth(v2, ps) >= kEps &&
               projdepth(v2, pe) >= kEps && finite3(ps) && finite3(pe);
  if (!valid) {  // the invalid sentinel: start 0, end 1, depths -1
    ps = v3(0.f, 0.f, 0.f);
    pe = v3(1.f, 1.f, 1.f);
    zs = ze = -1.f;
  }
  ok = ok && valid;
  if (P.has_ranges) {
    float s[3] = {ps.x, ps.y, ps.z}, e[3] = {pe.x, pe.y, pe.z};
    for (int c = 0; c < 3; ++c)
      ok = ok && s[c] >= P.lo[c] && s[c] <= P.hi[c] && e[c] >= P.lo[c] &&
           e[c] <= P.hi[c];
  }
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

// The proposal past the IoU (``ok``: the culls so far): the
// triangulation from the centres C1, C2, the rays of both lines and
// n2u = c2s x c2e, the sensitivity cull, the ranges and the row.  With
// need_row the row is computed whatever the culls say; without it the
// candidate stops at its first failed cull.  Returns ok.
__device__ __forceinline__ bool finish(const Params& P, const View& v1, V3 C1,
                                       V3 c1s, V3 c1e, const View& v2, V3 C2,
                                       V3 c2s, V3 c2e, V3 n2u, bool ok,
                                       bool need_row, float* row) {
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
  return finish(P, v1, center(v1), c1s, c1e, v2, center(v2), c2s, c2e,
                vcross(c2s, c2e), ok, need_row, row);
}

__device__ __forceinline__ Seg2 load_seg(const float* l2d, long long n,
                                         bool& ok) {
  const float* p = l2d + 6 * n;
  ok = p[4] > 0.5f;
  return {p[0], p[1], p[2], p[3]};
}

// mode 0: one thread a bucket slot and bank; output column bank * T + t
__global__ void __launch_bounds__(kThreads) propose_words_kernel(
    const float* __restrict__ l2d, const float* __restrict__ cam,
    const int* __restrict__ meta, const int* __restrict__ words,
    const float* __restrict__ vp, Params P, int G, int L, int K, int T,
    int first_kind, int n_banks, float* __restrict__ tri,
    unsigned char* __restrict__ ok_out) {
  long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (idx >= (long long)G * L * n_banks * T) return;
  long long n = idx / ((long long)n_banks * T);
  int col = (int)(idx - n * n_banks * T);
  int kind = first_kind + col / T, t = col % T;
  int g = (int)(n / L), a = (int)(n % L);
  int word = words[n * T + t];
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
  bool ok;
  if (kind == 0) {
    ok = propose(P, l1, own_ok && tvalid, v1, l2, nb_ok, v2, true, r);
  } else {
    // the own line's VP in its view, or the neighbour line's in its own
    const float* q = vp + 4 * (kind == 1 ? (long long)row * L + a
                                         : (long long)ng * L + b);
    V3 d = direction_from_vp(kind == 1 ? v1 : v2, q);
    ok = propose_vp(P, l1, own_ok && tvalid && nb_ok && q[3] > 0.5f, v1, l2,
                    v2, d, r);
  }
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

// --------------------------------------------- the tiled exhaustive passes
// the line table: the cull's fields (staged), then the rest
constexpr int CF = 12;  // ok, unit normal [3], coor [3], sx, sy, dir [2], len
constexpr int RF = 12;  // ray s [3], ray e [3], normal [3], ex, ey, pad
constexpr int VF = 20;  // kvec [4], qvec [4], tvec [3], qc [4], centre [3]
constexpr int WARPS_X = 8;
constexpr int B_TILE = 640;
constexpr int QCAP = 64;
constexpr int KMAX = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ View view_at(const float* vt) {
  View v;
  for (int c = 0; c < 4; ++c) {
    v.k[c] = vt[c];
    v.q[c] = vt[4 + c];
    v.qc[c] = vt[11 + c];
  }
  v.t = v3(vt[8], vt[9], vt[10]);
  return v;
}

__device__ __forceinline__ V3 centre_at(const float* vt) {
  return v3(vt[15], vt[16], vt[17]);
}

// one thread a line slot n = r L + a (and an image r < I)
__global__ void __launch_bounds__(kThreads) exhaustive_tables_kernel(
    const float* __restrict__ l2d, const float* __restrict__ cam, int I,
    int L, float* __restrict__ cull, float* __restrict__ rest,
    float* __restrict__ views) {
  const long long n = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (n < I) {
    const View v = load_view(cam + 12 * n);
    const V3 C = center(v);
    float* vt = views + VF * n;
    for (int c = 0; c < 4; ++c) {
      vt[c] = v.k[c];
      vt[4 + c] = v.q[c];
      vt[11 + c] = v.qc[c];
    }
    vt[8] = v.t.x;
    vt[9] = v.t.y;
    vt[10] = v.t.z;
    vt[15] = C.x;
    vt[16] = C.y;
    vt[17] = C.z;
    vt[18] = vt[19] = 0.f;
  }
  if (n >= (long long)I * L) return;
  const View v = load_view(cam + 12 * (n / L));
  bool ok;
  const Seg2 l = load_seg(l2d, n, ok);
  const V3 rs = ray(v, l.sx, l.sy), re = ray(v, l.ex, l.ey);
  const V3 nu = vcross(rs, re), nrm = vunit(nu);
  const V3 coor = vunit(vcross(v3(l.sx, l.sy, 1.f), v3(l.ex, l.ey, 1.f)));
  const float dx = sub(l.ex, l.sx), dy = sub(l.ey, l.sy);
  const float len = add(__fsqrt_rn(add(mul(dx, dx), mul(dy, dy))), kEps);
  float* c = cull + CF * n;
  c[0] = ok ? 1.f : 0.f;
  c[1] = nrm.x;
  c[2] = nrm.y;
  c[3] = nrm.z;
  c[4] = coor.x;
  c[5] = coor.y;
  c[6] = coor.z;
  c[7] = l.sx;
  c[8] = l.sy;
  c[9] = dvd(dx, len);
  c[10] = dvd(dy, len);
  c[11] = len;
  float* r = rest + RF * n;
  r[0] = rs.x;
  r[1] = rs.y;
  r[2] = rs.z;
  r[3] = re.x;
  r[4] = re.y;
  r[5] = re.z;
  r[6] = nu.x;
  r[7] = nu.y;
  r[8] = nu.z;
  r[9] = l.ex;
  r[10] = l.ey;
  r[11] = 0.f;
}

// what a warp's line a holds for its candidates
struct Own {
  View v1;
  V3 C1, c1s, c1e;
};

// The warp-dense stage: lane i < nq takes queued candidate q[i]
// ((b << 7) | slot, in candidate order), triangulates it and runs the
// culls past the IoU; each survivor's rank in its slot is the slot's
// survivors so far (cnt) plus those of lower lanes; mode 2 writes it at
// its line's offset of the slot plus that rank.
__device__ __forceinline__ void drain(
    const Params& P, const Own& own, const int* q, int nq, const int* meta_g,
    int L, int K, const float* __restrict__ rest,
    const float* __restrict__ views, bool write, long long n, int W,
    const int* __restrict__ offsets, int* cnt, int* __restrict__ words_out,
    float* __restrict__ tri, unsigned char* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  bool ok = false;
  int slot = 0x7FFF, b = 0;
  float r[9];
  if (lane < nq) {
    const int word = q[lane];
    b = word >> 7;
    slot = word & 0x7F;
    const int ng = meta_g[slot];
    const float* vt = views + VF * ng;
    const float* t = rest + RF * ((long long)ng * L + b);
    ok = finish(P, own.v1, own.C1, own.c1s, own.c1e, view_at(vt),
                centre_at(vt), v3(t[0], t[1], t[2]), v3(t[3], t[4], t[5]),
                v3(t[6], t[7], t[8]), true, false, r);
  }
  const unsigned okm = __ballot_sync(FULL, ok);
  const unsigned same = __match_any_sync(FULL, slot);
  const int before = lane < nq ? cnt[slot] : 0;
  __syncwarp();
  if (ok && write) {
    const int pos = offsets[n * K + slot] + before + __popc(okm & same & lt);
    if (pos < W) {
      const long long o = n * W + pos;
      words_out[o] = (b << 7) | slot;
      for (int c = 0; c < 9; ++c) tri[o * 9 + c] = r[c];
      ok_out[o] = 1;
    }
  }
  // the first lane of each slot's run adds the slot's survivors
  if (lane < nq && !(same & lt)) cnt[slot] = before + __popc(okm & same);
  __syncwarp();
}

// modes 1 and 2: a block WARPS_X lines of one image, a warp a line;
// X_BLOCKS blocks an SM (32 warps) cap the registers at 64, which spills
// some of the triangulation's state, and still runs 20 % faster than the
// 99 registers of 2 blocks an SM (tri_propose on an H100)
constexpr int X_BLOCKS = 4;
__global__ void __launch_bounds__(32 * WARPS_X, X_BLOCKS) exhaustive_kernel(
    const float* __restrict__ cull, const float* __restrict__ rest,
    const float* __restrict__ views, const int* __restrict__ meta, Params P,
    int L, int K, int W, int write, const int* __restrict__ offsets,
    int* __restrict__ scounts, int* __restrict__ words_out,
    float* __restrict__ tri, unsigned char* __restrict__ ok_out) {
  __shared__ float sh[CF][B_TILE];
  __shared__ int queue[WARPS_X][QCAP];
  __shared__ int cnt[WARPS_X][KMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int tiles = (L + WARPS_X - 1) / WARPS_X;
  const int g = blockIdx.x / tiles;
  const int a = (blockIdx.x - g * tiles) * WARPS_X + warp;
  const int* meta_g = meta + g * (K + 1);
  const int row = meta_g[K];
  const long long n = (long long)g * L + a;
  int* q = queue[warp];
  int* cn = cnt[warp];
  for (int k = lane; k < K; k += 32) cn[k] = 0;
  bool live = a < L;
  Own own;
  Seg2 l1 = {0.f, 0.f, 0.f, 0.f};
  own.v1 = view_at(views + VF * row);
  own.C1 = centre_at(views + VF * row);
  if (live) {
    const float* c = cull + CF * ((long long)row * L + a);
    const float* t = rest + RF * ((long long)row * L + a);
    live = c[0] > 0.5f;
    own.c1s = v3(t[0], t[1], t[2]);
    own.c1e = v3(t[3], t[4], t[5]);
    l1 = {c[7], c[8], t[9], t[10]};
  }
  __syncwarp();
  int nq = 0;  // the queue's length, the same in every lane
  for (int k = 0; k < K; ++k) {
    const int ng = meta_g[k];
    if (ng < 0) continue;  // uniform over the block
    V3 ep_s = v3(0.f, 0.f, 0.f), ep_e = ep_s;
    if (live) {
      const View v2 = view_at(views + VF * ng);
      ep_s = vunit(epipolar_line(own.v1, v2, l1.sx, l1.sy));
      ep_e = vunit(epipolar_line(own.v1, v2, l1.ex, l1.ey));
    }
    for (int b0 = 0; b0 < L; b0 += B_TILE) {
      const int nb = min(B_TILE, L - b0);
      __syncthreads();  // the last tile is read
      const float4* src = reinterpret_cast<const float4*>(
          cull + CF * ((long long)ng * L + b0));
      for (int i = threadIdx.x; i < nb * (CF / 4); i += 32 * WARPS_X) {
        const float4 v = src[i];
        const int rr = i / (CF / 4), f = 4 * (i - rr * (CF / 4));
        sh[f][rr] = v.x;
        sh[f + 1][rr] = v.y;
        sh[f + 2][rr] = v.z;
        sh[f + 3][rr] = v.w;
      }
      __syncthreads();
      if (!live) continue;  // uniform over the warp
      for (int c0 = 0; c0 < nb; c0 += 32) {
        const int bb = c0 + lane;
        bool hit = false;
        if (bb < nb && sh[0][bb] > 0.5f) {
          const V3 n2 = v3(sh[1][bb], sh[2][bb], sh[3][bb]);
          hit = deg90(fabsf(vdot(n2, own.c1s)), 0.f) >= P.angle_th &&
                deg90(fabsf(vdot(n2, own.c1e)), 0.f) >= P.angle_th;
          if (hit)
            hit = band_iou(v3(sh[4][bb], sh[5][bb], sh[6][bb]), sh[7][bb],
                           sh[8][bb], sh[9][bb], sh[10][bb], sh[11][bb],
                           ep_s, ep_e) >= P.iou_th;
        }
        const unsigned m = __ballot_sync(FULL, hit);
        if (hit) q[nq + __popc(m & lt)] = ((b0 + bb) << 7) | k;
        nq += __popc(m);
        __syncwarp();
        if (nq >= 32) {
          drain(P, own, q, 32, meta_g, L, K, rest, views, write, n, W,
                offsets, cn, words_out, tri, ok_out);
          nq -= 32;
          if (lane < nq) q[lane] = q[32 + lane];
          __syncwarp();
        }
      }
    }
  }
  if (live && nq > 0)
    drain(P, own, q, nq, meta_g, L, K, rest, views, write, n, W, offsets, cn,
          words_out, tri, ok_out);
  __syncwarp();
  if (a < L)
    for (int k = lane; k < K; k += 32) scounts[n * K + k] = cn[k];
}

}  // namespace

// params: host floats angle_th, iou_th, sens_th, var2d, endpoints (0/1);
// ranges: device [6] (lo, hi) or null; vp: device [I, L, 4] (the VP, then
// 1 where the line has one) or null; banks: the first bank's kind + 4 x
// the number of banks.  mode 0: words [G, L, T] -> tri, ok [G * L, B * T];
// mode 1: counts [G * L]; mode 2: counts, words_out, tri, ok [G * L, W].
extern "C" int tri_propose_launch(
    const void* l2d, const void* cam, const void* meta, const void* words,
    const void* ranges, const void* params, const void* vp, long long G,
    long long L, long long K, long long W, long long mode, long long banks,
    void* counts, void* words_out, void* tri, void* ok, void* stream) {
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
    const int first_kind = (int)(banks % 4), n_banks = (int)(banks / 4);
    if (first_kind + n_banks > 3 || n_banks < 1 ||
        (first_kind + n_banks > 1 && !vp))
      return (int)cudaErrorInvalidValue;
    long long total = G * L * n_banks * W;
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    propose_words_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)l2d, (const float*)cam, (const int*)meta,
        (const int*)words, (const float*)vp, P, (int)G, (int)L, (int)K,
        (int)W, first_kind, n_banks, (float*)tri, (unsigned char*)ok);
  } else {
    propose_exhaustive_kernel<<<(unsigned)(G * L), kThreads, 0, s>>>(
        (const float*)l2d, (const float*)cam, (const int*)meta, P, (int)L,
        (int)K, (int)W, mode == 2, (int*)counts, (int*)words_out,
        (float*)tri, (unsigned char*)ok);
  }
  return (int)cudaGetLastError();
}

// The exhaustive matcher's table launch (step 1 above the namespace).
// p: l2d [I, L, 6], cam [I, 12], scratch cull [I L, 12], rest [I L, 12],
// views [I, 20].  n: I, L.
extern "C" int tri_exhaustive_tables(void** p, const long long* n,
                                     void* stream) {
  const long long I = n[0], L = n[1];
  const long long slots = I * L > I ? I * L : I;
  exhaustive_tables_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads),
                             kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p[0], (const float*)p[1], (int)I, (int)L, (float*)p[2],
      (float*)p[3], (float*)p[4]);
  return (int)cudaGetLastError();
}

// The exhaustive matcher's tiled passes (modes 1 and 2 above the
// namespace) on the tables of tri_exhaustive_tables.  p: meta [G, K + 1],
// cull [I L, 12], rest [I L, 12], views [I, 20]; offsets [G L, K] (mode
// 2) or null; scounts [G L, K]; words_out [G L, W], tri [G L, W, 9], ok
// [G L, W] (mode 2) or null.  n: G, L, K, W, mode.  f: angle_th, iou_th,
// sens_th, var2d, endpoints (0/1), has ranges (0/1), lo [3], hi [3].
extern "C" int tri_exhaustive_launch(void** p, const long long* n,
                                     const float* f, void* stream) {
  Params P;
  P.angle_th = f[0];
  P.iou_th = f[1];
  P.sens_th = f[2];
  P.var2d = f[3];
  P.endpoints = f[4] != 0.f;
  P.has_ranges = f[5] != 0.f;
  for (int c = 0; c < 3; ++c) {
    P.lo[c] = f[6 + c];
    P.hi[c] = f[9 + c];
  }
  const long long G = n[0], L = n[1], K = n[2], W = n[3], mode = n[4];
  if (K > KMAX - 1 || (mode != 1 && mode != 2))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (L + WARPS_X - 1) / WARPS_X;
  exhaustive_kernel<<<(unsigned)(G * tiles), 32 * WARPS_X, 0,
                      (cudaStream_t)stream>>>(
      (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const int*)p[0], P, (int)L, (int)K, (int)W, mode == 2,
      (const int*)p[4], (int*)p[5], (int*)p[6], (float*)p[7],
      (unsigned char*)p[8]);
  return (int)cudaGetLastError();
}
