"""The fit-and-merge kernels held to their plain versions on seeded
inputs: ``line_ransac`` (kernel D, the RANSAC hypothesis scoring) and
``linker_edges`` (kernel E, the linker's edge test).  ``chip_smoke.py``
(phases 2 and 9) and ``tests/test_torch_cuda.py`` share these inputs and
comparisons; ``tests/test_torch_fitnmerge.py`` runs the comparisons on
the CPU, against the plain version itself and against faults.

    python -m limap_tpu_torch.testing.fitnmerge_checks

builds both kernels on one GPU and prints each comparison.

Kernel D computes each distance in the plain version's order of
correctly rounded operations, so it must agree exactly; the inputs put
points exactly on their row's threshold.  Kernel E follows the linker's
formulas operation for operation, but torch's reductions and fused
operators round in their own order: a pair whose bit differs is accepted
only where one of its tests sits within FLIP_TOL of its threshold
(:func:`pair_margins`, in float64) or where the plain version gives the
kernel's bit once the pair's inputs move by one ulp
(:func:`pair_bits_f32`), and the differing bits may be no more than the
plain version itself changes when its inputs move by one ulp
(:func:`plain_spread`), plus one.  Its inputs hold pairs built to sit
just inside and just outside each 2D and 3D threshold.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import (LineLinker, check_2d,
                                              check_3d, expscore)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.line_ransac import (line_ransac, line_ransac_plain,
                                             point_line_dist)
from limap_tpu_torch.ops.linker_edges import (linker_edges,
                                              linker_edges_plain, popcount,
                                              set_bits)
from limap_tpu_torch.util.config import default_fitnmerge_config

# kernel E: a differing bit is explained by rounding where a test of the
# pair sits within FLIP_TOL of its threshold (float64), or where the
# plain version itself gives the kernel's bit on one of SPREAD_DRAWS
# copies of the inputs with a random half of their entries moved by one
# ulp; the count of differing bits is capped by the most bits the plain
# version changes on one such copy.
# float32 rounding reaches 5.5e-5 of an angle threshold on
# a short 2D segment far from the origin (measured on an H100), and the
# inner-segment distance of two lines 1 m long, 10 m away, under a
# threshold of ~0.5 mm is a difference of squares that keeps only about
# one digit in float32 (the JAX defaults' 3D th_innerseg of 0.02 times
# the uncertainty): there the test is noise in any float32 order.
FLIP_TOL = 1e-4
SPREAD_DRAWS = 16
# kernel D: a differing row needs a valid point within this relative
# distance of its threshold
RANSAC_TOL = 1e-5

# (seed, N, S, H): ragged sizes
RANSAC_CASES = ((0, 1, 2, 1), (1, 37, 17, 8), (2, 1000, 64, 32),
                (3, 3001, 100, 5))
# (seed, I, L, K): ragged sizes
LINKER_CASES = ((0, 3, 37, 2), (1, 5, 70, 3), (2, 4, 130, 4))
LINKER_CONFIGS = ("fitnmerge", "jax_defaults")


def linker_config(name: str) -> LineLinker:
    """The fit-and-merge config file's linker, or the JAX package's
    defaults."""
    if name == "jax_defaults":
        return LineLinker()
    m = default_fitnmerge_config()["merging"]
    return LineLinker.from_dicts(m["linker2d"], m["linker3d"])


# ---------------------------------------------------------------- kernel D
def ransac_inputs(seed: int, N: int, S: int, H: int):
    """Points on noisy lines with outliers, 15 % invalid samples (some
    of them NaN points, some rows all invalid), thresholds of 1-5 cm,
    and in every fifth row a threshold equal to the exact distance of
    one point to the line of hypothesis 0.  Returns numpy (points,
    valid, inlier_th, idx_a, idx_b)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, S)[None, :, None]
    a = rng.normal(size=(N, 1, 3)) * 3 + [0, 0, 8]
    d = rng.normal(size=(N, 1, 3))
    points = a + t * d + rng.normal(size=(N, S, 3)) * 0.01
    out = rng.random((N, S)) < rng.uniform(0, 0.5, (N, 1))
    points[out] += rng.normal(size=(int(out.sum()), 3))
    valid = rng.random((N, S)) > 0.15
    valid[rng.random(N) < 0.05] = False
    points[(~valid) & (rng.random((N, S)) < 0.3)] = np.nan
    points = points.astype(np.float32)
    th = rng.uniform(0.01, 0.05, N).astype(np.float32)
    idx_a = rng.integers(0, S, (N, H)).astype(np.int32)
    idx_b = rng.integers(0, S, (N, H)).astype(np.int32)
    if S > 1:
        idx_b = np.where(idx_b == idx_a, (idx_b + 1) % S, idx_b)
    rows = np.arange(0, N, 5)
    if S > 2 and len(rows):
        p = torch.as_tensor(points[rows])
        r = torch.arange(len(rows))
        dist = point_line_dist(p, p[r, torch.as_tensor(idx_a[rows, 0]).long()],
                               p[r, torch.as_tensor(idx_b[rows, 0]).long()])
        on = dist[r, torch.as_tensor(rng.integers(0, S, len(rows)))].numpy()
        th[rows] = np.where(np.isfinite(on) & (on > 0), on, th[rows])
    return points, valid, th, idx_a, idx_b


def compare_line_ransac(out, ref, args) -> dict:
    """Equal masks, counts and best hypotheses; a row that differs must
    hold a valid point within RANSAC_TOL of its threshold for one of the
    two best lines (none is expected: D rounds as plain does)."""
    inl, n_inl, n_valid, best = (x.cpu() for x in out)
    r_inl, r_n_inl, r_n_valid, r_best = (x.cpu() for x in ref)
    differ = ((inl != r_inl).any(1) | (n_inl != r_n_inl) | (best != r_best)
              | (n_valid != r_n_valid))
    rows = torch.nonzero(differ)[:, 0]
    points, valid, th, idx_a, idx_b = (torch.as_tensor(np.asarray(
        x.cpu() if torch.is_tensor(x) else x)) for x in args)
    near = 0
    for r in rows.tolist():
        p = points[r].double()
        for h in {int(best[r]), int(r_best[r])}:
            d = point_line_dist(p, p[int(idx_a[r, h])], p[int(idx_b[r, h])])
            gap = (d - float(th[r])).abs() / float(th[r])
            if bool(((gap <= RANSAC_TOL) & valid[r]).any()):
                near += 1
                break
    res = {"rows": int(len(inl)), "rows_differ": int(len(rows)),
           "rows_within_rounding": near,
           "max_abs_err": int((n_inl - r_n_inl).abs().max())
           if len(inl) else 0,
           "inliers": int(r_n_inl.sum())}
    res["ok"] = (near == len(rows)
                 and len(rows) <= max(1, RANSAC_TOL * len(inl))
                 and bool(torch.equal(n_valid, r_n_valid)))
    return res


def check_line_ransac(seed, N, S, H, device="cuda") -> dict:
    args = ransac_inputs(seed, N, S, H)
    on = [torch.as_tensor(x, device=device) for x in args]
    return compare_line_ransac(line_ransac(*on), line_ransac_plain(*on),
                               args)


# ---------------------------------------------------------------- kernel E
def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _perp(d, rng):
    """A unit vector perpendicular to each row of d."""
    e = _unit(np.cross(d, rng.normal(size=d.shape)))
    return e


def _probe_deltas(rng, n):
    """Relative offsets from a threshold: just inside and just outside."""
    mags = 10.0 ** rng.uniform(-7, -3, n)
    return mags * rng.choice([-1.0, 1.0], n)


def linker_inputs(seed: int, I: int, L: int, K: int, linker: LineLinker):
    """I views on an arc looking at a wall 10 m away, L line slots each:
    ~40 % scene lines (3D lines near GT with 2D projections plus noise,
    so cross pairs connect), ~40 % probe pairs (line a + 1 a copy of line
    a moved to within 1e-7..1e-3 of one 3D or 2D threshold of
    ``linker``: angle, overlap, 3D inner-segment distance scaled by the
    pair's uncertainty, 2D perpendicular distance), the rest random; 10 %
    of the lines masked, and the last neighbour slot of every other image
    dead.  Returns numpy arrays (l2d_s, l2d_e, l3d_s, l3d_e, unc, mask,
    kvec, qvec, tvec, nbrs, nmask)."""
    rng = np.random.default_rng(seed)
    c2, c3 = linker.linker_2d, linker.linker_3d.to_spatial_merging()
    f, W, H = 400.0, 640, 480
    kvec = np.tile([f, f, W / 2, H / 2], (I, 1))
    qvec, tvec, Rs = [], [], []
    for i in range(I):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.03)
        C = np.array([0.8 * (i - I / 2), 0.3 * rng.normal(), 0.0])
        q = R.as_quat()  # x, y, z, w
        qvec.append([q[3], q[0], q[1], q[2]])
        tvec.append(-R.apply(C))
        Rs.append(R)
    qvec, tvec = np.asarray(qvec), np.asarray(tvec)

    def project(i, p):
        pc = Rs[i].apply(p) + tvec[i]
        return np.stack([f * pc[..., 0] / pc[..., 2] + W / 2,
                         f * pc[..., 1] / pc[..., 2] + H / 2], -1)

    n_scene = int(0.4 * L)
    gt_s = rng.uniform([-3, -2, 9.5], [3, 2, 10.5], (n_scene, 3))
    gt_e = gt_s + _unit(rng.normal(size=(n_scene, 3)) * [1, 1, 0.2]) \
        * rng.uniform(0.5, 2.0, (n_scene, 1))
    l3s = np.zeros((I, L, 3))
    l3e = np.zeros((I, L, 3))
    l2s = np.zeros((I, L, 2))
    l2e = np.zeros((I, L, 2))
    unc = rng.uniform(0.02, 0.05, (I, L))
    for i in range(I):
        noise3 = rng.normal(size=(2, n_scene, 3)) * 0.0005
        l3s[i, :n_scene] = gt_s + noise3[0]
        l3e[i, :n_scene] = gt_e + noise3[1]
        noise2 = rng.normal(size=(2, n_scene, 2)) * 0.5
        l2s[i, :n_scene] = project(i, gt_s) + noise2[0]
        l2e[i, :n_scene] = project(i, gt_e) + noise2[1]
        a = n_scene
        while a + 1 < int(0.8 * L):
            kind = rng.integers(0, 6)
            delta = _probe_deltas(rng, 1)[0]
            mid = rng.uniform([-3, -2, 9.5], [3, 2, 10.5])
            d3 = _unit(rng.normal(size=3) * [1, 1, 0.2])
            e3 = _perp(d3[None], rng)[0]
            m2 = rng.uniform([50, 50], [W - 50, H - 50])
            ang2 = rng.uniform(0, np.pi)
            d2 = np.array([np.cos(ang2), np.sin(ang2)])
            e2 = np.array([-d2[1], d2[0]])
            length3, length2 = rng.uniform(0.5, 2.0), rng.uniform(20, 80)
            u = unc[i, a]
            unc[i, a + 1] = u
            # base pair: identical in 3D and in 2D; then move line a + 1
            s3, t3 = mid - d3 * length3 / 2, mid + d3 * length3 / 2
            s2, t2 = m2 - d2 * length2 / 2, m2 + d2 * length2 / 2
            b3, b3e, b2, b2e = s3.copy(), t3.copy(), s2.copy(), t2.copy()
            if kind == 0:    # 3D angle, on a short line (inner distance small)
                th = math.radians(c3.th_angle * (1 + delta))
                half = 0.2 * c3.th_innerseg * u / max(math.sin(th), 1e-6)
                s3, t3 = mid - d3 * half, mid + d3 * half
                d = math.cos(th) * d3 + math.sin(th) * e3
                b3, b3e = mid - d * half, mid + d * half
            elif kind == 1:  # 3D inner-segment distance
                off = e3 * c3.th_innerseg * u * (1 + delta)
                b3, b3e = s3 + off, t3 + off
            elif kind == 2:  # 3D overlap: shifted along the line
                shift = length3 * (1 - c3.th_overlap * (1 + delta))
                b3, b3e = s3 + d3 * shift, t3 + d3 * shift
            elif kind == 3:  # 2D angle, on a short line
                th = math.radians(c2.th_angle * (1 + delta))
                half = 0.3 * c2.th_perp / max(math.sin(th), 1e-6)
                s2, t2 = m2 - d2 * half, m2 + d2 * half
                d = math.cos(th) * d2 + math.sin(th) * e2
                b2, b2e = m2 - d * half, m2 + d * half
            elif kind == 4:  # 2D perpendicular distance
                off = e2 * c2.th_perp * (1 + delta)
                b2, b2e = s2 + off, t2 + off
            else:            # 2D overlap
                shift = length2 * (1 - c2.th_overlap * (1 + delta))
                b2, b2e = s2 + d2 * shift, t2 + d2 * shift
            l3s[i, a], l3e[i, a], l3s[i, a + 1], l3e[i, a + 1] = s3, t3, b3, b3e
            l2s[i, a], l2e[i, a], l2s[i, a + 1], l2e[i, a + 1] = s2, t2, b2, b2e
            a += 2
        rest = L - a
        l3s[i, a:] = rng.uniform([-3, -2, 9], [3, 2, 11], (rest, 3))
        l3e[i, a:] = l3s[i, a:] + rng.normal(size=(rest, 3))
        l2s[i, a:] = rng.uniform([0, 0], [W, H], (rest, 2))
        l2e[i, a:] = l2s[i, a:] + rng.normal(size=(rest, 2)) * 40
    mask = rng.random((I, L)) > 0.1
    nbrs = np.zeros((I, K), np.int32)
    nmask = np.zeros((I, K), bool)
    for i in range(I):
        others = [j for j in np.argsort(np.abs(np.arange(I) - i)) if j != i]
        for k, j in enumerate(others[:K]):
            nbrs[i, k], nmask[i, k] = j, True
        if i % 2 == 1 and K:
            nbrs[i, -1], nmask[i, -1] = 0, False
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return (f32(l2s), f32(l2e), f32(l3s), f32(l3e), f32(unc), mask,
            f32(kvec), f32(qvec), f32(tvec), nbrs, nmask)


def linker_tensors(arrays, device):
    """(l2d, l3d, mask, views, nbrs, nmask) as linker_edges takes them."""
    t = [torch.as_tensor(np.asarray(x), device=device) for x in arrays]
    l2s, l2e, l3s, l3e, unc, mask, kvec, qvec, tvec, nbrs, nmask = t
    return (Segments(l2s, l2e), Segments(l3s, l3e, uncertainty=unc), mask,
            CameraViewsBatch(kvec, qvec, tvec), nbrs.to(torch.int32), nmask)


def linker_tests(l1: Segments, l2: Segments, cfg, u=None) -> list:
    """Each active test of ``cfg`` on the pairs, in float64: [(name,
    value, threshold)], the innerseg test with the four comparisons that
    decide whether the inner segments overlap."""
    out = []
    ang = ld.angle(l1, l2)
    bio = ld.compute_bioverlap(l1, l2)
    if cfg.use_angle:
        out.append(("angle", ang, cfg.th_angle))
    if cfg.use_overlap:
        out.append(("overlap", bio, cfg.th_overlap))
    if cfg.use_angle and cfg.use_overlap and cfg.use_smartangle:
        ratio = torch.clamp((cfg.th_smartoverlap - bio)
                            / (cfg.th_smartoverlap - cfg.th_overlap), max=1.0)
        th = torch.where(bio < cfg.th_smartoverlap,
                         cfg.th_angle - ratio * (cfg.th_angle
                                                 - cfg.th_smartangle),
                         torch.full_like(ratio, cfg.th_angle))
        out.append(("smartangle", expscore(ang, th * cfg.multiplier),
                    cfg.score_th))
    scale = 1.0 if u is None else u
    if cfg.use_perp:
        out.append(("perp", expscore(ld.dist_endpoints_perpendicular(l1, l2),
                                     cfg.th_perp * scale * cfg.multiplier),
                    cfg.score_th))
    if cfg.use_innerseg:
        out.append(("innerseg", expscore(
            ld.dist_innerseg(l1, l2),
            cfg.th_innerseg * scale * cfg.multiplier), cfg.score_th))
        for n, (a, b) in enumerate(((l1, l2), (l2, l1))):
            v = a.direction()
            seg = b.end - b.start
            den = torch.sum(seg * v, -1) + 1e-12
            t1 = torch.sum((a.start - b.start) * v, -1) / den
            t2 = torch.sum((a.end - b.start) * v, -1) / den
            out.append((f"inner_lo{n}", torch.minimum(t1, t2), 1.0))
            out.append((f"inner_hi{n}", torch.maximum(t1, t2), 0.0))
    return out


def _pair_tests(pairs: np.ndarray, arrays, linker: LineLinker) -> list:
    """[(test name, value [P], threshold)] of every test of each pair's
    edge test (3D, then the self pair's 2D test or the cross pair's two
    projected 2D tests, NaN where a test is not the pair's)."""
    a64 = [torch.as_tensor(np.asarray(x)) for x in arrays]
    l2s, l2e, l3s, l3e, unc, _, kvec, qvec, tvec, nbrs, _ = a64
    l2s, l2e, l3s, l3e, unc, kvec, qvec, tvec = (
        x.double() for x in (l2s, l2e, l3s, l3e, unc, kvec, qvec, tvec))
    c2, c3 = linker.linker_2d, linker.linker_3d.to_spatial_merging()
    p = torch.as_tensor(pairs, dtype=torch.long).reshape(-1, 4)
    slot, i, a, b = p.T
    self_pair = slot == 0
    j = torch.where(self_pair, i, nbrs.long()[i, torch.clamp(slot - 1, min=0)])
    row3 = Segments(l3s[i, a], l3e[i, a])
    col3 = Segments(l3s[j, b], l3e[j, b])
    row2 = Segments(l2s[i, a], l2e[i, a])
    col2 = Segments(l2s[j, b], l2e[j, b])
    vj = CameraViewsBatch(kvec[j], qvec[j], tvec[j])
    vi = CameraViewsBatch(kvec[i], qvec[i], tvec[i])
    proj_row = Segments(vj.project(row3.start), vj.project(row3.end))
    proj_col = Segments(vi.project(col3.start), vi.project(col3.end))
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    out = [("3d_" + n, v, th) for n, v, th in linker_tests(
        row3, col3, c3, torch.minimum(unc[i, a], unc[j, b]))]
    out += [("2d_" + n, torch.where(self_pair, v, nan), th)
            for n, v, th in linker_tests(row2, col2, c2)]
    out += [("proj_row_" + n, torch.where(self_pair, nan, v), th)
            for n, v, th in linker_tests(proj_row, col2, c2)]
    out += [("proj_col_" + n, torch.where(self_pair, nan, v), th)
            for n, v, th in linker_tests(proj_col, row2, c2)]
    return out


def pair_margins(pairs: np.ndarray, arrays, linker: LineLinker) -> np.ndarray:
    """For pairs [P, 4] (slot, i, a, b; slot 0 self, k + 1 neighbour k),
    the smallest float64 distance of any of the pair's tests from its
    threshold, relative to max(|threshold|, 1)."""
    gaps = [((v - th).abs() / max(abs(th), 1.0)).nan_to_num(nan=math.inf)
            for _, v, th in _pair_tests(pairs, arrays, linker)]
    return torch.stack(gaps).amin(0).numpy()


def explain_pairs(pairs: np.ndarray, arrays, linker: LineLinker) -> list:
    """Per pair, {test: (value, threshold)} in float64, for a report."""
    tests = _pair_tests(pairs, arrays, linker)
    return [{n: (float(v[k]), th) for n, v, th in tests
             if not math.isnan(float(v[k]))} for k in range(len(pairs))]


# the float fields of linker_inputs' arrays (not the mask, nbrs, nmask)
FLOAT_FIELDS = (0, 1, 2, 3, 4, 6, 7, 8)


def ulp_moved(arrays, seed: int) -> list:
    """The arrays as CPU tensors, with a random half of the entries of
    each float field moved by one ulp, up or down (draw ``seed``).  A
    pair's inputs move the same way whichever other pairs are looked at."""
    gen = torch.Generator().manual_seed(int(seed))
    moved = [torch.as_tensor(np.asarray(x)) for x in arrays]
    for k in FLOAT_FIELDS:
        x = moved[k]
        up = torch.rand(x.shape, generator=gen) < 0.5
        move = torch.rand(x.shape, generator=gen) < 0.5
        step = torch.nextafter(x, torch.where(
            up, torch.full_like(x, math.inf), torch.full_like(x, -math.inf)))
        moved[k] = torch.where(move, step, x)
    return moved


def plain_spread(ref, arrays, linker: LineLinker,
                 draws: int = SPREAD_DRAWS) -> list:
    """How many bits of the plain version's masks ``ref`` change when a
    random half of every float input moves by one ulp, one count a draw:
    the differences that float32 rounding alone makes on this input."""
    device = ref[0].device
    cfgs = (linker.linker_2d, linker.linker_3d.to_spatial_merging())
    counts = []
    for seed in range(draws):
        bits = linker_edges_plain(
            *linker_tensors(ulp_moved(arrays, seed), device), *cfgs)
        counts.append(sum(popcount(a ^ b) for a, b in zip(bits, ref)))
    return counts


def pair_bits_f32(pairs: np.ndarray, arrays, linker: LineLinker,
                  ulp_seed=None) -> np.ndarray:
    """The plain version's float32 edge bit of each pair [P, 4]; with
    ``ulp_seed``, on the inputs of :func:`ulp_moved`."""
    a32 = [torch.as_tensor(np.asarray(x)) for x in arrays] \
        if ulp_seed is None else ulp_moved(arrays, ulp_seed)
    l2s, l2e, l3s, l3e, unc, _, kvec, qvec, tvec, nbrs, _ = a32
    p = torch.as_tensor(pairs, dtype=torch.long).reshape(-1, 4)
    slot, i, a, b = p.T
    self_pair = slot == 0
    j = torch.where(self_pair, i, nbrs.long()[i, torch.clamp(slot - 1, min=0)])
    fields = [l3s[i, a], l3e[i, a], l3s[j, b], l3e[j, b], l2s[i, a],
              l2e[i, a], l2s[j, b], l2e[j, b], unc[i, a], unc[j, b],
              kvec[i], qvec[i], tvec[i], kvec[j], qvec[j], tvec[j]]
    (r3s, r3e, c3s, c3e, r2s, r2e, c2s, c2e, ua, ub, ki, qi, ti, kj, qj,
     tj) = fields
    c2, c3 = linker.linker_2d, linker.linker_3d.to_spatial_merging()
    ok = check_3d(Segments(r3s, r3e, uncertainty=ua),
                  Segments(c3s, c3e, uncertainty=ub), c3)
    row2, col2 = Segments(r2s, r2e), Segments(c2s, c2e)
    vi, vj = CameraViewsBatch(ki, qi, ti), CameraViewsBatch(kj, qj, tj)
    proj_row = Segments(vj.project(r3s), vj.project(r3e))
    proj_col = Segments(vi.project(c3s), vi.project(c3e))
    two_d = torch.where(self_pair, check_2d(row2, col2, c2),
                        check_2d(proj_row, col2, c2)
                        & check_2d(proj_col, row2, c2))
    return (ok & two_d).numpy()


def differing_pairs(out, ref) -> np.ndarray:
    """(slot, i, a, b) of every bit that differs, from the words that
    differ (the masks are never unpacked whole)."""
    ds = set_bits(out[0] ^ ref[0]).cpu()
    dc = set_bits(out[1] ^ ref[1]).cpu()
    rows = [torch.stack([torch.zeros_like(ds[:, 0]), ds[:, 0], ds[:, 1],
                         ds[:, 2]], 1),
            torch.stack([dc[:, 1] + 1, dc[:, 0], dc[:, 2], dc[:, 3]], 1)]
    return torch.cat(rows).numpy()


def compare_linker_edges(out, ref, arrays, linker: LineLinker) -> dict:
    """The kernel's bits against the plain version's.  Every differing
    bit must sit within FLIP_TOL of a threshold in float64 or be the
    plain version's own bit under one-ulp moves of the pair's inputs
    (``flips_in_spread`` counts the flips explained only so); and there
    may be no more of them than ``flip_cap``, the most bits the plain
    version changes under one-ulp moves of all its inputs
    (:func:`plain_spread`), plus one.  The cap is computed only where
    there is more than one flip."""
    n_ref = sum(popcount(x) for x in ref)
    flips = differing_pairs(out, ref)
    margins = pair_margins(flips, arrays, linker) if len(flips) else \
        np.zeros(0)
    near = margins <= FLIP_TOL
    in_spread = np.zeros(len(flips), bool)
    rest = flips[~near]
    if len(rest):
        # the kernel's bit is the plain version's flipped
        kernel_bit = ~pair_bits_f32(rest, arrays, linker)
        hit = np.zeros(len(rest), bool)
        for seed in range(SPREAD_DRAWS):
            hit |= pair_bits_f32(rest, arrays, linker, seed) == kernel_bit
        in_spread[~near] = hit
    spread = plain_spread(ref, arrays, linker) if len(flips) > 1 else []
    cap = max(spread, default=0) + 1
    res = {"edges": n_ref, "flips": int(len(flips)),
           "flips_near_threshold": int(near.sum()),
           "flips_in_spread": int(in_spread.sum()),
           "flip_cap": cap, "plain_spread": spread,
           "max_flip_margin": float(margins.max(initial=0.0)),
           "max_abs_err": int(len(flips) > 0)}
    res["ok"] = bool((near | in_spread).all()) and len(flips) <= cap
    bad = flips[~(near | in_spread)][:3]
    if len(bad):
        res["unexplained"] = [dict(pair=[int(x) for x in pair], tests=t)
                              for pair, t in zip(bad, explain_pairs(
                                  bad, arrays, linker))]
    return res


def near_threshold_pairs(arrays, linker: LineLinker, tol=1e-3) -> int:
    """How many valid self pairs (a, a + 1) sit within ``tol`` of a
    threshold: the probes' coverage."""
    mask = np.asarray(arrays[5])
    I, L = mask.shape
    pairs = np.array([(0, i, a, a + 1) for i in range(I) for a in range(L - 1)
                      if mask[i, a] and mask[i, a + 1]])
    if not len(pairs):
        return 0
    return int((pair_margins(pairs, arrays, linker) <= tol).sum())


def check_linker_edges(seed, I, L, K, config, device="cuda") -> dict:
    linker = linker_config(config)
    arrays = linker_inputs(seed, I, L, K, linker)
    args = linker_tensors(arrays, device) + (
        linker.linker_2d, linker.linker_3d.to_spatial_merging())
    res = compare_linker_edges(linker_edges(*args),
                               linker_edges_plain(*args), arrays, linker)
    res["near_threshold_pairs"] = near_threshold_pairs(arrays, linker)
    return res


def check_all(device="cuda") -> list:
    """[(kernel, case, result)] over all seeded cases (launches made here
    are not counted on a path: callers reset the counts afterwards)."""
    out = [("line_ransac", case, check_line_ransac(*case, device=device))
           for case in RANSAC_CASES]
    out += [("linker_edges", case + (cfg,),
             check_linker_edges(*case, cfg, device=device))
            for case in LINKER_CASES for cfg in LINKER_CONFIGS]
    return out


def main() -> int:
    from limap_tpu_torch.ops import cuda_build
    from limap_tpu_torch.ops import line_ransac as lr
    from limap_tpu_torch.ops import linker_edges as le
    if not torch.cuda.is_available():
        print("fitnmerge_checks: no CUDA device visible")
        return 2
    for mod in (lr, le):
        mod.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}",
              flush=True)
    results = check_all()
    torch.cuda.synchronize()
    for name, case, res in results:
        print(name, case, json.dumps(res), flush=True)
    return 0 if all(r["ok"] for _, _, r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
