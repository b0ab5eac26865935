"""The triangulator's kernels held to their plain versions: kernel F
(``tri_propose``, both input forms) and kernel G (``tri_score``).
``chip_smoke.py`` (phases 2, 4, 7 and 10) and ``tests/test_torch_cuda.py``
share these inputs and comparisons; ``tests/test_torch_tri_checks.py``
runs the comparisons on the CPU, against the plain version itself and
against faults.

    python -m limap_tpu_torch.testing.tri_checks

builds both kernels on one GPU and prints each comparison.

Both kernels follow the plain version's formulas operation for
operation, but torch's reductions, fused operators and transcendental
functions round in their own order, so a cull, a gated linker score or
the ``fullscore_th`` test may fall the other way where its value sits on
the threshold.  Such a difference is accepted only where float64 puts
the value within a stated tolerance of its threshold:

- F: a proposal ``ok`` on one side only needs a ray-plane angle within
  ``ANGLE_TOL`` degrees of ``line_tri_angle_threshold``, the epipolar
  IoU within ``IOU_TOL`` of ``IoU_threshold``, a sensitivity within
  ``ANGLE_TOL`` of its threshold, a projected depth within ``DEPTH_TOL``
  of zero or an endpoint within ``DEPTH_TOL`` of a range bound, each
  tolerance raised to four times the plain float32 value's own error
  where that is larger (the IoU of a segment nearly parallel to the
  epipolar lines divides by a vanishing cross product).  Rows ok
  on both sides agree within ``ROW_TOL`` of the row's depth
  (``ROW_TOL_ENDPOINTS`` for endpoint triangulation).
- G, given the same proposals: each proposal's score has a tolerance,
  the larger of ``SCORE_TOL`` and four times the float32 plain version's
  own error against float64, its per-slot maxima's errors summed as
  absolute values, leaving out the slots where a pair passes the gates
  in one precision only (:func:`score_tolerance`).  A score may
  differ by more only where one of its pairs has a gated linker value
  (exp score against ``score_th``, or the 2D bioverlap against
  ``th_overlap``) within ``GATE_TOL`` of its gate, or within four times
  that value's own float32 error where that is larger; a valid edge may
  differ only where its score is within tolerance of ``fullscore_th``
  or its score differs; the best proposal only between scores within
  their tolerances (a near tie) or with a differing score.  Rows with
  the same best proposal copy the same input row, so their floats must
  be equal, but the score, within its tolerance.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base import line_geometry as lgeo
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import expscore
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops import tri_propose, tri_score
from limap_tpu_torch.triangulation import functions as trifun
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

ANGLE_TOL = 1e-3      # degrees
IOU_TOL = 1e-4
DEPTH_TOL = 1e-4      # metres
ROW_TOL = 1e-4        # of max(1, |depth|)
# endpoint triangulation meets two rays at a small angle: det = |n1|^2
# |n2|^2 - (n1.n2)^2 cancels, and rounding grows by 1/det (2.8e-4 of the
# depth seen on an H100 at 4 views x 40 lines)
ROW_TOL_ENDPOINTS = 1e-3
SCORE_TOL = 1e-3
GATE_TOL = 1e-4


def _rows(l2d_packed, cam_packed, row, a, ng_row, b, dtype=torch.float64):
    """Segments and views of candidate pairs (all [M]) in ``dtype``."""
    L = l2d_packed.shape[1]
    flat = l2d_packed.to(dtype).reshape(-1, 6)
    own, nb = flat[row * L + a], flat[ng_row * L + b]
    cam = cam_packed.to(dtype)
    c1, c2 = cam[row], cam[ng_row]
    return (Segments(own[:, 0:2], own[:, 2:4]),
            CameraViewsBatch(c1[:, 0:4], c1[:, 4:8], c1[:, 8:11]),
            Segments(nb[:, 0:2], nb[:, 2:4]),
            CameraViewsBatch(c2[:, 0:4], c2[:, 4:8], c2[:, 8:11]))


def _cull_values(cfg, l2d_packed, cam_packed, row, a, ng_row, b, dtype,
                 ranges=None):
    """The values each cull of a candidate tests, [M, 13]: the two
    ray-plane angles, the IoU, the two sensitivities, four projected
    depths and the endpoints' distances to the range bounds."""
    l1, v1, l2, v2 = _rows(l2d_packed, cam_packed, row, a, ng_row, b, dtype)
    n2 = trifun.get_normal_direction(l2, v2)

    def ray_angle(p):
        c = torch.abs(torch.sum(n2 * v1.ray_direction(p), -1))
        return 90.0 - torch.rad2deg(torch.arccos(torch.clamp(c, 0, 1)))

    vals = [ray_angle(l1.start), ray_angle(l1.end),
            trifun.compute_epipolar_iou(l1, v1, l2, v2)]
    if cfg.use_endpoints_triangulation:
        tri = trifun.triangulate_line_by_endpoints(l1, v1, l2, v2)
    else:
        tri = trifun.triangulate_line_algebraic(l1, v1, l2, v2)
    vals += [lgeo.sensitivity(tri, v1), lgeo.sensitivity(tri, v2)]
    vals += [v.projdepth(p) for v in (v1, v2) for p in (tri.start, tri.end)]
    gap = torch.full_like(vals[0], float("inf"))
    if ranges is not None:
        for bound in ranges:
            for p in (tri.start, tri.end):
                gap = torch.minimum(gap, (p - bound.to(dtype)).abs().amin(-1))
    return torch.stack(vals + [gap], -1)


CULLS = ("angle_start", "angle_end", "iou", "sensitivity_1",
         "sensitivity_2", "depth_1s", "depth_1e", "depth_2s", "depth_2e",
         "ranges")


def propose_margins(cfg, l2d_packed, cam_packed, row, a, ng_row, b,
                    ranges=None, per_cull=False):
    """Each candidate's smallest distance, in float64, from a value its
    culls test to that test's threshold, over the larger of the test's
    tolerance and four times the plain float32 value's own error: a
    margin <= 1 is within rounding.  With ``per_cull`` the [M, 10]
    margins of the single tests."""
    v64 = _cull_values(cfg, l2d_packed, cam_packed, row, a, ng_row, b,
                       torch.float64, ranges)
    v32 = _cull_values(cfg, l2d_packed, cam_packed, row, a, ng_row, b,
                       torch.float32, ranges).double()
    ath, sth = cfg.line_tri_angle_threshold, cfg.sensitivity_threshold
    th = v64.new_tensor([ath, ath, cfg.IoU_threshold, sth, sth,
                         0, 0, 0, 0, 0])
    tol = v64.new_tensor([ANGLE_TOL, ANGLE_TOL, IOU_TOL, ANGLE_TOL,
                          ANGLE_TOL] + [DEPTH_TOL] * 5)
    err = torch.nan_to_num((v32 - v64).abs(), nan=0.0, posinf=0.0)
    m = (v64 - th).abs() / torch.maximum(tol, 4 * err)
    m = torch.nan_to_num(m, nan=float("inf"))
    return m if per_cull else m.amin(-1)


def _unexplained_culls(margins_per_cull):
    """How many unexplained flips sit nearest to each cull."""
    m = margins_per_cull[margins_per_cull.amin(-1) > 1]
    idx = m.argmin(-1).tolist() if len(m) else []
    return {CULLS[i]: idx.count(i) for i in sorted(set(idx))}


def compare_propose(cfg, L, K, l2d_packed, cam_packed, words, meta, out_k,
                    out_p, ranges=None):
    """Form (a): kernel (tri, ok) against plain on the same words."""
    (tri_k, ok_k), (tri_p, ok_p) = out_k, out_p
    row, a, ng_row, b, _, _ = tri_propose.decode_words(words, meta, L, K)
    T = words.shape[-1]
    flip = (ok_k != ok_p).nonzero()
    n_i, t_i = flip[:, 0], flip[:, 1]
    per = propose_margins(cfg, l2d_packed, cam_packed, row[n_i], a[n_i],
                          ng_row[n_i, t_i], b[n_i, t_i], ranges,
                          per_cull=True)
    margins = per.amin(-1)
    both = ok_k & ok_p
    scale = torch.clamp(tri_p[..., 6:8].abs().amax(-1), min=1.0)
    err = ((tri_k - tri_p).abs().amax(-1) / scale)[both]
    res = {"candidates": int((words >= 0).sum()), "ok": int(ok_p.sum()),
           "flips": len(flip),
           "flips_unexplained": int((margins > 1).sum()),
           "unexplained_nearest": _unexplained_culls(per),
           "row_err": float(err.max()) if err.numel() else 0.0,
           "max_abs_err": float((tri_k - tri_p).abs()[both].max())
           if both.any() else 0.0, "width": T}
    tol = ROW_TOL_ENDPOINTS if cfg.use_endpoints_triangulation else ROW_TOL
    res["ok_to_plain"] = res["flips_unexplained"] == 0 \
        and res["row_err"] <= tol
    return res


def compare_exhaustive(cfg, L, K, l2d_packed, cam_packed, meta, counts_k,
                       counts_p, out_k, out_p, ranges=None):
    """Form (b): counts, and the survivors of each line matched by edge
    word, kernel against plain."""
    (w_k, tri_k, ok_k), (w_p, tri_p, ok_p) = out_k, out_p
    N, W = w_p.shape
    n = torch.arange(N, device=w_p.device)[:, None].expand(N, W)
    key = lambda w: n * (1 << 20) + w.long()
    kk, kp = key(w_k)[ok_k], key(w_p)[ok_p]
    only = torch.cat([kk[~torch.isin(kk, kp)], kp[~torch.isin(kp, kk)]])
    nn, word = only // (1 << 20), only % (1 << 20)
    g = nn // L
    per = propose_margins(cfg, l2d_packed, cam_packed, meta[g, K].long(),
                          nn % L, meta[g, (word & 0x7F)].long(), word >> 7,
                          ranges, per_cull=True)
    margins = per.amin(-1)
    # rows of the survivors on both sides, by word
    common = torch.isin(kp, kk)
    order_k = torch.argsort(kk)
    pos = order_k[torch.searchsorted(kk[order_k], kp[common])]
    rows_p, rows_k = tri_p[ok_p][common], tri_k[ok_k][pos]
    scale = torch.clamp(rows_p[:, 6:8].abs().amax(-1), min=1.0)
    err = (rows_k - rows_p).abs().amax(-1) / scale
    res = {"survivors": int(counts_p.sum()),
           "survivors_max": int(counts_p.max()) if N else 0,
           "lines_without": int((counts_p == 0).sum()), "width": W,
           "count_diff": int((counts_k != counts_p).sum()),
           "flips": len(only), "flips_unexplained": int((margins > 1).sum()),
           "unexplained_nearest": _unexplained_culls(per),
           "order_equal": bool(torch.equal(
               w_k[ok_k & ok_p], w_p[ok_k & ok_p])) if len(only) == 0
           else None,
           "row_err": float(err.max()) if err.numel() else 0.0,
           "max_abs_err": float((rows_k - rows_p).abs().max())
           if err.numel() else 0.0}
    tol = ROW_TOL_ENDPOINTS if cfg.use_endpoints_triangulation else ROW_TOL
    res["ok_to_plain"] = (res["flips_unexplained"] == 0
                          and res["row_err"] <= tol
                          and res["order_equal"] is not False
                          and bool(torch.equal(
                              counts_k, ok_k.sum(1).to(counts_k.dtype))))
    return res


def _gated_values(cfg, L, l2d_packed, cam_packed, t, i, j, ng_row, b,
                  dtype):
    """The gated linker values of the pairs (i, j) of one line's
    proposals ``t`` [w, 9] in ``dtype``: [n_values, len(j)] and their
    gates."""
    c2, c3 = cfg.linker2d, cfg.linker3d.to_shared_parent_scoring()
    t = t.to(dtype)
    li = Segments(t[i, 0:3][None], t[i, 3:6][None], depths=t[i, 6:8][None])
    lj = Segments(t[j, 0:3], t[j, 3:6])
    vals = [(expscore(ld.angle(li, lj), c3.th_angle * c3.multiplier),
             c3.score_th),
            (expscore(ld.dist_endpoints_scaleinv_oneway(li, lj),
                      c3.th_scaleinv * c3.multiplier), c3.score_th)]
    cam = cam_packed.to(dtype)[ng_row[j]]
    vj = CameraViewsBatch(cam[:, 0:4], cam[:, 4:8], cam[:, 8:11])
    proj = lgeo.project_segments(Segments(li.start, li.end), vj)
    nb = l2d_packed.to(dtype).reshape(-1, 6)[ng_row[j] * L + b[j]]
    l2 = Segments(nb[:, 0:2], nb[:, 2:4])
    ang = ld.angle(proj, l2)
    bio = ld.compute_bioverlap(proj, l2)
    vals.append((expscore(ang, c2.th_angle * c2.multiplier), c2.score_th))
    vals.append((bio, c2.th_overlap))
    ratio = torch.clamp((c2.th_smartoverlap - bio)
                        / (c2.th_smartoverlap - c2.th_overlap), max=1.0)
    th = torch.where(bio < c2.th_smartoverlap,
                     c2.th_angle - ratio * (c2.th_angle - c2.th_smartangle),
                     torch.full_like(bio, c2.th_angle))
    vals.append((expscore(ang, th * c2.multiplier), c2.score_th))
    if c2.use_perp:
        vals.append((expscore(ld.dist_endpoints_perpendicular(proj, l2),
                              c2.th_perp * c2.multiplier), c2.score_th))
    if c2.use_innerseg:
        vals.append((expscore(ld.dist_innerseg(proj, l2),
                              c2.th_innerseg * c2.multiplier), c2.score_th))
    return (torch.stack([v.reshape(-1) for v, _ in vals]),
            torch.tensor([g for _, g in vals], dtype=torch.float64,
                         device=t.device))


def pair_gate_margins(cfg, L, K, l2d_packed, cam_packed, words, meta, tri,
                      ok, lines, tris):
    """For proposal ``tris[k]`` of line ``lines[k]``: the smallest
    distance, in float64 over its pairs, of a gated linker value from its
    gate, over the larger of ``GATE_TOL`` and four times the float32
    value's own error against float64 (a perpendicular distance near zero
    is the root of a difference of squares)."""
    _, _, ng_row, b, slot, _ = tri_propose.decode_words(words, meta, L, K)
    out = []
    for n, i in zip(lines.tolist(), tris.tolist()):
        j = ((ok[n]) & (slot[n] != slot[n, i])).nonzero()[:, 0]
        if not len(j):
            out.append(np.inf)
            continue
        v64, gates = _gated_values(cfg, L, l2d_packed, cam_packed, tri[n],
                                   i, j, ng_row[n], b[n], torch.float64)
        v32, _ = _gated_values(cfg, L, l2d_packed, cam_packed, tri[n], i, j,
                               ng_row[n], b[n], torch.float32)
        err = torch.nan_to_num((v32.double() - v64).abs(), nan=0.0)
        m = (v64 - gates[:, None]).abs() / torch.clamp(4 * err,
                                                       min=GATE_TOL)
        out.append(float(torch.nan_to_num(m, nan=np.inf).min()))
    return np.asarray(out)


def score_tolerance(cfg, L, K, l2d_packed, cam_packed, words, meta, tri,
                    ok, budget=1 << 20):
    """Each proposal's score tolerance [G * L, T]: the larger of
    ``SCORE_TOL`` and four times the float32 plain version's own error
    against float64, summed over the slots as absolute values (a score
    is a sum of per-slot maxima, whose errors may cancel in one rounding
    and not in another).  A perpendicular distance near zero is the root
    of a difference of squares of a few hundred pixels, so a float32
    per-slot maximum carries up to a few 1e-3 of rounding.  A slot where
    a pair passes every gate in one precision and not in the other adds
    nothing: such a difference is explained by :func:`pair_gate_margins`
    alone."""
    G, _, T = words.shape
    _, _, ng_row, b, slot, _ = tri_propose.decode_words(words, meta, L, K)
    width = torch.where(ok, torch.arange(T, device=ok.device) + 1,
                        torch.zeros_like(slot)).amax(1)
    tol = torch.full((G * L, T), SCORE_TOL, dtype=torch.float64,
                     device=ok.device)
    for n, w in tri_score.width_chunks(width, budget):
        (p32, pass32), (p64, pass64) = [tri_score._score_chunk(
            cfg, K, T, l2d_packed.to(dt), cam_packed.to(dt), ng_row[n, :w],
            b[n, :w], slot[n, :w], tri[n, :w].to(dt), ok[n, :w],
            per_slot_only=True) for dt in (torch.float32, torch.float64)]
        gate_flip = torch.zeros(p32.shape, dtype=torch.uint8,
                                device=ok.device)
        gate_flip.scatter_reduce_(
            2, slot[n, :w][:, None].expand_as(pass32),
            (pass32 != pass64).to(torch.uint8), reduce="amax")
        err = torch.nan_to_num((p32.double() - p64).abs(), nan=0.0)
        err = torch.where(gate_flip.bool(), torch.zeros_like(err), err)
        tol[n, :w] = torch.clamp(4 * err.sum(-1), min=SCORE_TOL)
    return tol


def compare_score(cfg, L, K, l2d_packed, cam_packed, words, meta, tri, ok,
                  out_k, out_p):
    """Kernel G's (floats, ints, scores) against plain on the same
    proposals."""
    (f_k, i_k, s_k), (f_p, i_p, s_p) = out_k, out_p
    G, _, T = words.shape
    N = G * L
    f_k, f_p = f_k.reshape(N, 10), f_p.reshape(N, 10)
    i_k, i_p = i_k.reshape(N, T + 1), i_p.reshape(N, T + 1)
    tol = score_tolerance(cfg, L, K, l2d_packed, cam_packed, words, meta,
                          tri, ok)
    diff = (s_k - s_p).abs().double()
    big = (diff > tol) & ok
    lines, tris = big.nonzero(as_tuple=True)
    margins = pair_gate_margins(cfg, L, K, l2d_packed, cam_packed, words,
                                meta, tri, ok, lines, tris)
    flipped = torch.zeros_like(ok)
    flipped[lines, tris] = torch.as_tensor(margins <= 1, device=ok.device)
    small = ok & ~big
    # valid edges, as sets of tri indices per line
    valid_k = ok & (s_k >= cfg.fullscore_th)
    valid_p = ok & (s_p >= cfg.fullscore_th)
    near = ((s_p - cfg.fullscore_th).abs() <= tol) | flipped
    edge_bad = ((valid_k != valid_p) & ~near).sum()
    # the packed edges follow from the valid sets where those agree
    same_sets = (valid_k == valid_p).all(1)
    ints_bad = (i_k != i_p).any(1) & same_sets
    # the best proposal
    pos = lambda f: f[:, 9] > 0
    rows = pos(f_k) | pos(f_p)
    bk = torch.argmax(s_k, 1)
    bp = torch.argmax(s_p, 1)
    r = torch.arange(N, device=ok.device)
    differ = rows & (bk != bp)
    tie = (s_p[r, bk] - s_p[r, bp]).abs() <= tol[r, bk] + tol[r, bp]
    best_bad = differ & ~tie & ~flipped[r, bk] & ~flipped[r, bp]
    same = rows & (bk == bp)
    best_err = (f_k[same, 9] - f_p[same, 9]).abs().double()
    res = {"lines": N, "ok_tris": int(ok.sum()),
           "lines_scored": int(rows.sum()),
           "score_err": float(diff[small].max()) if small.any() else 0.0,
           "score_tol_max": float(tol[ok].max()) if ok.any() else 0.0,
           "score_flips": len(lines),
           "score_flips_unexplained": int((margins > 1).sum()),
           "unexplained_margins": sorted(margins[margins > 1].tolist())[:5],
           "edge_flips": int((valid_k != valid_p).sum()),
           "edge_flips_unexplained": int(edge_bad),
           "ints_differ_with_equal_sets": int(ints_bad.sum()),
           "best_differs": int(differ.sum()),
           "best_differs_unexplained": int(best_bad.sum()),
           "rows_unequal": int((f_k[same, :9] != f_p[same, :9]).any(1).sum()),
           "best_beyond_tol": int((best_err > tol[same, bp[same]]).sum()),
           "max_abs_err": float(best_err.max()) if same.any() else 0.0}
    res["ok_to_plain"] = (res["score_flips_unexplained"] == 0
                          and res["edge_flips_unexplained"] == 0
                          and res["ints_differ_with_equal_sets"] == 0
                          and res["best_differs_unexplained"] == 0
                          and res["rows_unequal"] == 0
                          and res["best_beyond_tol"] == 0)
    return res


# ------------------------------------------------------------- work
# fp32 operations of kernel F, counted from csrc/tri_propose.cu (an add,
# multiply, divide, sqrt, min, max, abs, compare or transcendental as
# one), each value once at the coarsest index it depends on, where the
# run's data needs it.  Per own line: its two rays (88).  Per neighbour
# line: its two rays and plane normal (107), and where a candidate
# reaches the IoU its 2D line and direction (28).  Per candidate: the
# two ray-plane angle tests (24).  Per (own line, slot) where a
# candidate reaches the IoU: the epipolar lines of the own endpoints in
# the slot's view (110).  Per candidate past the angles: the band of
# the IoU (47).  Per (image, slot, neighbour line) triangulated: B . n2
# (5).  Per candidate triangulated (every valid word in form (a), which
# writes a row whatever the culls say; past the IoU in form (b)): the
# two ray parameters, the endpoints and their four depths (162), and
# for a row written from an invalid triangulation the sentinel's depths
# (124).  Per valid triangulation still ok: the first sensitivity (93;
# the projections reuse the depths' rotations), the second where the
# first exceeds its threshold (80), the ranges where both pass (12).
# Per row written: the uncertainty (9).  A view's or view pair's
# constants (centres, baselines: a few hundred operations each) are left
# out.
OPS_F = {"line": 88, "neighbour_line": 107, "neighbour_line_iou": 28,
         "candidate": 24, "line_slot": 110, "angle": 47,
         "image_neighbour_line": 5, "triangulated": 162, "invalid": 124,
         "valid": 93, "sensitive": 80, "ranged": 12, "row": 9}
# endpoint triangulation adds |c1|^2 of the own rays (10 a line), |c2|^2
# of the neighbour rays (10), n1 . (C2 - C1) per (own line, slot) (10)
# and n2 . (C1 - C2) per (image, slot, neighbour line) (10), then per
# candidate two midpoints of two rays with their cheirality (202)
OPS_F_ENDPOINTS = dict(OPS_F, line=98, neighbour_line=117, line_slot=120,
                       image_neighbour_line=10, triangulated=202)
# kernel G, an ordered pair of ok proposals of different slots: the 3D
# angle score (17); past it, the scale-invariant score (30); past that,
# the 2D linker (130, the projection amortized over the slot).
OPS_G = {"pair": 17, "angle": 30, "scaleinv": 130}


def ops_f(cfg):
    return OPS_F_ENDPOINTS if cfg.use_endpoints_triangulation else OPS_F


class ProposeWork:
    """Kernel F's work units (:data:`OPS_F`) over calls of
    :meth:`add`, the distinct lines and pairs of lines counted once."""

    def __init__(self, cfg, L, l2d_packed, cam_packed, ranges=None,
                 rows_for_all=False):
        self.cfg, self.L, self.ranges = cfg, L, ranges
        self.l2d, self.cam = l2d_packed, cam_packed
        self.rows_for_all = rows_for_all
        I, dev = cam_packed.shape[0], cam_packed.device
        self.I = I
        self.seen = {k: torch.zeros(n, dtype=torch.bool, device=dev)
                     for k, n in (("line", I * L), ("neighbour_line", I * L),
                                  ("neighbour_line_iou", I * L),
                                  ("line_slot", I * L * I),
                                  ("image_neighbour_line", I * I * L))}
        self.counts = dict.fromkeys(
            ("candidate", "angle", "triangulated", "invalid", "valid",
             "sensitive", "ranged", "row", "survivor"), 0)

    def add(self, row, a, ng_row, b):
        """Candidates [M], each with a valid line on both sides, in
        float32 as the plain version."""
        cfg, L, I = self.cfg, self.L, self.I
        l1, v1, l2, v2 = _rows(self.l2d, self.cam, row, a, ng_row, b,
                               torch.float32)
        n2 = trifun.get_normal_direction(l2, v2)

        def ray_angle(p):
            c = torch.abs(torch.sum(n2 * v1.ray_direction(p), -1))
            return 90.0 - torch.rad2deg(torch.arccos(torch.clamp(c, 0, 1)))

        th = cfg.line_tri_angle_threshold
        angle = (ray_angle(l1.start) >= th) & (ray_angle(l1.end) >= th)
        iou = angle & (trifun.compute_epipolar_iou(l1, v1, l2, v2)
                       >= cfg.IoU_threshold)
        tri_set = torch.ones_like(iou) if self.rows_for_all else iou
        own, nb = row * L + a, ng_row * L + b
        self.seen["line"][own] = True
        self.seen["neighbour_line"][nb] = True
        self.seen["neighbour_line_iou"][nb[angle]] = True
        self.seen["line_slot"][(own * I + ng_row)[angle]] = True
        self.seen["image_neighbour_line"][(row * I * L + nb)[tri_set]] = True
        sub = lambda x: x[tri_set]
        t1, w1, t2, w2 = (Segments(sub(l1.start), sub(l1.end)),
                          CameraViewsBatch(*(sub(x) for x in v1)),
                          Segments(sub(l2.start), sub(l2.end)),
                          CameraViewsBatch(*(sub(x) for x in v2)))
        if cfg.use_endpoints_triangulation:
            tri = trifun.triangulate_line_by_endpoints(t1, w1, t2, w2)
        else:
            tri = trifun.triangulate_line_algebraic(t1, w1, t2, w2)
        valid = tri.score > 0
        # the sensitivities and ranges only where the culls still pass
        live = valid & iou[tri_set]
        s1 = lgeo.sensitivity(tri, w1) > cfg.sensitivity_threshold
        s2 = lgeo.sensitivity(tri, w2) > cfg.sensitivity_threshold
        c = self.counts
        c["candidate"] += len(row)
        c["angle"] += int(angle.sum())
        c["triangulated"] += int(tri_set.sum())
        c["invalid"] += int((~valid).sum()) if self.rows_for_all else 0
        c["valid"] += int(live.sum())
        c["sensitive"] += int((live & s1).sum())
        if self.ranges is not None:
            c["ranged"] += int((live & ~(s1 & s2)).sum())
        c["row"] += int(tri_set.sum()) if self.rows_for_all else 0

    def work(self, survivors):
        """The counts, with ``survivors`` rows written in form (b)."""
        out = dict(self.counts)
        out.update({k: int(v.sum()) for k, v in self.seen.items()})
        out["survivor"] = survivors
        if not self.rows_for_all:
            out["row"] = survivors
        return out


def words_work(cfg, L, K, l2d_packed, cam_packed, words, meta, ok,
               ranges=None):
    """Form (a): kernel F's work units on bucketed words."""
    row, a, ng_row, b, _, valid = tri_propose.decode_words(words, meta, L,
                                                           K)
    own_ok = l2d_packed.reshape(-1, 6)[row * L + a, 4] > 0.5
    nb_ok = l2d_packed.reshape(-1, 6)[ng_row * L + b, 4] > 0.5
    cand = valid & own_ok[:, None] & nb_ok
    w = ProposeWork(cfg, L, l2d_packed, cam_packed, ranges,
                    rows_for_all=True)
    flat = [x.expand_as(b)[cand] for x in (row[:, None], a[:, None],
                                            ng_row, b)]
    for c0 in range(0, len(flat[0]), tri_propose.CANDIDATE_BUDGET):
        w.add(*(x[c0:c0 + tri_propose.CANDIDATE_BUDGET] for x in flat))
    return w.work(int(ok.sum()))


def exhaustive_work(cfg, L, K, l2d_packed, cam_packed, meta, counts,
                    ranges=None):
    """Form (b): kernel F's work units over every (line, slot, neighbour
    line) with a valid line on both sides."""
    G = meta.shape[0]
    dev = meta.device
    slot = torch.arange(K, device=dev).repeat_interleave(L)
    b = torch.arange(L, device=dev).repeat(K)
    w = ProposeWork(cfg, L, l2d_packed, cam_packed, ranges)
    step = max(1, tri_propose.CANDIDATE_BUDGET // max(K * L, 1))
    own_ok = l2d_packed[meta[:, K].long(), :, 4].reshape(-1) > 0.5
    for n0 in range(0, G * L, step):
        n = torch.arange(n0, min(n0 + step, G * L), device=dev)
        n = n[own_ok[n]]
        if not len(n):
            continue
        g = n // L
        ng = meta[g][:, slot].long()
        nb_ok = l2d_packed[ng.clamp(min=0), b[None].expand_as(ng), 4] > 0.5
        cand = (ng >= 0) & nb_ok
        w.add(meta[g, K].long()[:, None].expand_as(ng)[cand],
              (n % L)[:, None].expand_as(ng)[cand], ng[cand],
              b[None].expand_as(ng)[cand])
    return w.work(int(counts.sum()))


def score_work(cfg, L, K, words, meta, tri, ok, budget=1 << 21):
    """Ordered pairs reaching each stage of kernel G (float32)."""
    _, _, _, _, slot, _ = tri_propose.decode_words(words, meta, L, K)
    c3 = cfg.linker3d.to_shared_parent_scoring()
    width = torch.where(ok, torch.arange(ok.shape[1], device=ok.device) + 1,
                        torch.zeros_like(slot)).amax(1)
    counts = {"pair": 0, "angle": 0, "scaleinv": 0}
    for n, w in tri_score.width_chunks(width, budget):
        t, o, s = tri[n, :w], ok[n, :w], slot[n, :w]
        pair = o[:, :, None] & o[:, None] & (s[:, :, None] != s[:, None])
        li = Segments(t[:, :, None, 0:3], t[:, :, None, 3:6],
                      depths=t[:, :, None, 6:8])
        lj = Segments(t[:, None, :, 0:3], t[:, None, :, 3:6])
        a = pair & (expscore(ld.angle(li, lj), c3.th_angle * c3.multiplier)
                    >= c3.score_th)
        si = a & (expscore(ld.dist_endpoints_scaleinv_oneway(li, lj),
                           c3.th_scaleinv * c3.multiplier) >= c3.score_th)
        counts["pair"] += int(pair.sum())
        counts["angle"] += int(a.sum())
        counts["scaleinv"] += int(si.sum())
    return counts


def operations(work, table):
    return int(sum(work[k] * table[k] for k in table if k in work))


# ------------------------------------------------------- seeded inputs
def seeded_inputs(seed=0, device="cuda", n_views=6, n_lines=120, noise=0.3):
    """A triangulator on the synthetic protocol scene with noisy 2D
    segments, a zero-length segment in view 0 (a line with no survivor)
    and the scene's matches; every line is seen by every view, so the
    exhaustive form gives lines of more than 64 survivors."""
    from limap_tpu_torch.testing.synthetic import build_scene
    imagecols, segs, matches, _ = build_scene(n_views, n_lines, n_views,
                                              seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    segs = {k: (v + rng.normal(0, noise, v.shape)).astype(np.float32)
            for k, v in segs.items()}
    segs[0][3, 2:4] = segs[0][3, 0:2]
    tri = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=64),
                                 device=device)
    tri.init(segs, imagecols)
    return tri, matches


def check_triangulator(tri, matches, kernels=True):
    """F (both forms) and G held to plain on a triangulator's inputs:
    yields (name, result)."""
    cfg, L = tri.cfg, tri.L
    ids = tri.img_ids
    rows = [tri.id2idx[i] for i in ids]
    mlist = [matches[i] for i in ids]
    per_key, per_val, nbr_rows, K, Tc = tri._gather_edges(rows, mlist)
    words, meta, _ = tri._fill_group(per_key, per_val, nbr_rows, rows, 0,
                                     len(rows), K, Tc)
    words, meta = tri._device(words), tri._device(meta)
    args = (cfg, L, K, tri._l2d_packed, tri._cam_packed)
    fk = tri_propose.propose if kernels else tri_propose.propose_plain
    out_k = fk(*args, words, meta, tri.ranges)
    out_p = tri_propose.propose_plain(*args, words, meta, tri.ranges)
    yield "tri_propose words", compare_propose(*args, words, meta, out_k,
                                               out_p, tri.ranges)
    tri_in, ok_in = out_p
    gk = tri_score.score if kernels else tri_score.score_plain
    yield "tri_score words", compare_score(
        *args, words, meta, tri_in, ok_in,
        gk(*args, words, meta, tri_in, ok_in, return_scores=True),
        tri_score.score_plain(*args, words, meta, tri_in, ok_in,
                              return_scores=True))

    nbrs = [[tri.id2idx[n] for n in sorted(matches[i])] for i in ids]
    K = tri._slot_count(nbrs)
    meta = tri._device(tri._meta(nbrs, rows, K))
    args = (cfg, L, K, tri._l2d_packed, tri._cam_packed)
    ck = tri_propose.count_exhaustive if kernels \
        else tri_propose.count_exhaustive_plain
    pk = tri_propose.propose_exhaustive if kernels \
        else tri_propose.propose_exhaustive_plain
    counts_k = ck(*args, meta, tri.ranges)
    counts_p = tri_propose.count_exhaustive_plain(*args, meta, tri.ranges)
    W = tri_propose.bucket_width(int(torch.maximum(counts_k, counts_p).max()))
    out_k = pk(*args, meta, W, tri.ranges)
    out_p = tri_propose.propose_exhaustive_plain(*args, meta, W, tri.ranges)
    yield "tri_propose exhaustive", compare_exhaustive(
        *args, meta, counts_k, counts_p, out_k, out_p, tri.ranges)
    w_in, tri_in, ok_in = out_p
    w_in = w_in.reshape(len(rows), L, W)
    yield "tri_score exhaustive", compare_score(
        *args, w_in, meta, tri_in, ok_in,
        gk(*args, w_in, meta, tri_in, ok_in, return_scores=True),
        tri_score.score_plain(*args, w_in, meta, tri_in, ok_in,
                              return_scores=True))


def check_all(device="cuda"):
    """The seeded cases on ``device``: yields (name, case, result)."""
    for case, kw in (("6x120, 0.3 px", {}),
                     ("4x40, endpoints", {"n_views": 4, "n_lines": 40})):
        tri, matches = seeded_inputs(device=device, **{
            k: v for k, v in kw.items()})
        if case.endswith("endpoints"):
            import dataclasses
            tri.cfg = dataclasses.replace(tri.cfg,
                                          use_endpoints_triangulation=True)
        for name, res in check_triangulator(tri, matches,
                                            kernels=device != "cpu"):
            yield name, case, res


def main():
    from concurrent.futures import ThreadPoolExecutor

    from limap_tpu_torch.ops import cuda_build
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m.build(), (tri_propose, tri_score)))
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}",
              flush=True)
    for name, case, res in check_all():
        print(f"{name} [{case}]: {json.dumps(res)}", flush=True)
        if not res["ok_to_plain"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
