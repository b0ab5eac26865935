"""The localization kernels held to their plain versions on seeded
inputs: ``trace_roots`` (the PnL root finder), ``pose_score`` (MSAC
scoring) and ``epipolar_iou_grid``.  ``chip_smoke.py`` (phase 2) and
``tests/test_torch_cuda.py`` share these inputs and comparisons.

    python -m limap_tpu_torch.testing.kernel_checks

builds the three kernels on one GPU and prints each comparison (one H100,
about a minute).  Every input set comes from a seed; the third of each
is degenerate on purpose: parallel 3D lines for the root finder, poses
that put the scene behind the camera (and NaN poses) for the scoring,
zero-length segments for the IoU grid.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from limap_tpu_torch.ops.pose_score import (ScoreParams, pose_score,
                                            pose_score_plain)
from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.ops.trace_roots import (alpha_grid, any_perp,
                                             family_eval, rot_axis_angle,
                                             trace_roots, trace_roots_plain)
from limap_tpu_torch.ops.epipolar_iou import (epipolar_iou_grid,
                                              epipolar_iou_grid_plain)

# Tolerances of a kernel against its plain version.  The root finder:
# sinf/cosf/atan2f and contracted multiply-adds round differently from
# torch's eager ops.  A root of a grid sign change moves by up to 2.5e-4
# in the rotation's entries (measured on an H100), and its validity may
# differ in a few slots where G touches zero.  The double roots are the
# n_roots smallest interior minima of |G|, refined by ternary search on a
# flat G^2: near-tied minima come in another order, so they are compared
# as sets per run, each within 2e-3, a few without a partner.  An
# instance whose second line is parallel to the first has det = 0 on the
# whole circle (Tr(C2 R) no longer depends on the family's second angle):
# its G >= 0 only touches zero, so its double roots and their flags are
# rounding noise on any device.  Such rank-deficient instances (max |det|
# on the grid under RANK_TOL; the C are normalized, so a conditioned
# instance has max |det| of order 1e-3 or more) are counted and their
# double roots left out of the comparison.  Where two roots lie close,
# G is small between them and its float32 sign is noise over a stretch
# of the circle, so a bisected root may land anywhere in that stretch:
# a root beyond ROOTS_SIMPLE_TOL of the plain one is settled in float64
# (:func:`root_witness`), never by a share of free slots.
ROOTS_SIMPLE_TOL = 1e-3
RANK_TOL = 1e-4
ROOTS_FLAG_SHARE = 0.01
ROOTS_DOUBLE_TOL = 2e-3
ROOTS_UNPAIRED_SHARE = 0.02
WITNESS_FACTOR = 4.0
WITNESS_POINTS = 16
WITNESS_ALPHA = 4 * 2.0 ** -22      # four float32 ulps of pi
# The scores and errors are held to the plain version within what
# rounding can explain.  Contracted multiply-adds and the block reduction
# round differently from torch's eager ops, and some terms amplify
# rounding: a line whose projection is short (its direction from two
# nearby pixels), a point near the camera plane, an error that crosses a
# threshold and so moves a score by up to th^2.  Each score's and each
# error's sensitivity is measured, not guessed: the plain version in f32
# on CONDITION_DRAWS copies of the inputs with a random half of every
# input's entries moved by one ulp (:func:`one_ulp`), which also re-draws
# its internal rounding; the largest move of each score, and of each
# error in pixels (sqrt), is its spread.  A score may differ by
# SCORE_RTOL plus CONDITION_FACTOR spreads; an error that can decide a
# mask (either side below ERROR_RANGE th^2, the widest LO threshold) by
# ERROR_PX_TOL px plus CONDITION_FACTOR spreads; a share BEYOND_SHARE of
# either may lie beyond (a spread of a few draws can miss a rare move).
# Without the spread, the plain version on hypotheses from random minimal
# samples moves by up to 3e-3 of a score and 70 px of an error when its
# inputs move by one ulp (tests/test_torch_kernel_checks.py).  The
# kernel's masks are its own errors against th^2.  An infinite error
# (depth <= 1e-6) may face a finite one only where that one saturates
# (>= ERROR_RANGE th^2): a depth within rounding of the cheirality bound.
SCORE_RTOL = 1e-5
ERROR_RANGE = 10.0
ERROR_PX_TOL = 2e-3
CONDITION_FACTOR = 16.0
CONDITION_DRAWS = 4
BEYOND_SHARE = 1e-3
# The IoU: fp32, the same operations; near-parallel intersections amplify
# a last-place difference, so at most 0.1 % of the pairs beyond 1e-4.
IOU_TOL = 1e-4
IOU_SHARE = 1e-3


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def trace_roots_inputs(seed: int, B: int = 2048, degenerate: bool = False):
    """(v1, n1, C2, C3) of B p3ll-style instances (normalized C), as
    numpy f32: lines seen from a random pose; with ``degenerate`` a third
    of them have their second line parallel to the first."""
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(size=(B, 3))).as_matrix()
    t = rng.normal(size=(B, 3)) + [0.0, 0.0, 6.0]
    P = rng.normal(size=(B, 3, 3)) * 2
    V = _unit(rng.normal(size=(B, 3, 3)))
    if degenerate:
        V[: B // 3, 1] = V[: B // 3, 0]
    a = np.einsum("bij,bkj->bki", R, P) + t[:, None]
    b = np.einsum("bij,bkj->bki", R, P + 0.7 * V) + t[:, None]
    n = _unit(np.cross(a, b))
    C2 = V[:, 1, :, None] * n[:, 1, None, :]
    C3 = V[:, 2, :, None] * n[:, 2, None, :]
    C2 /= np.linalg.norm(C2, axis=(1, 2), keepdims=True) + 1e-12
    C3 /= np.linalg.norm(C3, axis=(1, 2), keepdims=True) + 1e-12
    return tuple(np.ascontiguousarray(x, np.float32)
                 for x in (V[:, 0], n[:, 0], C2, C3))


def rank_deficient(v1, n1, C2, C3, alphas) -> np.ndarray:
    """[B] bool: instances whose max |det| on the grid is under RANK_TOL
    (the plain version's G on the grid)."""
    det = family_eval(alphas.expand(v1.shape[0], -1), v1[:, None],
                      n1[:, None], C2[:, None], C3[:, None])[2]
    return (det.abs().amax(1) < RANK_TOL).cpu().numpy()


def root_alpha(R, v1, n1):
    """The family angle of rotations R [M, 3, 3] of the instances'
    (v1, n1) [M, 3]: R v1 = d(alpha) = cos(alpha) u + sin(alpha) w."""
    u = any_perp(n1)
    w = cross(n1, u)
    d = (R @ v1[:, :, None])[..., 0]
    return torch.atan2((d * w).sum(-1) / (w * w).sum(-1), (d * u).sum(-1))


def family_rotation(alpha, v1, n1, C2, C3):
    """The rotation of the family at ``alpha``, in the data's dtype."""
    _, beta, _, d, R0 = family_eval(alpha, v1, n1, C2, C3)
    return rot_axis_angle(d, beta) @ R0


def root_witness(args, inst, Rk, Rp):
    """Float64 witness of bisected roots where the kernel's rotation Rk
    and the plain one Rp [M, 3, 3] of instances ``inst`` [M] differ by
    more than ROOTS_SIMPLE_TOL.  ``args`` = (v1, n1, C2, C3, alphas).
    A root passes when float64 shows it is a root to float32's
    resolution: the kernel's family angle lies in the plain root's grid
    cell (the same root), the family's G there is within WITNESS_FACTOR
    times the plain version's own float32 error of G (measured at
    WITNESS_POINTS angles from one root to the other) of zero, and its
    rotation within ROOTS_SIMPLE_TOL of the float64 family's at that
    angle, plus how far that rotation moves within WITNESS_ALPHA of the
    angle, plus WITNESS_FACTOR times the plain version's own float32
    error of the rotation there.  Returns ([M] bool, [M] dicts)."""
    idx = torch.as_tensor(np.asarray(inst), device=args[0].device)
    data = [a[idx] for a in args[:4]]
    d64 = [a.double() for a in data]
    grid = args[4].double()
    ak, ap = (root_alpha(torch.as_tensor(R, device=idx.device).double(),
                         d64[0], d64[1]) for R in (Rk, Rp))
    cell = lambda a: torch.searchsorted(grid, a.contiguous()) - 1
    same_cell = cell(ak) == cell(ap)
    t = torch.linspace(0.0, 1.0, WITNESS_POINTS, dtype=torch.float64,
                       device=idx.device)
    pts = ap[:, None] + (ak - ap)[:, None] * t                 # [M, P]
    unsq = lambda x: [a[:, None] for a in x]
    g32 = family_eval(pts.float(), *unsq(data))[0].double()
    g64 = family_eval(pts.float().double(), *unsq(d64))[0]
    e32 = (g32 - g64).abs().amax(1)
    G = family_eval(ak, *d64)[0]
    # the float64 rotation at the kernel's angle and at WITNESS_ALPHA
    # either side of it (a few float32 ulps of an angle near pi): where
    # the second angle beta is ill-conditioned the rotation moves by more
    # than ROOTS_SIMPLE_TOL within the angle's float32 resolution
    delta = WITNESS_ALPHA * ak.new_tensor([0.0, -1.0, 1.0])
    R64 = family_rotation(ak[:, None] + delta, *unsq(d64))     # [M, 3, ...]
    spread = (R64[:, 1:] - R64[:, :1]).abs().amax((-1, -2, -3))
    # the plain version's own float32 error of the rotation at that angle
    # (beta comes from Nc, Ns and det, differences of products that all
    # run small between two close roots)
    a32 = ak.float()
    r32_err = (family_rotation(a32, *data).double()
               - family_rotation(a32.double(), *d64)).abs().amax((-1, -2))
    r_err = (torch.as_tensor(Rk, device=idx.device).double()
             - R64[:, 0]).abs().amax((-1, -2))
    ok = same_cell & (G.abs() <= WITNESS_FACTOR * e32) \
        & (r_err <= ROOTS_SIMPLE_TOL + spread + WITNESS_FACTOR * r32_err)
    detail = [{"instance": int(i), "alpha_diff": float(k - p),
               "same_cell": bool(c), "g64": float(g), "g32_err": float(e),
               "rotation_err": float(r), "rotation_spread": float(sp),
               "rotation32_err": float(r3)}
              for i, k, p, c, g, e, r, sp, r3 in zip(
                  inst, ak.tolist(), ap.tolist(), same_cell.tolist(),
                  G.abs().tolist(), e32.tolist(), r_err.tolist(),
                  spread.tolist(), r32_err.tolist())]
    return ok.cpu().numpy(), detail


def compare_trace_roots(out, ref, n_roots: int, deficient,
                        args=None) -> dict:
    """Kernel (R, ok) against plain (R, ok), per instance 2 n_roots slots:
    the bisected roots slot by slot (validity flags that differ, the
    largest rotation error where both are valid), the double roots as
    sets (the largest error of a root to its nearest partner, and the
    roots without one within ROOTS_DOUBLE_TOL) on the instances that are
    not rank-deficient (``deficient`` [B] bool, see RANK_TOL).  A
    bisected root beyond ROOTS_SIMPLE_TOL passes only on a float64
    witness (:func:`root_witness`), which needs the inputs ``args``
    (v1, n1, C2, C3, alphas)."""
    (Rk, okk), (Rp, okp) = ([x.cpu().numpy() for x in o] for o in (out, ref))
    shape = (len(okp), 2, n_roots)         # instance, branch, slot
    Rk, Rp = Rk.reshape(shape + (9,)), Rp.reshape(shape + (9,))
    okk, okp = okk.reshape(shape), okp.reshape(shape)
    both = okk[:, 0] & okp[:, 0]
    err_all = np.abs(Rk[:, 0] - Rp[:, 0]).max(-1)
    err = err_all[both]
    beyond = both & (err_all > ROOTS_SIMPLE_TOL)
    witnessed = np.zeros_like(beyond)
    detail = []
    if args is not None and beyond.any():
        n, s = np.nonzero(beyond)
        witnessed[n, s], detail = root_witness(
            args, n, Rk[n, 0, s].reshape(-1, 3, 3),
            Rp[n, 0, s].reshape(-1, 3, 3))
    # double roots: pairwise distances within an instance
    dk, dp = okk[:, 1] & ~deficient[:, None], okp[:, 1] & ~deficient[:, None]
    dist = np.abs(Rk[:, 1, :, None] - Rp[:, 1, None, :]).max(-1)
    dist = np.where(dk[:, :, None] & dp[:, None, :], dist, np.inf)
    paired = np.concatenate([dist.min(-1)[dk], dist.min(-2)[dp]])
    res = {"slots": int(okp.size), "valid": int(okp.sum()),
           "rank_deficient": int(deficient.sum()),
           "simple_flag_diffs": int((okk[:, 0] != okp[:, 0]).sum()),
           "simple_max_err": float(err.max(initial=0.0)),
           "simple_beyond_tol": int(beyond.sum()),
           "simple_witnessed": int(witnessed.sum()),
           "witness": detail[:8],
           "double_valid": int(dk.sum() + dp.sum()),
           "double_unpaired": int((paired > ROOTS_DOUBLE_TOL).sum()),
           "double_max_err": float(paired[paired <= ROOTS_DOUBLE_TOL]
                                   .max(initial=0.0))}
    res["max_abs_err"] = max(res["simple_max_err"], res["double_max_err"])
    res["ok"] = bool(
        res["simple_flag_diffs"] <= ROOTS_FLAG_SHARE * max(res["valid"], 1)
        and res["simple_beyond_tol"] == res["simple_witnessed"]
        and res["double_unpaired"]
        <= ROOTS_UNPAIRED_SHARE * max(res["double_valid"], 1))
    return res


def pose_score_inputs(seed: int, H: int = 2048, Np: int = 1000,
                      Nl: int = 200, degenerate: bool = False):
    """A camera, H poses around the truth (far off ones too) and the
    matches, numpy f32: qvec, tvec, kvec, p3, p2, l3s, l3e, l2s, l2e.
    With ``degenerate`` an eighth of the poses have the scene behind the
    camera and a few are NaN, as a degenerate minimal sample gives."""
    rng = np.random.default_rng(seed)
    kvec = np.array([500.0, 500.0, 320.0, 240.0])
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R_gt = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
    t_gt = -R_gt @ (rng.normal(size=3) * 0.5)

    def project(X):
        c = X @ R_gt.T + t_gt
        return (c[..., :2] / c[..., 2:]) * K[[0, 1], [0, 1]] + K[:2, 2]

    p3 = rng.normal(size=(Np, 3)) * 3 + [0.0, 0.0, 10.0]
    p2 = project(p3) + rng.normal(size=(Np, 2)) * 0.5
    p2[: Np // 3] += rng.uniform(50, 200, (Np // 3, 2))
    l3s = rng.normal(size=(Nl, 3)) * 3 + [0.0, 0.0, 10.0]
    l3e = l3s + rng.normal(size=(Nl, 3)) * 2
    l2s = project(l3s) + rng.normal(size=(Nl, 2)) * 0.5
    l2e = project(l3e) + rng.normal(size=(Nl, 2)) * 0.5
    R = Rotation.from_rotvec(rng.normal(size=(H, 3)) * 0.05).as_matrix() @ R_gt
    t = t_gt + rng.normal(size=(H, 3)) * 0.3
    q = Rotation.from_matrix(R).as_quat()[:, [3, 0, 1, 2]]
    if degenerate:
        t[: H // 8, 2] -= 30.0
        q[H // 8: H // 8 + 5] = np.nan
    return tuple(np.ascontiguousarray(x, np.float32) for x in
                 (q, t, kvec, p3, p2, l3s, l3e, l2s, l2e))


def one_ulp(arrays, seed):
    """f32 copies of the numpy arrays, a random half of each one's entries
    moved up by one ulp."""
    rng = np.random.default_rng(seed)
    out = []
    for a in arrays:
        a = np.asarray(a, np.float32)
        up = np.nextafter(a, np.float32(np.inf), dtype=np.float32)
        out.append(np.where(rng.random(a.shape) < 0.5, up, a)
                   .astype(np.float32))
    return out


def pose_score_spread(args, params: ScoreParams,
                      draws: int = CONDITION_DRAWS):
    """The sensitivity of the plain scoring to rounding, per score and
    per error: (score spread [H], (point, line) error spreads in pixels),
    from the plain version on ``draws`` copies of the inputs moved by one
    ulp (on the inputs' device)."""
    host = [a.cpu().numpy() for a in args]
    device = args[0].device

    def plain(arrays):
        t = [torch.as_tensor(a, device=device) for a in arrays]
        return (pose_score_plain(*t, params)[0],
                [e.sqrt() for e in pose_score_plain(*t, params,
                                                    errors=True)])

    s0, e0 = plain(host)
    ds = torch.zeros_like(s0)
    de = [torch.zeros_like(e) for e in e0]
    for k in range(draws):
        s1, e1 = plain(one_ulp(host, k))
        ds = torch.fmax(ds, (s1 - s0).abs())
        de = [torch.fmax(d, (b - a).abs()) for d, a, b in zip(de, e0, e1)]
    return ds, de


def compare_pose_score(out, ref, errors_out, errors_ref,
                       params: ScoreParams, spread) -> dict:
    """Scores, inlier masks and errors of the kernel against plain, with
    the plain version's rounding spread (:func:`pose_score_spread`)."""
    sk, pk, lk = (x.cpu().numpy() for x in out)
    sp, pp, lp = (x.cpu().numpy() for x in ref)
    ek = [x.cpu().numpy() for x in errors_out]
    ep = [x.cpu().numpy() for x in errors_ref]
    ss = spread[0].cpu().numpy()
    se = [x.cpu().numpy() for x in spread[1]]
    res = {"poses": int(len(sp))}
    same_nan = np.array_equal(np.isnan(sk), np.isnan(sp))
    fin = np.isfinite(sp)
    diff = np.abs(sk[fin] - sp[fin])
    rel = diff / np.maximum(np.abs(sp[fin]), 1e-30)
    res["score_max_rel_err"] = float(rel.max(initial=0.0))
    res["max_abs_err"] = float(diff.max(initial=0.0))
    score_beyond = diff > SCORE_RTOL * np.abs(sp[fin]) \
        + CONDITION_FACTOR * ss[fin]
    res["scores_beyond_tol"] = int(score_beyond.sum())
    own = off = beyond = checked = inf_mismatch = saturated_inf = 0
    px_max = 0.0
    with np.errstate(invalid="ignore"):
        for mk, mp, a, b, d, th2 in ((pk, pp, ek[0], ep[0], se[0],
                                      params.th_pt2),
                                     (lk, lp, ek[1], ep[1], se[1],
                                      params.th_ln2)):
            tol = ERROR_PX_TOL + CONDITION_FACTOR * d
            # the kernel's masks are its errors against th^2
            own += int(((mk != (a <= th2))
                        & (np.abs(a - th2) > 1e-5 * th2)).sum())
            near = np.abs(np.sqrt(b) - np.sqrt(th2)) <= tol
            off += int(((mk != mp) & ~near).sum())
            flip = np.isinf(a) != np.isinf(b)
            finite_side = np.where(np.isinf(a), b, a)
            sat = flip & (finite_side >= ERROR_RANGE * th2)
            inf_mismatch += int((flip & ~sat).sum())
            saturated_inf += int(sat.sum())
            inf_mismatch += int((np.isnan(a) != np.isnan(b)).sum())
            f = np.isfinite(a) & np.isfinite(b) \
                & (np.minimum(a, b) < ERROR_RANGE * th2)
            dev = np.abs(np.sqrt(a[f]) - np.sqrt(b[f]))
            checked += int(f.sum())
            beyond += int((dev > tol[f]).sum())
            px_max = max(px_max, float(dev.max(initial=0.0)))
    res.update(mask_diffs_to_own_errors=own, mask_diffs_off_threshold=off,
               errors_checked=checked, errors_beyond_tol=beyond,
               error_max_px=px_max, inf_against_finite=inf_mismatch,
               inf_against_saturated=saturated_inf)
    res["ok"] = bool(same_nan and own == 0 and inf_mismatch == 0
                     and res["scores_beyond_tol"]
                     <= BEYOND_SHARE * max(int(fin.sum()), 1)
                     and beyond + off <= BEYOND_SHARE * max(checked, 1))
    return res


def epipolar_inputs(seed: int, Nr: int = 490, Nt: int = 490,
                    degenerate: bool = False):
    """(tgt [Nt, 4], ep_s [Nr, 3], ep_e [Nr, 3]) numpy f32: segments of
    an 800x600 image and the normalized epipolar lines of reference
    endpoints from a second view; with ``degenerate`` a tenth of the
    target segments have zero length."""
    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 400], [0, 700.0, 300], [0, 0, 1]])
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
    tr = np.array([0.5, 0.05, 0.02]) + rng.normal(size=3) * 0.05
    tx = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]],
                   [-tr[1], tr[0], 0]])
    F = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    ref = rng.uniform([0, 0, 0, 0], [800, 600, 800, 600], (Nr, 4))
    tgt = rng.uniform([0, 0, 0, 0], [800, 600, 800, 600], (Nt, 4))
    if degenerate:
        tgt[: Nt // 10, 2:] = tgt[: Nt // 10, :2]

    def lines(p):
        e = np.c_[p, np.ones(len(p))] @ F.T
        return e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-12)

    return tuple(np.ascontiguousarray(x, np.float32)
                 for x in (tgt, lines(ref[:, :2]), lines(ref[:, 2:])))


def compare_epipolar(out, ref) -> dict:
    a, b = out.cpu().numpy(), ref.cpu().numpy()
    same_nan = np.array_equal(np.isnan(a), np.isnan(b))
    f = np.isfinite(b) & np.isfinite(a)
    err = np.abs(a[f] - b[f])
    res = {"pairs": int(b.size), "max_abs_err": float(err.max(initial=0.0)),
           "beyond_tol": int((err > IOU_TOL).sum()),
           "nan": int(np.isnan(b).sum())}
    res["ok"] = bool(same_nan and res["beyond_tol"] <= IOU_SHARE * b.size)
    return res


def check_one(kernel: str, seed: int, degenerate: bool = False,
              device="cuda", n_roots: int = 4) -> dict:
    """One kernel against its plain version on one seeded input."""
    def on(x):
        return torch.as_tensor(x, device=device)

    if kernel == "trace_roots":
        args = [on(x) for x in trace_roots_inputs(seed, degenerate=degenerate)]
        grid = on(alpha_grid(256))
        return compare_trace_roots(trace_roots(*args, grid, 48, n_roots),
                                   trace_roots_plain(*args, grid, 48,
                                                     n_roots), n_roots,
                                   rank_deficient(*args, grid),
                                   args + [grid])
    if kernel == "pose_score":
        args = [on(x) for x in pose_score_inputs(seed, degenerate=degenerate)]
        params = ScoreParams.from_thresholds(10.0, 10.0)
        return compare_pose_score(
            pose_score(*args, params), pose_score_plain(*args, params),
            pose_score(*args, params, errors=True),
            pose_score_plain(*args, params, errors=True), params,
            pose_score_spread(args, params))
    args = [on(x) for x in epipolar_inputs(seed, degenerate=degenerate)]
    return compare_epipolar(epipolar_iou_grid(*args),
                            epipolar_iou_grid_plain(*args))


KERNELS = ("trace_roots", "pose_score", "epipolar_iou_grid")
SEEDS = ((0, False), (1, False), (2, True))


def check_all(device="cuda") -> list:
    """Every kernel on the three seeded inputs (the third degenerate):
    [(kernel, seed, result)].  Launches made here are not counted on a
    path: the callers reset the counts afterwards."""
    return [(k, seed, check_one(k, seed, deg, device))
            for seed, deg in SEEDS for k in KERNELS]


def main() -> int:
    from limap_tpu_torch.ops import cuda_build, epipolar_iou, pose_score as ps
    from limap_tpu_torch.ops import trace_roots as tr
    if not torch.cuda.is_available():
        print("kernel_checks: no CUDA device visible")
        return 2
    for mod in (tr, ps, epipolar_iou):
        mod.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}",
              flush=True)
    results = check_all()
    torch.cuda.synchronize()
    for name, seed, res in results:
        print(name, seed, json.dumps(res), flush=True)
    return 0 if all(r["ok"] for _, _, r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
