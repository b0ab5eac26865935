"""Hybrid point-line absolute pose estimation (PnPL).

Minimal samples of all four solver types {P3P, P2P1LL, P1P2LL, P3LL} are
drawn with the combinatorial type probabilities and solved together;
all (pose, correspondence) errors are scored as one [H, N] pass
(:mod:`limap_tpu_torch.ops.pose_score`); the top hypotheses then get an
annealed local optimization by :func:`solve_jointloc` and the winner an
f64 polish on the host.  Method None is the direct nonlinear
optimization from a given pose.

The sample indices are drawn by a CPU ``torch.Generator`` seeded from
``seed`` and moved to the device, so the card and the CPU score the same
hypotheses.
"""

from __future__ import annotations

import contextlib
import dataclasses
from math import comb
from typing import Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraPose
from limap_tpu_torch.base.pose import quat_to_rotmat, rotmat_to_quat
from limap_tpu_torch.estimators.p3p import p3p
from limap_tpu_torch.estimators.pnl_solvers import (line2d_to_normal, p1p2ll,
                                                    p2p1ll, p3ll)
from limap_tpu_torch.ops.pose_score import ScoreParams, pose_score
from limap_tpu_torch.optimize.hybrid_localization import (
    LineLocConfig, solve_jointloc, solve_jointloc_batch)


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """RANSAC options.  The top ``lo_topk`` hypotheses each get
    ``lo_rounds`` of annealed refit and rescore, with squared thresholds
    from ``threshold_multiplier`` x down to 1 x."""

    method: Optional[str] = "hybrid"   # None | "ransac" | "solver" | "hybrid"
    thres: float = 10.0
    thres_point: float = 10.0
    thres_line: float = 10.0
    n_hypotheses: int = 2048
    weight_point: float = 1.0
    weight_line: float = 1.0
    final_least_squares: bool = True
    lo_topk: int = 4
    lo_rounds: int = 4
    threshold_multiplier: float = 10.0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RansacOptions":
        if d is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _polish_pose_f64(R0, t0, kvec, p3ds, p2ds, pt_mask, l3d, l2ds, ln_mask,
                     rounds=3, gn_iters=8):
    """f64 Gauss-Newton polish of a pose on fixed inlier sets, on the
    host: numeric-difference GN over [rotvec, t] of the point
    reprojection and line endpoint-perpendicular residuals."""
    K = np.array([[kvec[0], 0, kvec[2]], [0, kvec[1], kvec[3]], [0, 0, 1.0]])
    p3 = np.asarray(p3ds, np.float64)[pt_mask]
    p2 = np.asarray(p2ds, np.float64)[pt_mask]
    l3 = np.asarray(l3d, np.float64)[ln_mask]    # [M, 2, 3]
    l2 = np.asarray(l2ds, np.float64)[ln_mask]   # [M, 2, 2]

    def rodrigues(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0.0]])
        return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx

    def residuals(x, R_base):
        R = rodrigues(x[:3]) @ R_base
        t = x[3:]
        out = []
        if len(p3):
            q = (K @ (R @ p3.T + t[:, None])).T
            out.append(((q[:, :2] / q[:, 2:3]) - p2).ravel())
        if len(l3):
            qs = (K @ (R @ l3[:, 0].T + t[:, None])).T
            qe = (K @ (R @ l3[:, 1].T + t[:, None])).T
            ps = qs[:, :2] / qs[:, 2:3]
            pe = qe[:, :2] / qe[:, 2:3]
            d = pe - ps
            d /= (np.linalg.norm(d, axis=1, keepdims=True) + 1e-12)
            n = np.stack([-d[:, 1], d[:, 0]], axis=1)
            r1 = np.sum(n * (l2[:, 0] - ps), axis=1)
            r2 = np.sum(n * (l2[:, 1] - ps), axis=1)
            out.append(np.concatenate([r1, r2]))
        return np.concatenate(out) if out else np.zeros(1)

    R, t = np.asarray(R0, np.float64), np.asarray(t0, np.float64)
    if len(p3) + len(l3) < 3:
        return R, t
    for _ in range(rounds):
        x = np.concatenate([np.zeros(3), t])
        for _ in range(gn_iters):
            r0 = residuals(x, R)
            J = np.zeros((len(r0), 6))
            h = 1e-6
            for j in range(6):
                dx = np.zeros(6)
                dx[j] = h
                J[:, j] = (residuals(x + dx, R) - residuals(x - dx, R)) \
                    / (2 * h)
            JTJ = J.T @ J + 1e-9 * np.eye(6)
            try:
                step = np.linalg.solve(JTJ, -J.T @ r0)
            except np.linalg.LinAlgError:
                break
            x_new = x + step
            if (residuals(x_new, R) ** 2).sum() < (r0 ** 2).sum():
                x = x_new
            else:
                break
        R = rodrigues(x[:3]) @ R
        t = x[3:]
    return R, t


def _stage(prof, name):
    return prof.stage(name) if prof is not None else contextlib.nullcontext()


def minimal_hypotheses(kv, p3, p2, l3d, l2s, l2e, n_hypotheses: int,
                       seed: int = 0):
    """Candidate poses from minimal samples of the four solver types,
    their counts in proportion to the number of distinct samples of each
    type: (Rs [M, 3, 3], ts [M, 3], valid [M]) on the data's device.

    kv [4], p3 [Np, 3], p2 [Np, 2], l2s / l2e [Nl, 2] are fp32 tensors
    on one device; l3d [Nl, 2, 3] is the numpy 3D segment of each 2D
    line.  The sample indices come from a CPU generator seeded with
    ``seed``, so every device solves the same samples."""
    device = kv.device
    n_pts, n_lines = len(p3), len(l2s)
    weights = {
        "p3p": comb(n_pts, 3),
        "p2p1ll": comb(n_pts, 2) * n_lines,
        "p1p2ll": n_pts * comb(n_lines, 2),
        "p3ll": comb(n_lines, 3),
    }
    total_w = float(sum(weights.values()))
    if total_w == 0:
        raise ValueError(
            "PnPL RANSAC needs >= 3 correspondences (points + lines)")
    n_samples = {k: int(round(n_hypotheses * float(w) / total_w))
                 for k, w in weights.items()}

    def bearings(p2d):
        u = (p2d[..., 0] - kv[2]) / kv[0]
        v = (p2d[..., 1] - kv[3]) / kv[1]
        b = torch.stack([u, v, torch.ones_like(u)], dim=-1)
        return b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)

    if n_lines:
        ln_n = line2d_to_normal(l2s, l2e, kv)
        ln_P = torch.as_tensor(0.5 * (l3d[:, 0] + l3d[:, 1]),
                               dtype=torch.float32, device=device)
        ln_V = l3d[:, 1] - l3d[:, 0]
        ln_V = torch.as_tensor(
            ln_V / (np.linalg.norm(ln_V, axis=-1, keepdims=True) + 1e-12),
            dtype=torch.float32, device=device)

    gen = torch.Generator().manual_seed(int(seed))

    def draw(n, shape):
        return torch.randint(0, n, shape, generator=gen).to(device)

    blocks = []  # (Rs, ts, ok) per solver type
    if n_samples["p3p"] > 0:
        # degenerate (repeated) samples score poorly: no rejection
        idx = draw(n_pts, (n_samples["p3p"], 3))
        blocks.append(p3p(bearings(p2[idx]), p3[idx]))
    if n_samples["p2p1ll"] > 0:
        hp = n_samples["p2p1ll"]
        ip, il = draw(n_pts, (hp, 2)), draw(n_lines, (hp,))
        blocks.append(p2p1ll(bearings(p2[ip]), p3[ip], ln_n[il], ln_P[il],
                             ln_V[il], n_roots=4))
    if n_samples["p1p2ll"] > 0:
        hp = n_samples["p1p2ll"]
        ip, il = draw(n_pts, (hp,)), draw(n_lines, (hp, 2))
        blocks.append(p1p2ll(bearings(p2[ip]), p3[ip], ln_n[il], ln_P[il],
                             ln_V[il], n_roots=4))
    if n_samples["p3ll"] > 0:
        il = draw(n_lines, (n_samples["p3ll"], 3))
        blocks.append(p3ll(ln_n[il], ln_P[il], ln_V[il], n_roots=4))
    return (torch.cat([b[0].reshape(-1, 3, 3) for b in blocks]),
            torch.cat([b[1].reshape(-1, 3) for b in blocks]),
            torch.cat([b[2].reshape(-1) for b in blocks]))


def pl_estimate_absolute_pose(cfg: dict, l3ds, l3d_ids, l2ds, p3ds, p2ds,
                              camera, campose=None, inliers_line=None,
                              inliers_point=None, seed: int = 0,
                              device=None, prof=None):
    """Estimate a camera pose from 2D-3D point and line matches.

    Args:
      cfg: {"ransac": {...}, "optimize": {...}, "line_cost_func": ...}
      l3ds: (2, 3) 3D segments (track lines); l3d_ids: per 2D line, its
        index into l3ds; l2ds: (2, 2) observed 2D segments.
      p3ds, p2ds: point matches; camera: a pinhole Camera; campose: the
        initial pose of the direct mode.
      device: where the tensors live (``None``: cuda).  prof: an optional
        StageProfiler, which times the stages pnpl_sample_solve,
        pnpl_score and pnpl_lo_polish.

    Returns (CameraPose, RANSAC statistics or None).
    """
    device = resolve_device(device)
    ransac_cfg = RansacOptions.from_dict(cfg.get("ransac"))
    loc_cfg = LineLocConfig.from_dict(cfg.get("optimize"))
    if "line_cost_func" in cfg:
        loc_cfg = dataclasses.replace(
            loc_cfg, cost_function=LineLocConfig.from_dict(
                {"cost_function": cfg["line_cost_func"]}).cost_function)

    l3ds = np.asarray(l3ds, np.float64).reshape(-1, 2, 3)
    l3d_ids = np.asarray(l3d_ids, np.int64).reshape(-1)
    l2ds = np.asarray(l2ds, np.float64).reshape(-1, 2, 2)
    p3ds = np.asarray(p3ds, np.float64).reshape(-1, 3)
    p2ds = np.asarray(p2ds, np.float64).reshape(-1, 2)
    l3d_sel = l3ds[l3d_ids] if len(l3d_ids) else np.zeros((0, 2, 3))
    kvec = camera.kvec()

    if ransac_cfg.method is None:
        if inliers_point is not None:
            p3ds, p2ds = p3ds[inliers_point], p2ds[inliers_point]
        if inliers_line is not None:
            l3d_sel, l2ds = l3d_sel[inliers_line], l2ds[inliers_line]
        assert campose is not None, "direct optimization needs a prior pose"
        q, t, _ = solve_jointloc(
            l3d_sel[:, 0], l3d_sel[:, 1], l2ds[:, 0], l2ds[:, 1], p3ds,
            p2ds, kvec, campose.qvec, campose.tvec, loc_cfg, device=device)
        return CameraPose(q, t), None

    n_pts, n_lines = len(p3ds), len(l2ds)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    kv, p3_d, p2_d = dev(kvec), dev(p3ds), dev(p2ds)
    l3s, l3e = dev(l3d_sel[:, 0]), dev(l3d_sel[:, 1])
    l2s, l2e = dev(l2ds[:, 0]), dev(l2ds[:, 1])
    params = ScoreParams.from_thresholds(
        ransac_cfg.thres_point, ransac_cfg.thres_line,
        ransac_cfg.weight_point, ransac_cfg.weight_line)

    with _stage(prof, "pnpl_sample_solve"):
        Rs, ts, ok = minimal_hypotheses(kv, p3_d, p2_d, l3d_sel, l2s, l2e,
                                        ransac_cfg.n_hypotheses, seed)

    with _stage(prof, "pnpl_score"):
        scores, pt_inl, ln_inl = pose_score(
            rotmat_to_quat(Rs).contiguous(), ts.contiguous(), kv, p3_d, p2_d,
            l3s, l3e, l2s, l2e, params)
        scores = torch.where(ok, scores, torch.full_like(scores, float("inf")))
        topk = min(max(ransac_cfg.lo_topk, 1), int(scores.shape[0]))
        # stable, NaN last, as jnp.argsort
        order = torch.argsort(scores, stable=True)[:topk].cpu().numpy()
        scores_h = scores.cpu().numpy()

    th_pt2, th_ln2 = ransac_cfg.thres_point ** 2, ransac_cfg.thres_line ** 2
    wp = ransac_cfg.weight_point * th_ln2 / (th_pt2 + th_ln2)
    wl = ransac_cfg.weight_line * th_pt2 / (th_pt2 + th_ln2)

    def pose_errors(qs, ts_):
        """Squared errors per correspondence [T, N] under T poses, each
        quaternion through a rotation matrix and back, as the scoring
        takes it."""
        qk = rotmat_to_quat(quat_to_rotmat(torch.as_tensor(
            np.asarray(qs, np.float32), device=device).reshape(-1, 4)))
        ept2, eln2 = pose_score(qk.contiguous(), dev(ts_).reshape(-1, 3), kv,
                                p3_d, p2_d, l3s, l3e, l2s, l2e, params,
                                errors=True)
        return (ept2.cpu().numpy().astype(np.float64),
                eln2.cpu().numpy().astype(np.float64))

    def msac_score(ept2, eln2):
        return float(wp * np.minimum(ept2, th_pt2).sum()
                     + wl * np.minimum(eln2, th_ln2).sum())

    def lsq_fit(starts, masks):
        """Joint refits, one row each, from the poses ``starts`` on the
        (point, line) inlier masks: [(pose, point errors, line errors)]."""
        q, t, _ = solve_jointloc_batch(
            l3s, l3e, l2s, l2e, p3_d, p2_d, kv,
            np.stack([p.qvec for p in starts]),
            np.stack([p.tvec for p in starts]), loc_cfg,
            line_masks=np.stack([m[1] for m in masks]),
            point_masks=np.stack([m[0] for m in masks]), device=device)
        e_pt2, e_ln2 = pose_errors(q.cpu().numpy(), t.cpu().numpy())
        q, t = q.cpu().numpy(), t.cpu().numpy()
        return [(CameraPose(q[k], t[k]), e_pt2[k], e_ln2[k])
                for k in range(len(starts))]

    # The LO of the top-k hypotheses: a refit on the relaxed inliers,
    # then from two random subsets of the base inliers an ungated
    # annealed least-squares chain; the best model is tracked at the base
    # thresholds.  The chains are independent, so each step of all of
    # them is one batched solve; the random subsets are drawn, and the
    # candidates considered, in the order of one chain after another.
    rounds = max(ransac_cfg.lo_rounds, 1)
    kmult = max(ransac_cfg.threshold_multiplier, 1.0)
    rng_np = np.random.default_rng(seed + 12345)
    best = {"pose": None, "score": np.inf, "pt": None, "ln": None}
    cands = []  # ((hypothesis rank, step), pose, point errors, line errors)

    def enough(pt, ln):
        return int(pt.sum() + ln.sum()) >= 3

    with _stage(prof, "pnpl_lo_polish"):
        hyps = [int(h) for h in order if np.isfinite(scores_h[h])]
        poses_h = [CameraPose(R=Rs[h].cpu().numpy(), tvec=ts[h].cpu().numpy())
                   for h in hyps]
        if hyps:
            e_pt2, e_ln2 = pose_errors(np.stack([p.qvec for p in poses_h]),
                                       np.stack([p.tvec for p in poses_h]))
            cands += [((k, 0), poses_h[k], e_pt2[k], e_ln2[k])
                      for k in range(len(hyps))]
        if hyps and ransac_cfg.final_least_squares:
            rel = [(k, (e_pt2[k] <= th_pt2 * kmult,
                        e_ln2[k] <= th_ln2 * kmult))
                   for k in range(len(hyps))]
            rel = [(k, m) for k, m in rel if enough(*m)]
            chains = []  # [hypothesis rank, restart, (pose, e_pt2, e_ln2)]
            fits = lsq_fit([poses_h[k] for k, _ in rel],
                           [m for _, m in rel]) if rel else []
            for (k, _), fit in zip(rel, fits):
                cands.append(((k, 1),) + fit)
                pt_base, ln_base = fit[1] <= th_pt2, fit[2] <= th_ln2
                n_base = int(pt_base.sum() + ln_base.sum())
                if n_base < 3:
                    continue
                n_sub = max(6, min(9, n_base // 2))
                for lo in range(2):
                    pt_sub, ln_sub = pt_base.copy(), ln_base.copy()
                    if n_base > n_sub:
                        idx = np.concatenate([np.flatnonzero(pt_sub),
                                              len(pt_sub)
                                              + np.flatnonzero(ln_sub)])
                        drop = rng_np.permutation(idx)[n_sub:]
                        pt_sub[drop[drop < len(pt_sub)]] = False
                        ln_sub[drop[drop >= len(pt_sub)]
                               - len(pt_sub)] = False
                    chains.append([k, lo, (pt_sub, ln_sub)])
            for step in range(rounds + 1):
                # step 0: the fit on the subset; then the annealed rounds
                if step:
                    f = kmult - (kmult - 1.0) * (step - 1) / max(rounds - 1,
                                                                1)
                    for c in chains:
                        c[2] = (c[3][1] <= th_pt2 * f, c[3][2] <= th_ln2 * f)
                # a chain with fewer than 3 inliers ends
                chains = [c for c in chains if enough(*c[2])]
                if not chains:
                    break
                starts = [c[3][0] if step else poses_h[c[0]] for c in chains]
                for c, fit in zip(chains, lsq_fit(starts,
                                                  [c[2] for c in chains])):
                    c[3:] = [fit]
                    cands.append(((c[0], 2 + c[1] * (rounds + 1) + step),)
                                 + fit)
        for _, pose_c, ept2, eln2 in sorted(cands, key=lambda c: c[0]):
            s = msac_score(ept2, eln2)
            if s < best["score"]:
                best.update(pose=pose_c, score=s, pt=ept2 <= th_pt2,
                            ln=eln2 <= th_ln2)

        if best["pose"] is None:  # every hypothesis invalid: the argmin
            h = int(torch.argmin(scores))
            best.update(pose=CameraPose(R=Rs[h].cpu().numpy(),
                                        tvec=ts[h].cpu().numpy()),
                        score=float(scores_h[h]), pt=pt_inl[h].cpu().numpy(),
                        ln=ln_inl[h].cpu().numpy())
        elif ransac_cfg.final_least_squares:
            # f64 polish on the winning inlier set
            for _ in range(2):
                Rp, tp = _polish_pose_f64(
                    best["pose"].R(), best["pose"].tvec, kvec, p3ds, p2ds,
                    best["pt"], l3d_sel, l2ds, best["ln"])
                e_pt2, e_ln2 = pose_errors(rotmat_to_quat(torch.as_tensor(
                    Rp, dtype=torch.float32)).numpy(), tp)
                s = msac_score(e_pt2[0], e_ln2[0])
                if s >= best["score"]:
                    break
                best.update(pose=CameraPose(R=Rp, tvec=tp), score=s,
                            pt=e_pt2[0] <= th_pt2, ln=e_ln2[0] <= th_ln2)

    n_inl = best["pt"].sum() + best["ln"].sum()
    stats = {
        "best_model_score": best["score"],  # MSAC score, lower is better
        "best_num_inliers": float(n_inl),
        "inlier_ratio": float(n_inl / max(n_pts + n_lines, 1)),
        "point_inliers": best["pt"],
        "line_inliers": best["ln"],
        "hypothesis_scores": scores_h,   # MSAC, inf where invalid
    }
    return best["pose"], stats
