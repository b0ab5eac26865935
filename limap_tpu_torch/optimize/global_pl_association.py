"""Global point-line-VP association and joint structural refinement.

Point tracks, line tracks and VP tracks are coupled through soft
association residuals (point-line distance weighted by 2D co-occurrence
counts, line-VP sine) and refined by block-coordinate descent with fixed
cameras: each round solves every line (kernel L), then every point
(kernel M), each family a batch of small independent LM problems with
the other held fixed (``ops/lm_assoc.py``), then the VPs on the host in
float64 (their principal directions and a small Gauss-Newton over the
VP-pair orthogonality and collinearity terms).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.infinite_line import (InfiniteLines3d,
                                                MinimalInfiniteLines3d,
                                                minimal_to_plucker)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import TrackBatch
from limap_tpu_torch.ops import lm_assoc
from limap_tpu_torch.optimize.lm import LAMBDAS
from limap_tpu_torch.optimize import residuals as res
from limap_tpu_torch.optimize.line_ba import (pack_minimal_lines,
                                              unpack_minimal_lines)
from limap_tpu_torch.structures import PL_Bipartite3d, PointTrack
from limap_tpu_torch.util import dataclass_from_dict


@dataclasses.dataclass(frozen=True)
class GlobalAssociatorConfig:
    """The association's weights, thresholds and schedule."""

    lw_point: float = 0.1
    geometric_alpha: float = 10.0
    loss: str = "cauchy"
    loss_scale: float = 0.25
    # association
    lw_pointline_association: float = 10.0
    th_pixel: float = 2.0
    th_weight_pointline: float = 3.0
    lw_vpline_association: float = 1.0
    th_count_vpline: int = 3
    lw_vp_orthogonality: float = 1.0
    th_angle_orthogonality: float = 87.0
    lw_vp_collinearity: float = 0.0
    th_angle_collinearity: float = 1.0
    # hard association output
    th_hard_pl_dist3d: float = 2.0
    th_hard_vpline_angle3d: float = 5.0
    constant_vp: bool = False
    n_bcd_rounds: int = 3
    lm_iterations: int = 10
    # junction reassociation
    th_count_lineline: int = 3
    th_angle_lineline: float = 30.0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GlobalAssociatorConfig":
        return dataclass_from_dict(cls, d)


def construct_weights_pointline(all_bpt2ds, point_track_of_2d,
                                line_track_of_2d) -> Dict[Tuple[int, int],
                                                          float]:
    """Soft point-line association weights: the count of images where a
    point track's keypoint lies on a line track's 2D line, keyed
    (point track, line track) in first-seen order (images in
    ``all_bpt2ds`` order, then point ids, then neighbour lines).

    point_track_of_2d: {img_id: {point_id_2d: point_track_id}};
    line_track_of_2d: {img_id: {line_id_2d: line_track_id}}.
    """
    weights: Dict[Tuple[int, int], float] = {}
    for img_id, bpt in all_bpt2ds.items():
        pmap = point_track_of_2d.get(img_id, {})
        lmap = line_track_of_2d.get(img_id, {})
        for pid2d in bpt.get_point_ids():
            ptrack = pmap.get(pid2d, -1)
            if ptrack < 0:
                continue
            for lid2d in bpt.neighbor_lines(pid2d):
                ltrack = lmap.get(lid2d, -1)
                if ltrack < 0:
                    continue
                key = (ptrack, ltrack)
                weights[key] = weights.get(key, 0.0) + 1.0
    return weights


def _pad_assoc(pairs: Dict[Tuple[int, int], float], n_left: int,
               max_assoc: int, device=None):
    """(left, right) -> weight, in insertion order, to per-left padded
    [n_left, max_assoc] indices (int32) and weights: the first
    ``max_assoc`` of each left entity."""
    idx = np.zeros((n_left, max_assoc), np.int32)
    w = np.zeros((n_left, max_assoc), np.float32)
    fill = np.zeros(n_left, np.int32)
    for (li, ri), wt in pairs.items():
        if li < n_left and fill[li] < max_assoc:
            idx[li, fill[li]] = ri
            w[li, fill[li]] = wt
            fill[li] += 1
    device = resolve_device(device)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


class GlobalAssociator:
    """Block-coordinate descent over (lines, points, VPs) coupled by the
    association residuals; the lines and points on ``device``."""

    A = 8  # associations an entity

    def __init__(self, cfg: GlobalAssociatorConfig =
                 GlobalAssociatorConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pl_weights: Dict[Tuple[int, int], float] = {}
        self.vpl_weights: Dict[Tuple[int, int], float] = {}
        self.vp_dirs = np.zeros((0, 3))

    # ------------------------------------------------------------ init
    def init_imagecols(self, imagecols) -> None:
        self.imagecols = imagecols
        self.views = imagecols.batch(self.device)
        self.id2idx = imagecols.img_id_to_index()

    def init_line_tracks(self, batch: TrackBatch) -> None:
        self.line_batch = batch

    def init_point_tracks(self, point_tracks: List[PointTrack],
                          max_supports: int = 32) -> None:
        """Pack point tracks into padded arrays: the first
        ``max_supports`` observations of each."""
        P, S = len(point_tracks), max_supports
        xyz = np.zeros((P, 3), np.float32)
        img_index = np.zeros((P, S), np.int32)
        p2d = np.zeros((P, S, 2), np.float32)
        mask = np.zeros((P, S), bool)
        for pi, tr in enumerate(point_tracks):
            xyz[pi] = tr.p
            n = min(len(tr.image_id_list), S)
            for si in range(n):
                img_index[pi, si] = self.id2idx[tr.image_id_list[si]]
                p2d[pi, si] = tr.p2d_list[si]
                mask[pi, si] = True
        t = lambda a: torch.as_tensor(a, device=self.device)
        self.points = t(xyz)
        self.pt_img_index, self.pt_p2d, self.pt_mask = (t(img_index),
                                                       t(p2d), t(mask))

    def init_vp_tracks(self, vptracks) -> None:
        self.vp_dirs = np.stack([t.direction for t in vptracks]) \
            if vptracks else np.zeros((0, 3))

    def set_pointline_weights(self, weights: Dict[Tuple[int, int], float]):
        self.pl_weights = {k: v for k, v in weights.items()
                           if v >= self.cfg.th_weight_pointline}

    def set_vpline_weights(self, weights: Dict[Tuple[int, int], float]):
        """(vp_track_id, line_track_id) -> count."""
        self.vpl_weights = {k: v for k, v in weights.items()
                            if v >= self.cfg.th_count_vpline}

    # ----------------------------------------------------------- solve
    def terms(self) -> lm_assoc.AssocTerms:
        cfg = self.cfg
        return lm_assoc.AssocTerms(
            geometric_alpha=cfg.geometric_alpha, loss=cfg.loss,
            loss_scale=cfg.loss_scale, lw_point=cfg.lw_point,
            lw_pointline=cfg.lw_pointline_association,
            lw_vpline=cfg.lw_vpline_association,
            use_vps=len(self.vp_dirs) > 0)

    def solve(self):
        cfg, dev, A = self.cfg, self.device, self.A
        batch = self.line_batch
        T = batch.mask.shape[0]
        P = self.points.shape[0]
        V = len(self.vp_dirs)
        terms = self.terms()

        line_params = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(
            Segments(batch.line.start, batch.line.end))).contiguous()
        points = self.points
        vps = np.asarray(self.vp_dirs, np.float32)

        # association tables, in the weights' insertion order
        lp_pairs = {(l, p): w for (p, l), w in self.pl_weights.items()}
        line_pt_idx, line_pt_w = _pad_assoc(lp_pairs, T, A, dev)
        point_ln_idx, point_ln_w = _pad_assoc(dict(self.pl_weights), P, A,
                                              dev)
        lv_pairs = {(l, v): w for (v, l), w in self.vpl_weights.items()}
        line_vp_idx, line_vp_w = _pad_assoc(lv_pairs, T, A, dev)

        sup = self.views.select(batch.img_index)
        weights = res.compute_line_weights(batch.line2d) * batch.mask
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev).reshape(-1, 3)
        one_row = torch.zeros((1, 3), dtype=torch.float32, device=dev)

        for _ in range(cfg.n_bcd_rounds):
            # ---- lines ----
            ldata = lm_assoc.LineAssocData(
                sup.kvec, sup.qvec, sup.tvec, batch.line2d.start,
                batch.line2d.end, weights, line_pt_idx, line_pt_w,
                line_vp_idx, line_vp_w, points if P else one_row,
                f32(vps) if V else one_row)
            line_params = lm_assoc.solve_lines(
                line_params, ldata, terms, cfg.lm_iterations).params
            # ---- points ----
            if P:
                pdata = lm_assoc.PointAssocData(
                    self.views.kvec, self.views.qvec, self.views.tvec,
                    self.pt_img_index, self.pt_p2d, self.pt_mask,
                    point_ln_idx, point_ln_w, line_params)
                points = lm_assoc.solve_points(
                    points, pdata, terms, cfg.lm_iterations).params
            # ---- vps ----
            if V and not cfg.constant_vp:
                vps = self._solve_vps(vps, line_params, lv_pairs)

        self.line_params = line_params
        self.points_out = points
        self.vps_out = np.asarray(vps)
        return line_params, points, vps

    def _solve_vps(self, vps, line_params, lv_pairs):
        """The VPs in two stages, on the host in float64:

        1. each VP the weighted principal direction of its associated
           lines (signs aligned to the current VP);
        2. a few joint damped steps over all VPs, the vp-line sines
           with the VP-pair terms: |cosine| of near-orthogonal pairs
           (weight 1e2 lw_vp_orthogonality) and sine of near-collinear
           pairs (1e2 lw_vp_collinearity), the pairs taken from the
           current estimates at the configured angles, directions
           re-normalized after every step.
        """
        cfg = self.cfg
        V = vps.shape[0]
        line = unpack_minimal_lines(line_params)
        d, _ = minimal_to_plucker(line.uvec, line.wvec)
        d_np = d.cpu().numpy()
        vps_np = np.array(vps)
        for v in range(V):
            members = [l for (l, vv) in lv_pairs if vv == v]
            if not members:
                continue
            ws = np.asarray([lv_pairs[(l, v)] for l in members])
            dirs = d_np[members]
            dirs = dirs * np.sign(dirs @ vps_np[v])[:, None]
            new = (dirs * ws[:, None]).sum(0)
            n = np.linalg.norm(new)
            if n > 1e-9:
                vps_np[v] = new / n
        pairs_orth, pairs_coll = self._vp_pairs(vps_np)
        if (len(pairs_orth) and cfg.lw_vp_orthogonality > 0) or \
                (len(pairs_coll) and cfg.lw_vp_collinearity > 0):
            vps_np = self._vp_pair_refine(vps_np, d_np, lv_pairs,
                                          pairs_orth, pairs_coll)
        return vps_np

    def _vp_pairs(self, vps_np):
        """The near-orthogonal and near-collinear VP pairs (i < j)."""
        cfg = self.cfg
        V = len(vps_np)
        orth, coll = [], []
        for i in range(V):
            for j in range(i + 1, V):
                c = abs(float(np.dot(vps_np[i], vps_np[j])))
                ang = np.degrees(np.arccos(min(c, 1.0)))
                if ang >= cfg.th_angle_orthogonality:
                    orth.append((i, j))
                if ang <= cfg.th_angle_collinearity:
                    coll.append((i, j))
        return orth, coll

    def _vp_pair_refine(self, vps_np, d_np, lv_pairs, pairs_orth,
                        pairs_coll, n_steps: int = 5):
        """A few Levenberg-Marquardt steps over the stacked VP directions
        (the damping schedule of ``optimize/lm.py``), with a
        forward-difference Jacobian, each step renormalized and taken only
        where it lowers the cost."""
        cfg = self.cfg
        V = len(vps_np)
        members = [[l for (l, vv) in lv_pairs if vv == v]
                   for v in range(V)]
        mem_w = [np.asarray([lv_pairs[(l, v)] for l in ms])
                 for v, ms in enumerate(members)]
        po = np.asarray(pairs_orth, np.int64).reshape(-1, 2)
        pc = np.asarray(pairs_coll, np.int64).reshape(-1, 2)
        w_orth = 10.0 * np.sqrt(max(cfg.lw_vp_orthogonality, 0.0))
        w_coll = 10.0 * np.sqrt(max(cfg.lw_vp_collinearity, 0.0))

        def residuals(x):
            out = []
            for v in range(V):
                if len(members[v]) == 0:
                    continue
                dirs = d_np[members[v]]
                cr = np.cross(np.broadcast_to(x[v], dirs.shape), dirs)
                out.append(np.linalg.norm(cr, axis=-1) * np.sqrt(
                    cfg.lw_vpline_association * mem_w[v]))
            if len(po):
                out.append(w_orth * np.abs(
                    np.sum(x[po[:, 0]] * x[po[:, 1]], axis=-1)))
            if len(pc):
                cr = np.cross(x[pc[:, 0]], x[pc[:, 1]])
                out.append(w_coll * np.linalg.norm(cr, axis=-1))
            return np.concatenate(out) if out else np.zeros(0)

        x = vps_np.astype(np.float64).copy()
        r0 = residuals(x)
        cost = float(r0 @ r0)
        lam, up, down, lo, hi = LAMBDAS
        for _ in range(n_steps if len(r0) else 0):
            J = np.zeros((len(r0), V * 3))
            eps = 1e-6
            for k in range(V * 3):
                xp = x.copy().reshape(-1)
                xp[k] += eps
                J[:, k] = (residuals(xp.reshape(V, 3)) - r0) / eps
            A = J.T @ J
            A = A + np.diag(lam * np.maximum(np.diag(A), 1e-8))
            new = x - np.linalg.solve(A, J.T @ r0).reshape(V, 3)
            new = new / np.linalg.norm(new, axis=-1, keepdims=True)
            r_new = residuals(new)
            # a step is taken only where it lowers the cost (the JAX
            # package takes every undamped step; ROADMAP.md section 3)
            if float(r_new @ r_new) < cost:
                x, r0, cost = new, r_new, float(r_new @ r_new)
                lam = max(lam * down, lo)
            else:
                lam = min(lam * up, hi)
        return x.astype(np.float32)

    # ----------------------------------------- junction reassociation
    def reassociate_junctions(self, all_bpt2ds, line_track_of_2d,
                              linetracks):
        """3D junction point tracks where at least ``th_count_lineline``
        2D junctions connect the same pair of sufficiently non-parallel
        line tracks, each associated with both tracks.

        all_bpt2ds: {img_id: PL_Bipartite2d}; line_track_of_2d:
        {img_id: {line2d_id: track_id}}; linetracks: the LineTracks (their
        3D lines place the junction).  Returns (new_point_tracks,
        new_pl_weights): the caller appends the tracks and merges the
        weights before solve().
        """
        cfg = self.cfg
        counter: Dict[Tuple[int, int], list] = {}
        for img_id, bpt in all_bpt2ds.items():
            lmap = line_track_of_2d.get(img_id, {})
            for p2d_id in bpt.get_point_ids():
                if bpt.pdegree(p2d_id) <= 1:
                    continue
                l2d_ids = [lid for lid in bpt.neighbor_lines(p2d_id)
                           if lmap.get(lid, -1) >= 0]
                for i in range(len(l2d_ids) - 1):
                    t1 = lmap[l2d_ids[i]]
                    seg1 = np.asarray(bpt.line(l2d_ids[i]), np.float64)
                    d1 = seg1[2:4] - seg1[:2]
                    d1 = d1 / (np.linalg.norm(d1) + 1e-12)
                    for j in range(i + 1, len(l2d_ids)):
                        t2 = lmap[l2d_ids[j]]
                        if t1 == t2:
                            continue
                        seg2 = np.asarray(bpt.line(l2d_ids[j]), np.float64)
                        d2 = seg2[2:4] - seg2[:2]
                        d2 = d2 / (np.linalg.norm(d2) + 1e-12)
                        cos2d = min(abs(float(d1 @ d2)), 1.0)
                        if np.degrees(np.arccos(cos2d)) \
                                < cfg.th_angle_lineline:
                            continue
                        key = (min(t1, t2), max(t1, t2))
                        counter.setdefault(key, []).append((img_id, p2d_id))

        new_tracks = []
        new_weights: Dict[Tuple[int, int], float] = {}
        base_pid = self.points.shape[0]
        for (t1, t2), obs in counter.items():
            if len(obs) < cfg.th_count_lineline:
                continue
            line1 = np.asarray(linetracks[t1].line, np.float64)
            line2 = np.asarray(linetracks[t2].line, np.float64)
            d1 = line1[1] - line1[0]
            d1 = d1 / (np.linalg.norm(d1) + 1e-12)
            d2 = line2[1] - line2[0]
            d2 = d2 / (np.linalg.norm(d2) + 1e-12)
            ip = float(d1 @ d2)
            if np.degrees(np.arccos(min(abs(ip), 1.0))) \
                    < cfg.th_angle_lineline:
                continue
            # the midpoint of the two infinite lines' closest approach
            A = np.array([[1.0, -ip], [-ip, 1.0]])
            b = np.array([float(d1 @ (line2[0] - line1[0])),
                          float(d2 @ (line1[0] - line2[0]))])
            st = np.linalg.solve(A, b)
            point = 0.5 * (line1[0] + st[0] * d1 + line2[0] + st[1] * d2)
            pid = base_pid + len(new_tracks)
            new_tracks.append(PointTrack(
                point, [o[0] for o in obs], [o[1] for o in obs],
                [np.asarray(all_bpt2ds[i].point(p).p) for (i, p) in obs]))
            for (i, p) in obs:
                all_bpt2ds[i].point(p).point3D_id = pid
            new_weights[(pid, t1)] = float(len(obs))
            new_weights[(pid, t2)] = float(len(obs))
        return new_tracks, new_weights

    # ----------------------------------------------------------- output
    def get_output_lines(self, num_outliers: int = 2) -> TrackBatch:
        from limap_tpu_torch.optimize.line_ba import get_output_tracks
        return get_output_tracks(self.line_batch, self.views,
                                 unpack_minimal_lines(self.line_params),
                                 num_outliers)

    def get_output_vps(self) -> np.ndarray:
        return self.vps_out

    def get_bipartite3d_pointline(self) -> PL_Bipartite3d:
        """Hard point-line association: an associated pair whose 3D
        point-line distance is within ``th_hard_pl_dist3d``."""
        from limap_tpu_torch.base.linetrack import batch_to_tracks
        bpt = PL_Bipartite3d()
        batch = self.get_output_lines()
        tracks = batch_to_tracks(batch)
        for li, tr in enumerate(tracks):
            bpt.add_line(tr, li)
        inf = InfiniteLines3d.from_segments(Segments(
            batch.line.start[:len(tracks)], batch.line.end[:len(tracks)]))
        pts = self.points_out
        d = inf.point_distance(pts[:, None, :]).cpu().numpy()  # [P, L]
        pts_np = pts.cpu().numpy()
        for pi in range(len(pts_np)):
            neighbors = [int(li) for li in np.nonzero(
                d[pi] <= self.cfg.th_hard_pl_dist3d)[0]
                if (pi, li) in self.pl_weights]
            bpt.add_point(PointTrack(pts_np[pi]), pi, neighbors)
        return bpt
