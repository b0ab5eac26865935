"""Hybrid point-line visual localization.

Per query: 2D line detection, 2D-2D line matching against the retrieved
database images (all-pairs epipolar IoU, or the endpoint-descriptor
matcher), lifting to 2D-3D through the map's line-to-track inverse map,
a reprojection filter down to one track a query line, then
:func:`pl_estimate_absolute_pose` with the query's point matches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import limap_tpu_torch.runners.functions as runners
from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraPose, CameraViewsBatch
from limap_tpu_torch.base.functions import get_invert_idmap_from_linetracks
from limap_tpu_torch.estimators import pl_estimate_absolute_pose
from limap_tpu_torch.ops.epipolar_iou import (epipolar_iou_grid,
                                              row_epipolar_lines)
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.profiler import StageProfiler

EPS = 1e-12


def _view(camera, pose, device) -> CameraViewsBatch:
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return CameraViewsBatch(t(camera.kvec()), t(pose.qvec), t(pose.tvec))


def match_line_2to2_epipolar_iou(ref_segs, tgt_segs, ref_cam, ref_pose,
                                 tgt_cam, tgt_pose,
                                 iou_threshold: float = 0.2,
                                 device=None) -> np.ndarray:
    """All-pairs epipolar IoU matching: the (ref, tgt) index pairs [M, 2]
    whose IoU exceeds ``iou_threshold``, in row-major order."""
    device = resolve_device(device)
    nr, nt = len(ref_segs), len(tgt_segs)
    if nr == 0 or nt == 0:
        return np.zeros((0, 2), np.int64)
    ref = torch.as_tensor(np.asarray(ref_segs, np.float32)[:, :4],
                          device=device)
    tgt = torch.as_tensor(np.asarray(tgt_segs, np.float32)[:, :4],
                          device=device).contiguous()
    ep_s, ep_e = row_epipolar_lines(ref, _view(ref_cam, ref_pose, device),
                                    _view(tgt_cam, tgt_pose, device))
    iou = epipolar_iou_grid(tgt, ep_s, ep_e)
    return torch.nonzero(iou > iou_threshold).cpu().numpy()


def match_line_2to3(pairs_2to2: np.ndarray, line2track: Dict[int, np.ndarray],
                    tgt_img_id: int) -> List[Tuple[int, int]]:
    """Lift 2D-2D matches to (ref line id, track id)."""
    track_ids = line2track[tgt_img_id]
    out = []
    for ref_line_id, tgt_line_id in np.asarray(pairs_2to2).reshape(-1, 2):
        tid = int(track_ids[int(tgt_line_id)])
        if tid != -1:
            out.append((int(ref_line_id), tid))
    return out


def _projection(camview, R: np.ndarray, p3d) -> np.ndarray:
    p = camview.cam.K() @ (R @ np.asarray(p3d) + camview.pose.tvec)
    return p[:2] / (p[2] + EPS)


def reprojection_filter_matches_2to3(
        ref_segs: np.ndarray, ref_camview,
        all_pairs_2to3: Dict[int, List[int]], linetracks,
        dist_thres: float = 10.0, sine_thres: float = 0.4,
        angle_scale: float = 1.0) -> List[Tuple[int, int]]:
    """The best track per query line by reprojection: midpoint distance
    plus the angle loss, within the distance and sine thresholds."""
    R = ref_camview.pose.R()
    matches = []
    for ref_line_id, track_ids in all_pairs_2to3.items():
        seg = np.asarray(ref_segs[ref_line_id], np.float64)
        mp_ref = 0.5 * (seg[:2] + seg[2:4])
        dir_ref = seg[2:4] - seg[:2]
        dir_ref = dir_ref / (np.linalg.norm(dir_ref) + 1e-12)
        best_id, min_loss = None, np.inf
        for tid in np.unique(track_ids):
            l3d = linetracks[tid].line
            p1 = _projection(ref_camview, R, l3d[0])
            p2 = _projection(ref_camview, R, l3d[1])
            mp = 0.5 * (p1 + p2)
            d2d = p2 - p1
            length = np.linalg.norm(d2d)
            if length < 1e-9:
                continue
            d2d = d2d / length
            dist = np.linalg.norm(mp_ref - mp)
            cos = np.clip(abs(dir_ref @ d2d), 0, 1.0)
            sine = np.sqrt(1.0 - cos * cos)
            if sine > sine_thres or dist > dist_thres:
                continue
            loss = dist + angle_scale * length * sine
            if loss < min_loss:
                min_loss, best_id = loss, int(tid)
        if best_id is not None:
            matches.append((ref_line_id, best_id))
    return matches


def _point3d_xyz(ref_sfm, pid):
    """xyz of a 3D point from a pycolmap-style Reconstruction or a plain
    {id: xyz} mapping."""
    pts = getattr(ref_sfm, "points3D", ref_sfm)
    p = pts[pid]
    return np.asarray(getattr(p, "xyz", p), np.float64)


def get_hloc_keypoints_from_log(logs, query_img_name, ref_sfm=None,
                                resize_scales=None):
    """2D-3D point matches of a query from an hloc localization log:
    ``logs["loc"][name]`` holds ``keypoints_query`` and either
    ``3d_points`` (InLoc-style, when ``ref_sfm`` is None) or
    ``points3D_ids`` resolved against ``ref_sfm``.  Returns (p2ds [N, 2],
    p3ds [N, 3], inlier mask)."""
    entry = logs["loc"][query_img_name]
    p2ds = np.asarray(entry["keypoints_query"], np.float64)
    if ref_sfm is None:
        p3ds = np.asarray(entry["3d_points"], np.float64)
    else:
        p3ds = np.asarray([_point3d_xyz(ref_sfm, j)
                           for j in entry["points3D_ids"]], np.float64)
    inliers = np.asarray(entry["PnP_ret"]["inlier_mask"])
    if resize_scales is not None and query_img_name in resize_scales:
        scale = resize_scales[query_img_name]
        p2ds = (p2ds + 0.5) * scale - 0.5
    return p2ds, p3ds, inliers


def hybrid_localization(cfg: dict, imagecols_db, imagecols_query,
                        point_corresp: Dict[int, Tuple[np.ndarray,
                                                       np.ndarray]],
                        linemap_db, retrieval: Dict[int, List[int]],
                        results_path: Optional[str] = None,
                        device=None, prof: Optional[StageProfiler] = None,
                        stats: Optional[dict] = None
                        ) -> Dict[int, CameraPose]:
    """Localize every query image with points and lines.

    Args:
      cfg: localization config (``default_localization_config()``).
      imagecols_db / imagecols_query: database / query collections (the
        query poses serve only as priors for the epipolar matching).
      point_corresp: {query img_id: (p3ds [N, 3], p2ds [N, 2])}.
      linemap_db: the database map's LineTracks.
      retrieval: {query img_id: [db img_id, ...]}.
      results_path: optional text output (name qw qx qy qz tx ty tz).
      device: where the device work runs (``None``: cuda).
      prof: a StageProfiler that times detect, match_2d2d,
        reprojection_filter and the PnPL stages.
      stats: a dict that receives, per query, the line matches and the
        RANSAC statistics.
    """
    device = resolve_device(device)
    prof = prof or StageProfiler(device=device)
    cfg = runners.setup(cfg)
    loc_cfg = cfg.get("localization", {})

    with prof.stage("detect"):
        all_db_segs, _ = runners.compute_2d_segs(
            cfg, imagecols_db, compute_descinfo=False, device=device)
        all_query_segs, _ = runners.compute_2d_segs(
            cfg, imagecols_query, compute_descinfo=False, device=device)
    line2track = get_invert_idmap_from_linetracks(all_db_segs, linemap_db)

    ep = loc_cfg.get("epipolar_filter")
    iou_th = ep.get("IoU_threshold", 0.2) if isinstance(ep, dict) \
        else loc_cfg.get("IoU_threshold", 0.2)

    # the optional descriptor matcher instead of the epipolar IoU
    matcher_name = loc_cfg.get("2d_matcher", "epipolar")
    matcher = None
    db_descinfos, query_descinfos = {}, {}
    if matcher_name != "epipolar":
        from limap_tpu_torch.line2d import get_extractor, get_matcher
        default_extractor = ("superpoint_endpoints"
                             if matcher_name == "superglue_endpoints"
                             else "patch_endpoints")
        extractor = get_extractor(
            loc_cfg.get("extractor", {"method": default_extractor}),
            weight_path=cfg.get("weight_path"), device=device)
        matcher = get_matcher(
            {"method": matcher_name, **loc_cfg.get("matcher_options", {})},
            extractor, weight_path=cfg.get("weight_path"), device=device)
        with prof.stage("describe"):
            for ic, segs_map, out in (
                    (imagecols_db, all_db_segs, db_descinfos),
                    (imagecols_query, all_query_segs, query_descinfos)):
                for img_id in ic.get_img_ids():
                    out[img_id] = extractor.extract(ic.camview(img_id),
                                                    segs_map[img_id])

    l3ds = np.asarray([t.line for t in linemap_db]).reshape(-1, 2, 3)
    poses = {}
    for q_id in imagecols_query.get_img_ids():
        q_view = imagecols_query.camview(q_id)
        q_segs = all_query_segs[q_id]

        with prof.stage("match_2d2d"):
            pairs_2to3: Dict[int, List[int]] = {}
            for db_id in retrieval.get(q_id, []):
                db_segs = all_db_segs.get(db_id)
                if db_segs is None or len(db_segs) == 0 or len(q_segs) == 0:
                    continue
                if matcher is not None:
                    p22 = np.asarray(matcher.match_pair(
                        query_descinfos[q_id],
                        db_descinfos[db_id])).reshape(-1, 2)
                else:
                    db_view = imagecols_db.camview(db_id)
                    p22 = match_line_2to2_epipolar_iou(
                        q_segs, db_segs, q_view.cam, q_view.pose,
                        db_view.cam, db_view.pose, iou_th, device=device)
                for rid, tid in match_line_2to3(p22, line2track, db_id):
                    pairs_2to3.setdefault(rid, []).append(tid)

        with prof.stage("reprojection_filter"):
            matches = reprojection_filter_matches_2to3(
                q_segs, q_view, pairs_2to3, linemap_db,
                dist_thres=loc_cfg.get("reprojection_filter_dist", 10.0))
        l3d_ids = [tid for (_, tid) in matches]
        l2ds = np.asarray([np.asarray(q_segs[rid][:4]).reshape(2, 2)
                           for (rid, _) in matches]).reshape(-1, 2, 2)

        p3ds, p2ds = point_corresp.get(q_id, (np.zeros((0, 3)),
                                              np.zeros((0, 2))))
        pose, ransac_stats = pl_estimate_absolute_pose(
            cfg.get("estimation", cfg), l3ds, l3d_ids, l2ds, p3ds, p2ds,
            q_view.cam,
            campose=q_view.pose if q_view.pose.initialized else None,
            device=device, prof=prof)
        poses[q_id] = pose
        if stats is not None:
            stats[q_id] = {"n_line_matches": len(matches),
                           "ransac": ransac_stats}

    if results_path is not None:
        limapio.check_directory(results_path)
        with open(results_path, "w") as f:
            for q_id, pose in poses.items():
                name = imagecols_query.image_name(q_id)
                q, t = pose.qvec, pose.tvec
                f.write(f"{name} {q[0]} {q[1]} {q[2]} {q[3]} "
                        f"{t[0]} {t[1]} {t[2]}\n")
    return poses
