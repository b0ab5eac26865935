"""Pose error metrics."""

from __future__ import annotations

import numpy as np


def compute_rot_err(R1: np.ndarray, R2: np.ndarray) -> float:
    """Geodesic rotation error in degrees."""
    R_err = R1[:3, :3].T @ R2[:3, :3]
    cos = (np.trace(R_err) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def compute_pose_err(pose, pose_gt):
    """(distance between the camera centres, rotation error in degrees)."""
    trans_err = float(np.linalg.norm(pose.center() - pose_gt.center()))
    return trans_err, compute_rot_err(pose.R(), pose_gt.R())


def eval_imagecols(imagecols, imagecols_gt):
    """Per-image pose errors over the shared image ids (no alignment)."""
    shared = sorted(set(imagecols.get_img_ids())
                    & set(imagecols_gt.get_img_ids()))
    trans_errs, rot_errs = [], []
    for img_id in shared:
        te, re = compute_pose_err(imagecols.campose(img_id),
                                  imagecols_gt.campose(img_id))
        trans_errs.append(te)
        rot_errs.append(re)
    return trans_errs, rot_errs
