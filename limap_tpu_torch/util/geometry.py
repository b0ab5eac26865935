"""Small geometry helpers on numpy arrays: homogeneous coordinates,
quaternions, the skew matrix, epipolar lines and pose interpolation."""

from __future__ import annotations

import numpy as np
import torch


def to_homogeneous(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    return np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)


def to_cartesian(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    return arr[..., :-1] / (arr[..., -1:] + 1e-12)


def rotation_from_quaternion(q) -> np.ndarray:
    """The rotation matrix of a (w, x, y, z) quaternion, in float32 as
    the camera poses compute it."""
    from limap_tpu_torch.base.pose import quat_to_rotmat
    return quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def quaternion_from_rotation(R) -> np.ndarray:
    from limap_tpu_torch.base.pose import rotmat_to_quat
    return rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def skew_symmetric(v) -> np.ndarray:
    v = np.asarray(v)
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]])


def compute_epipolar_line(F: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Epipolar line coords in the target image for pixel p."""
    line = np.asarray(F) @ to_homogeneous(np.asarray(p))
    return line / (np.linalg.norm(line[:2]) + 1e-12)


def interpolate_pose(pose1, pose2, alpha: float):
    """Slerp + lerp between two CameraPoses (0 -> pose1, 1 -> pose2)."""
    from limap_tpu_torch.base.camera import CameraPose
    q1 = np.asarray(pose1.qvec)
    q2 = np.asarray(pose2.qvec)
    if q1 @ q2 < 0:
        q2 = -q2
    cos = np.clip(q1 @ q2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-8:
        q = (1 - alpha) * q1 + alpha * q2
    else:
        q = (np.sin((1 - alpha) * theta) * q1
             + np.sin(alpha * theta) * q2) / np.sin(theta)
    t = (1 - alpha) * pose1.tvec + alpha * pose2.tvec
    return CameraPose(q / np.linalg.norm(q), t)
