"""Undistortion through OpenCV, imported inside the calls.

Pinhole inputs pass through; radial and OpenCV models map to PINHOLE
with the same K after undistortion; fisheye models use OpenCV's fisheye
functions.
"""

from __future__ import annotations

import numpy as np

from limap_tpu_torch.base.camera import Camera


def _opencv_dist_coeffs(cam: Camera) -> np.ndarray:
    """Map COLMAP params to OpenCV distortion vector."""
    name = cam.model_name
    p = cam.params
    if name == "SIMPLE_RADIAL":
        return np.array([p[3], 0, 0, 0])
    if name == "RADIAL":
        return np.array([p[3], p[4], 0, 0])
    if name == "OPENCV":
        return np.array([p[4], p[5], p[6], p[7]])
    if name == "FULL_OPENCV":
        return np.array(p[4:12])
    if name in ("OPENCV_FISHEYE",):
        return np.array(p[4:8])
    if name in ("SIMPLE_RADIAL_FISHEYE",):
        return np.array([p[3], 0, 0, 0])
    if name in ("RADIAL_FISHEYE",):
        return np.array([p[3], p[4], 0, 0])
    raise NotImplementedError(f"undistortion for model {name}")


def _is_fisheye(cam: Camera) -> bool:
    return "FISHEYE" in cam.model_name


def undistort_camera(cam: Camera) -> Camera:
    """Return the PINHOLE camera after undistortion (same K)."""
    return Camera(model="PINHOLE", K=cam.K(), cam_id=cam.camera_id,
                  hw=(cam.h(), cam.w()))


def undistort_image_camera(cam: Camera, imname_in: str,
                           imname_out: str) -> Camera:
    """Undistort the image file; returns the new (pinhole) camera."""
    import cv2
    if cam.is_undistorted():
        img = cv2.imread(imname_in)
        if img is not None:
            cv2.imwrite(imname_out, img)
        return undistort_camera(cam)
    img = cv2.imread(imname_in)
    K = cam.K()
    dist = _opencv_dist_coeffs(cam)
    if _is_fisheye(cam):
        und = cv2.fisheye.undistortImage(img, K, dist[:4], Knew=K)
    else:
        und = cv2.undistort(img, K, dist)
    cv2.imwrite(imname_out, und)
    return undistort_camera(cam)


def undistort_points(points: np.ndarray, cam: Camera) -> np.ndarray:
    """Undistort 2D points [N, 2] into the pinhole frame."""
    import cv2
    if cam.is_undistorted():
        return np.asarray(points)
    K = cam.K()
    dist = _opencv_dist_coeffs(cam)
    pts = np.asarray(points, np.float64).reshape(-1, 1, 2)
    if _is_fisheye(cam):
        out = cv2.fisheye.undistortPoints(pts, K, dist[:4], P=K)
    else:
        out = cv2.undistortPoints(pts, K, dist, P=K)
    return out.reshape(-1, 2)
