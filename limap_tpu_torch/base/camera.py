"""Cameras, poses and batched camera views.

Host objects (:class:`Camera`, :class:`CameraPose`, :class:`CameraView`)
hold float64 numpy parameters, as in the reference.  A pose built from a
rotation matrix converts it through fp32 tensors on the CPU, the
precision the reference computes it in.  :class:`CameraViewsBatch` is the tensor
container the kernels take: ``kvec [..., 4] = (fx, fy, cx, cy)``,
``qvec [..., 4]``, ``tvec [..., 3]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.pose import (quat_conjugate, quat_normalize,
                                       quat_rotate, quat_to_rotmat,
                                       rotmat_to_quat)

EPS = 1e-12

# COLMAP camera models: id -> (name, num_params, focal idxs, pp idxs)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3, (0,), (1, 2)),
    1: ("PINHOLE", 4, (0, 1), (2, 3)),
    2: ("SIMPLE_RADIAL", 4, (0,), (1, 2)),
    3: ("RADIAL", 5, (0,), (1, 2)),
    4: ("OPENCV", 8, (0, 1), (2, 3)),
    5: ("OPENCV_FISHEYE", 8, (0, 1), (2, 3)),
    6: ("FULL_OPENCV", 12, (0, 1), (2, 3)),
    7: ("FOV", 5, (0, 1), (2, 3)),
    8: ("SIMPLE_RADIAL_FISHEYE", 4, (0,), (1, 2)),
    9: ("RADIAL_FISHEYE", 5, (0,), (1, 2)),
    10: ("THIN_PRISM_FISHEYE", 12, (0, 1), (2, 3)),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}
_UNDISTORTED_MODELS = (0, 1)


class Camera:
    """COLMAP model id + params + (h, w)."""

    def __init__(self, model=1, params=None, cam_id=-1, hw=(-1, -1), K=None):
        if isinstance(model, str):
            model = MODEL_NAME_TO_ID[model]
        self.model_id = int(model)
        self.camera_id = int(cam_id)
        self.height, self.width = int(hw[0]), int(hw[1])
        name, n_params, _, _ = CAMERA_MODELS[self.model_id]
        if K is not None:
            K = np.asarray(K, dtype=np.float64)
            fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
            if self.model_id == 0:
                params = [fx, cx, cy]
            elif self.model_id == 1:
                params = [fx, fy, cx, cy]
            else:
                raise ValueError(
                    f"K-only init supported for pinhole models, got {name}")
        if params is None:
            params = np.zeros(n_params)
        self.params = np.asarray(params, dtype=np.float64).copy()
        if len(self.params) != n_params:
            raise ValueError(f"model {name} expects {n_params} params, got "
                             f"{len(self.params)}")

    @property
    def model_name(self) -> str:
        return CAMERA_MODELS[self.model_id][0]

    def focal_idxs(self) -> Tuple[int, ...]:
        return CAMERA_MODELS[self.model_id][2]

    def pp_idxs(self) -> Tuple[int, ...]:
        return CAMERA_MODELS[self.model_id][3]

    def kvec(self) -> np.ndarray:
        """(fx, fy, cx, cy)."""
        fi, pi = self.focal_idxs(), self.pp_idxs()
        fx = self.params[fi[0]]
        fy = self.params[fi[1]] if len(fi) == 2 else fx
        return np.array([fx, fy, self.params[pi[0]], self.params[pi[1]]])

    def K(self) -> np.ndarray:
        fx, fy, cx, cy = self.kvec()
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    def K_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K())

    def uncertainty(self, depth: float, var2d: float = 5.0) -> float:
        """var2d * depth / the mean focal length."""
        f = float(np.mean([self.params[i] for i in self.focal_idxs()]))
        return var2d * depth / f

    def is_undistorted(self) -> bool:
        if self.model_id in _UNDISTORTED_MODELS:
            return True
        fi = set(self.focal_idxs()) | set(self.pp_idxs())
        extra = [p for i, p in enumerate(self.params) if i not in fi]
        return bool(np.all(np.abs(extra) < 1e-12))

    def h(self) -> int:
        return self.height

    def w(self) -> int:
        return self.width

    def resize(self, width: int, height: int) -> None:
        """Rescale the intrinsics to a new image size."""
        if self.width <= 0 or self.height <= 0:
            raise ValueError("camera has no size set")
        sx = width / self.width
        sy = height / self.height
        s = (sx + sy) / 2.0
        for i in self.focal_idxs():
            self.params[i] *= s
        pi = self.pp_idxs()
        self.params[pi[0]] *= sx
        self.params[pi[1]] *= sy
        self.width, self.height = int(width), int(height)

    def set_max_image_dim(self, val: int) -> None:
        """Downscale so that max(h, w) <= val."""
        if val <= 0:
            return
        mx = max(self.width, self.height)
        if mx <= val:
            return
        ratio = val / mx
        self.resize(int(round(self.width * ratio)),
                    int(round(self.height * ratio)))

    def as_dict(self) -> dict:
        return {
            "model_id": self.model_id,
            "params": np.asarray(self.params).tolist(),
            "cam_id": self.camera_id,
            "height": self.height,
            "width": self.width,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Camera":
        return cls(model=d.get("model_id", 1), params=d.get("params"),
                   cam_id=d.get("cam_id", -1),
                   hw=(d.get("height", -1), d.get("width", -1)))


class CameraPose:
    """World-to-camera qvec (w, x, y, z) + tvec."""

    def __init__(self, qvec=(1.0, 0, 0, 0), tvec=(0.0, 0, 0), R=None,
                 initialized=True):
        if R is not None:
            qvec = rotmat_to_quat(torch.as_tensor(
                np.asarray(R), dtype=torch.float32)).numpy()
        self.qvec = np.asarray(qvec, dtype=np.float64)
        self.qvec = self.qvec / (np.linalg.norm(self.qvec) + EPS)
        self.tvec = np.asarray(tvec, dtype=np.float64)
        self.initialized = bool(initialized)

    def R(self) -> np.ndarray:
        """Rotation matrix, through fp32 as the reference computes it."""
        return quat_to_rotmat(torch.as_tensor(
            self.qvec, dtype=torch.float32)).numpy()

    def T(self) -> np.ndarray:
        return self.tvec

    def center(self) -> np.ndarray:
        return -self.R().T @ self.tvec

    def projdepth(self, p3d) -> float:
        """Depth of a world point in this pose's camera frame."""
        return float((self.R() @ np.asarray(p3d) + self.tvec)[2])

    def as_dict(self) -> dict:
        return {"qvec": self.qvec.tolist(), "tvec": self.tvec.tolist(),
                "initialized": self.initialized}

    @classmethod
    def from_dict(cls, d: dict) -> "CameraPose":
        return cls(qvec=d["qvec"], tvec=d["tvec"],
                   initialized=d.get("initialized", True))


class CameraView:
    """Camera + pose + image name."""

    def __init__(self, cam: Optional[Camera] = None,
                 pose: Optional[CameraPose] = None,
                 image_name: str = "none"):
        self.cam = cam if cam is not None else Camera()
        self.pose = pose if pose is not None else CameraPose()
        self.image_name = image_name

    def h(self) -> int:
        return self.cam.h()

    def w(self) -> int:
        return self.cam.w()

    def K(self) -> np.ndarray:
        return self.cam.K()

    def K_inv(self) -> np.ndarray:
        return self.cam.K_inv()

    def R(self) -> np.ndarray:
        return self.pose.R()

    def T(self) -> np.ndarray:
        return self.pose.T()

    def matrix(self) -> np.ndarray:
        """The projection matrix K [R | t]."""
        return self.K() @ np.concatenate([self.R(), self.T()[:, None]], 1)

    def projection(self, p3d) -> np.ndarray:
        """Pixel of a world point."""
        p = self.K() @ (self.R() @ np.asarray(p3d) + self.T())
        return p[:2] / (p[2] + EPS)

    def ray_direction(self, p2d) -> np.ndarray:
        """Unit world direction of the ray through a pixel."""
        v = self.R().T @ self.K_inv() @ np.array([p2d[0], p2d[1], 1.0])
        return v / np.linalg.norm(v)

    def get_direction_from_vp(self, vp) -> np.ndarray:
        """Unit world direction of a vanishing point in this view's
        pixels: R^T K^-1 vp."""
        v = self.R().T @ self.K_inv() @ np.asarray(vp)
        return v / np.linalg.norm(v)

    def as_dict(self) -> dict:
        return {"camera": self.cam.as_dict(), "pose": self.pose.as_dict(),
                "image_name": self.image_name}

    @classmethod
    def from_dict(cls, d: dict) -> "CameraView":
        return cls(Camera.from_dict(d["camera"]),
                   CameraPose.from_dict(d["pose"]),
                   d.get("image_name", "none"))

    def read_image(self, set_gray: bool = False) -> np.ndarray:
        """The view's image at the camera's size: uint8 [H, W, 3] (BGR),
        or [H, W] with ``set_gray``.  A ``.npy`` file holds such an
        array and is read with numpy; any other format is decoded by
        OpenCV, which is imported here and only then."""
        if self.image_name.endswith(".npy"):
            img = np.load(self.image_name)
        else:
            img = _cv2(self.image_name).imread(self.image_name)
            if img is None:
                raise FileNotFoundError(self.image_name)
        if self.w() > 0 and self.h() > 0 \
                and (img.shape[1], img.shape[0]) != (self.w(), self.h()):
            img = _cv2(self.image_name).resize(img, (self.w(), self.h()))
        if set_gray and img.ndim == 3:
            # OpenCV's BGR -> gray weights, rounded to the nearest level
            img = np.rint(img.astype(np.float32)
                          @ np.float32([0.114, 0.587, 0.299])
                          ).astype(np.uint8)
        return img


def _cv2(image_name: str):
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"reading or resizing {image_name!r} needs OpenCV (cv2); "
            "without it, store images as .npy at the camera's size"
        ) from exc
    return cv2


class CameraViewsBatch(NamedTuple):
    """Batch of pinhole views: kvec [..., 4], qvec [..., 4], tvec [..., 3]."""

    kvec: torch.Tensor
    qvec: torch.Tensor
    tvec: torch.Tensor

    @classmethod
    def from_views(cls, views, device=None) -> "CameraViewsBatch":
        device = resolve_device(device)
        kv = np.stack([v.cam.kvec() for v in views]).astype(np.float32)
        qv = np.stack([v.pose.qvec for v in views]).astype(np.float32)
        tv = np.stack([v.pose.tvec for v in views]).astype(np.float32)
        return cls(*(torch.as_tensor(a, device=device) for a in (kv, qv, tv)))

    def select(self, idx) -> "CameraViewsBatch":
        if isinstance(idx, torch.Tensor):
            idx = idx.long()
        return CameraViewsBatch(self.kvec[idx], self.qvec[idx],
                                self.tvec[idx])

    def R(self) -> torch.Tensor:
        return quat_to_rotmat(self.qvec)

    def K(self) -> torch.Tensor:
        fx, fy, cx, cy = self.kvec.unbind(-1)
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        K = torch.stack([fx, z, cx, z, fy, cy, z, z, o], -1)
        return K.reshape(K.shape[:-1] + (3, 3))

    def center(self) -> torch.Tensor:
        """-R^T t, by the conjugate quaternion."""
        return quat_rotate(quat_normalize(quat_conjugate(self.qvec)),
                           -self.tvec)

    def projdepth(self, p3d: torch.Tensor) -> torch.Tensor:
        return (quat_rotate(self.qvec, p3d) + self.tvec)[..., 2]

    def project(self, p3d: torch.Tensor) -> torch.Tensor:
        """World point [..., 3] -> pixel [..., 2]."""
        pc = quat_rotate(self.qvec, p3d) + self.tvec
        u = pc[..., 0] / (pc[..., 2] + EPS)
        v = pc[..., 1] / (pc[..., 2] + EPS)
        x = self.kvec[..., 0] * u + self.kvec[..., 2]
        y = self.kvec[..., 1] * v + self.kvec[..., 3]
        return torch.stack([x, y], dim=-1)

    def ray_direction(self, p2d: torch.Tensor) -> torch.Tensor:
        """Unit world-space ray through pixel [..., 2]."""
        u = (p2d[..., 0] - self.kvec[..., 2]) / self.kvec[..., 0]
        v = (p2d[..., 1] - self.kvec[..., 3]) / self.kvec[..., 1]
        d_cam = torch.stack([u, v, torch.ones_like(u)], dim=-1)
        d = quat_rotate(quat_normalize(quat_conjugate(self.qvec)), d_cam)
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + EPS)

    def uncertainty(self, depth: torch.Tensor,
                    var2d: float = 5.0) -> torch.Tensor:
        f = 0.5 * (self.kvec[..., 0] + self.kvec[..., 1])
        return var2d * depth / f
