"""COLMAP sparse model reader (text + binary) and a text writer, host
numpy against the documented COLMAP model formats (no pycolmap).

``ReadInfos`` turns a model into an :class:`ImageCollection`,
``ReadPointTracks`` into ``{point_id: {xyz, image_ids, point2D_idxs}}``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import (CameraImage,
                                                   ImageCollection)

# COLMAP model ids -> (name, num_params)
_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME2ID = {v[0]: k for k, v in _MODELS.items()}


# ---------------------------------------------------------------- text
def _read_cameras_txt(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cam_id = int(tok[0])
            model = tok[1]
            w, h = int(tok[2]), int(tok[3])
            params = [float(v) for v in tok[4:]]
            cams[cam_id] = Camera(model=model, params=params, cam_id=cam_id,
                                  hw=(h, w))
    return cams


def _read_images_txt(path: str):
    images: Dict[int, CameraImage] = {}
    points2d: Dict[int, np.ndarray] = {}
    # COLMAP's images.txt is two lines per image and the second
    # (POINTS2D) line may be EMPTY — keep blank lines so the pairing
    # stays aligned (only comments are dropped).
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.lstrip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        tok = lines[i].split()
        img_id = int(tok[0])
        qvec = [float(v) for v in tok[1:5]]
        tvec = [float(v) for v in tok[5:8]]
        cam_id = int(tok[8])
        name = tok[9] if len(tok) > 9 else "none"
        images[img_id] = CameraImage(cam_id, CameraPose(qvec, tvec), name)
        if i + 1 < len(lines):
            tok2 = lines[i + 1].split()
            arr = np.array([float(v) for v in tok2]).reshape(-1, 3)
            points2d[img_id] = arr  # x, y, point3D_id
    return images, points2d


def _read_points3d_txt(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            pid = int(tok[0])
            xyz = [float(v) for v in tok[1:4]]
            track = tok[8:]
            image_ids = [int(track[i]) for i in range(0, len(track), 2)]
            p2d_idxs = [int(track[i + 1]) for i in range(0, len(track), 2)]
            out[pid] = {"xyz": np.asarray(xyz), "image_ids": image_ids,
                        "point2D_idxs": p2d_idxs}
    return out


# --------------------------------------------------------------- binary
def _read_cameras_bin(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            n_params = _MODELS[model_id][1]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cams[cam_id] = Camera(model=model_id, params=list(params),
                                  cam_id=cam_id, hw=(h, w))
    return cams


def _read_images_bin(path: str):
    images: Dict[int, CameraImage] = {}
    points2d: Dict[int, np.ndarray] = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<I", f.read(4))[0]
            q = struct.unpack("<4d", f.read(32))
            t = struct.unpack("<3d", f.read(24))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_p2d = struct.unpack("<Q", f.read(8))[0]
            raw = f.read(24 * n_p2d)
            if n_p2d:
                rec = np.frombuffer(
                    raw, dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
                arr = np.stack([rec["x"], rec["y"],
                                rec["pid"].astype(np.float64)], axis=1)
            else:
                arr = np.zeros((0, 3))
            images[img_id] = CameraImage(cam_id, CameraPose(q, t),
                                         name.decode())
            points2d[img_id] = arr
    return images, points2d


def _read_points3d_bin(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = struct.unpack("<3d", f.read(24))
            f.read(3)  # rgb
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            track = struct.unpack(f"<{2 * track_len}i", f.read(8 * track_len))
            out[pid] = {
                "xyz": np.asarray(xyz),
                "image_ids": list(track[0::2]),
                "point2D_idxs": list(track[1::2]),
            }
    return out


# ----------------------------------------------------------------- API
def read_model(model_path: str):
    """Returns (cameras, images, points2d, points3d)."""
    if os.path.exists(os.path.join(model_path, "cameras.bin")):
        cams = _read_cameras_bin(os.path.join(model_path, "cameras.bin"))
        images, p2d = _read_images_bin(os.path.join(model_path, "images.bin"))
        p3d = _read_points3d_bin(os.path.join(model_path, "points3D.bin"))
    elif os.path.exists(os.path.join(model_path, "cameras.txt")):
        cams = _read_cameras_txt(os.path.join(model_path, "cameras.txt"))
        images, p2d = _read_images_txt(os.path.join(model_path, "images.txt"))
        p3d = _read_points3d_txt(os.path.join(model_path, "points3D.txt"))
    else:
        raise FileNotFoundError(f"no COLMAP model at {model_path}")
    return cams, images, p2d, p3d


def ReadInfos(model_path: str,
              image_path: str = "") -> ImageCollection:
    """COLMAP model -> ImageCollection, image names joined to
    ``image_path`` when given."""
    cams, images, _, _ = read_model(model_path)
    if image_path:
        for im in images.values():
            im.image_name = os.path.join(image_path, im.image_name)
    return ImageCollection(cams, images)


def ReadPointTracks(model_path: str) -> Dict[int, dict]:
    """COLMAP model -> {point_id: {xyz, image_ids, point2D_idxs}}."""
    _, _, _, p3d = read_model(model_path)
    return p3d


# --------------------------------------------------------------- writer
def write_model_txt(model_path: str, imagecols: ImageCollection,
                    points3d: Dict[int, dict] = None,
                    points2d: Dict[int, np.ndarray] = None) -> None:
    """COLMAP text model of the collection and of ``points3d`` (each
    point's 2D indices default to 0); ``points2d`` {img_id: (P, 3) x, y,
    point3D_id} fills the images' POINTS2D lines (empty without it)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cameras.txt"), "w") as f:
        for cam_id in imagecols.get_cam_ids():
            cam = imagecols.cam(cam_id)
            params = " ".join(str(v) for v in cam.params)
            f.write(f"{cam_id} {cam.model_name} {cam.w()} {cam.h()} "
                    f"{params}\n")
    with open(os.path.join(model_path, "images.txt"), "w") as f:
        for img_id in imagecols.get_img_ids():
            im = imagecols.camimage(img_id)
            q = " ".join(str(v) for v in im.pose.qvec)
            t = " ".join(str(v) for v in im.pose.tvec)
            obs = (points2d or {}).get(img_id)
            row = "" if obs is None else " ".join(
                f"{float(x)!r} {float(y)!r} {int(pid)}"
                for x, y, pid in np.asarray(obs))
            f.write(f"{img_id} {q} {t} {im.cam_id} {im.image_name}\n"
                    f"{row}\n")
    with open(os.path.join(model_path, "points3D.txt"), "w") as f:
        for pid, rec in (points3d or {}).items():
            xyz = " ".join(str(v) for v in rec["xyz"])
            track = " ".join(
                f"{i} {j}" for i, j in zip(rec["image_ids"],
                                           rec.get("point2D_idxs",
                                                   [0] * len(
                                                       rec["image_ids"]))))
            f.write(f"{pid} {xyz} 0 0 0 0.0 {track}\n")
