"""Bundler and VisualSfM model readers: (ImageCollection, points3d)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

import torch

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import (CameraImage,
                                                   ImageCollection)
from limap_tpu_torch.base.pose import quat_to_rotmat


def ReadModelBundler(bundler_path: str, list_path: str = "bundle.list.txt",
                     model_path: str = "bundle.out"):
    """Read a Bundler reconstruction -> (ImageCollection, points3d).

    Bundler convention: camera looks down -z; converted to the COLMAP
    convention (z forward) by negating the 2nd/3rd rows of R and t.
    """
    list_file = os.path.join(bundler_path, list_path)
    with open(list_file) as f:
        image_names = [ln.split()[0] for ln in f if ln.strip()]

    with open(os.path.join(bundler_path, model_path)) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    n_images, n_points = (int(v) for v in lines[0].split())

    cameras: Dict[int, Camera] = {}
    images: Dict[int, CameraImage] = {}
    row = 1
    flip = np.diag([1.0, -1.0, -1.0])
    for i in range(n_images):
        focal, k1, k2 = (float(v) for v in lines[row].split())
        R = np.array([[float(v) for v in lines[row + 1 + r].split()]
                      for r in range(3)])
        t = np.array([float(v) for v in lines[row + 4].split()])
        row += 5
        if focal <= 0:
            continue
        name = image_names[i] if i < len(image_names) else f"image{i}"
        # principal point unknown in bundler: needs the image size; use
        # SIMPLE_RADIAL with cx=cy=0 placeholder updated by callers
        cam = Camera(model="SIMPLE_RADIAL", params=[focal, 0.0, 0.0, k1],
                     cam_id=i)
        cameras[i] = cam
        images[i] = CameraImage(i, CameraPose(R=flip @ R, tvec=flip @ t),
                                os.path.join(bundler_path, name))

    points3d = {}
    for p in range(n_points):
        xyz = np.array([float(v) for v in lines[row].split()])
        track = lines[row + 2].split()
        row += 3
        n_views = int(track[0])
        image_ids = [int(track[1 + 4 * k]) for k in range(n_views)]
        points3d[p] = {"xyz": xyz, "image_ids": image_ids}
    return ImageCollection(cameras, images), points3d


def ReadModelVisualSfM(vsfm_path: str, nvm_file: str = "reconstruction.nvm"):
    """Read a VisualSfM NVM file -> (ImageCollection, points3d)."""
    with open(os.path.join(vsfm_path, nvm_file)) as f:
        content = [ln.strip() for ln in f]
    row = 0
    while not content[row].startswith("NVM"):
        row += 1
    row += 1
    while not content[row]:
        row += 1
    n_images = int(content[row])
    row += 1

    cameras: Dict[int, Camera] = {}
    images: Dict[int, CameraImage] = {}
    for i in range(n_images):
        tok = content[row].split()
        row += 1
        name = tok[0]
        focal = float(tok[1])
        q = np.array([float(v) for v in tok[2:6]])  # w x y z
        C = np.array([float(v) for v in tok[6:9]])
        k1 = float(tok[9])
        R = quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()
        t = -R @ C
        cameras[i] = Camera(model="SIMPLE_RADIAL",
                            params=[focal, 0.0, 0.0, -k1], cam_id=i)
        images[i] = CameraImage(i, CameraPose(q, t),
                                os.path.join(vsfm_path, name))

    while not content[row]:
        row += 1
    n_points = int(content[row])
    row += 1
    points3d = {}
    for p in range(n_points):
        tok = content[row].split()
        row += 1
        xyz = np.array([float(v) for v in tok[:3]])
        n_meas = int(tok[6])
        image_ids = [int(tok[7 + 4 * k]) for k in range(n_meas)]
        points3d[p] = {"xyz": xyz, "image_ids": image_ids}
    return ImageCollection(cameras, images), points3d


def fill_principal_points(imagecols) -> None:
    """Bundler and NVM files hold no principal point (the readers leave
    cx = cy = 0): put each such camera's at the centre of its first
    image, and its size, read from that image (``.npy`` by its header)."""
    first = {}
    for img_id in imagecols.get_img_ids():
        first.setdefault(imagecols.images[img_id].cam_id, img_id)
    for cam_id, img_id in first.items():
        cam = imagecols.cameras[cam_id]
        if cam.params[1] != 0.0 or cam.params[2] != 0.0:
            continue
        name = imagecols.image_name(img_id)
        if name.endswith(".npy"):
            h, w = np.load(name, mmap_mode="r").shape[:2]
        else:
            h, w = imagecols.read_image(img_id).shape[:2]
        params = list(cam.params)
        params[1], params[2] = w / 2.0, h / 2.0
        imagecols.cameras[cam_id] = Camera(model=cam.model_name,
                                           params=params, cam_id=cam_id,
                                           hw=(h, w))
