"""Hypersim dataset loader.

Reads the public Hypersim layout: per-scene `_detail/` camera keyframes
(HDF5), `images/scene_cam_XX_final_preview/frame.YYYY.color.jpg`, and
`geometry_hdf5` ray-depth maps which are converted to plane depth.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.depth_reader_base import BaseDepthReader
from limap_tpu_torch.base.image_collection import (CameraImage,
                                                   ImageCollection)


def raydepth2depth(raydepth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Euclidean ray depth -> plane (z) depth."""
    K_inv = np.linalg.inv(K)
    h, w = raydepth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    homo = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    coeffs = np.linalg.norm(K_inv @ homo, axis=0).reshape(h, w)
    return raydepth / coeffs


class HypersimDepthReader(BaseDepthReader):
    def __init__(self, filename: str, K: np.ndarray, img_hw):
        super().__init__(filename)
        self.K = K
        self.img_hw = img_hw

    def read(self, filename: str) -> np.ndarray:
        import h5py
        import cv2
        with h5py.File(filename, "r") as f:
            raydepth = np.array(f["dataset"]).astype(np.float32)
        if raydepth.shape != tuple(self.img_hw):
            raydepth = cv2.resize(raydepth,
                                  (self.img_hw[1], self.img_hw[0]))
        return raydepth2depth(raydepth, self.K)


class Hypersim:
    default_h, default_w = 768, 1024
    fov_x = np.pi / 3.0
    R180x = np.diag([1.0, -1.0, -1.0])

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.scene_dir = None
        self.mpau = None
        self.h, self.w = self.default_h, self.default_w
        f = self.w / (2 * np.tan(self.fov_x / 2))
        self.K = np.array([[f, 0, self.w / 2], [0, f, self.h / 2],
                           [0, 0, 1.0]])

    def set_max_dim(self, max_dim: int) -> None:
        """Scale the images down to ``max_dim`` on their longer side;
        ``max_dim <= 0`` keeps them."""
        ratio = max_dim / max(self.h, self.w)
        if 0 < ratio < 1.0:
            self.h = int(round(self.h * ratio))
            self.w = int(round(self.w * ratio))
            f = self.w / (2 * np.tan(self.fov_x / 2))
            self.K = np.array([[f, 0, self.w / 2], [0, f, self.h / 2],
                               [0, 0, 1.0]])

    def set_scene_id(self, scene_id: str) -> None:
        self.scene_dir = os.path.join(self.data_dir, scene_id)
        self.mpau = self._read_mpau(self.scene_dir)

    @staticmethod
    def _read_mpau(scene_dir: str) -> float:
        fname = os.path.join(scene_dir, "_detail", "metadata_scene.csv")
        with open(fname) as f:
            for row in csv.DictReader(f):
                if row["parameter_name"] == "meters_per_asset_unit":
                    return float(row["parameter_value"])
        raise ValueError(f"meters_per_asset_unit missing in {fname}")

    def load_cameras(self, cam_id: int = 0):
        import h5py
        detail = os.path.join(self.scene_dir, "_detail",
                              f"cam_{cam_id:02d}")
        with h5py.File(os.path.join(
                detail, "camera_keyframe_positions.hdf5"), "r") as f:
            Tvecs = np.array(f["dataset"]).astype(np.float64)
        with h5py.File(os.path.join(
                detail, "camera_keyframe_orientations.hdf5"), "r") as f:
            Rvecs = np.array(f["dataset"]).astype(np.float64)
        # world-to-camera with the 180-deg x flip convention
        Rs, ts = [], []
        for i in range(len(Tvecs)):
            R = self.R180x @ Rvecs[i].T
            t = -R @ (Tvecs[i] * self.mpau)
            Rs.append(R)
            ts.append(t)
        return Rs, ts

    def imname(self, image_id: int, cam_id: int = 0) -> str:
        return os.path.join(
            self.scene_dir, "images",
            f"scene_cam_{cam_id:02d}_final_preview",
            f"frame.{image_id:04d}.color.jpg")

    def raydepth_fname(self, image_id: int, cam_id: int = 0) -> str:
        return os.path.join(
            self.scene_dir, "images",
            f"scene_cam_{cam_id:02d}_geometry_hdf5",
            f"frame.{image_id:04d}.depth_meters.hdf5")

    def filter_index_list(self, index_list, cam_id: int = 0):
        return [i for i in index_list
                if os.path.exists(self.imname(i, cam_id))]

    def read_imagecols(self, index_list, cam_id: int = 0) -> ImageCollection:
        Rs, ts = self.load_cameras(cam_id)
        cameras = {0: Camera(K=self.K, hw=(self.h, self.w), cam_id=0)}
        images = {}
        for img_id in index_list:
            images[img_id] = CameraImage(
                0, CameraPose(R=Rs[img_id], tvec=ts[img_id]),
                self.imname(img_id, cam_id))
        return ImageCollection(cameras, images)

    def depth_readers(self, index_list, cam_id: int = 0):
        return {i: HypersimDepthReader(self.raydepth_fname(i, cam_id),
                                       self.K, (self.h, self.w))
                for i in index_list}


def read_scene_hypersim(cfg, dataset: Hypersim, scene_id: str,
                        cam_id: int = 0, load_depth: bool = False):
    """The scene's image collection (the first ``input_n_views`` frames
    that exist), and with ``load_depth`` their depth readers."""
    dataset.set_max_dim(cfg.get("max_image_dim", -1) or -1)
    dataset.set_scene_id(scene_id)
    index_list = np.arange(cfg.get("input_n_views", 100)).tolist()
    index_list = dataset.filter_index_list(index_list, cam_id=cam_id)
    imagecols = dataset.read_imagecols(index_list, cam_id=cam_id)
    if load_depth:
        return imagecols, dataset.depth_readers(index_list, cam_id=cam_id)
    return imagecols
