"""ETH3D dataset loader (reference: runners/eth3d/ETH3D.py).

ETH3D ships COLMAP-format calibration
(``<scene>/dslr_calibration_undistorted/``) plus ground-truth scan
clouds; images under ``<scene>/images``.
"""

from __future__ import annotations

import os

import numpy as np

from limap_tpu_torch.base.depth_reader_base import BaseDepthReader
from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks


class ETH3DDepthReader(BaseDepthReader):
    """16-bit png depth in 1/256 m units; 0 = missing -> inf
    (reference runners/eth3d/ETH3D.py:81-85)."""

    def read(self, filename: str) -> np.ndarray:
        import cv2
        depth = cv2.imread(filename, cv2.IMREAD_ANYDEPTH)
        if depth is None:
            raise FileNotFoundError(filename)
        depth = depth.astype(np.float32) / 256
        depth[depth == 0] = np.inf
        return depth


class ETH3D:
    # standard split (reference ETH3D.py)
    scenes_train = [
        "courtyard", "delivery_area", "electro", "facade", "kicker",
        "meadow", "office", "pipes", "playground", "relief", "relief_2",
        "terrace", "terrains",
    ]

    def __init__(self, data_dir: str):
        self.data_dir = data_dir

    def scene_dir(self, scene_id: str) -> str:
        return os.path.join(self.data_dir, scene_id)

    def read_imagecols(self, scene_id: str,
                       calib: str = "dslr_calibration_undistorted"):
        model_path = os.path.join(self.scene_dir(scene_id), calib)
        imagecols = ReadInfos(model_path,
                              image_path=os.path.join(
                                  self.scene_dir(scene_id), "images"))
        return imagecols

    def read_points3d(self, scene_id: str,
                      calib: str = "dslr_calibration_undistorted"):
        return ReadPointTracks(os.path.join(self.scene_dir(scene_id),
                                            calib))

    # ---- ground-truth depth (reference ETH3D.py:81-102) ----
    def get_depth_fname(self, scene_id: str, image_name: str,
                        use_inpainted: bool = True) -> str:
        """Depth png for an image: ``inpainted_depth/<name>.png`` when
        available, else ``ground_truth_depth/<name>.png``.  image_name
        may be an absolute path (as stored by read_imagecols) — it is
        resolved relative to the scene's images folder."""
        images_dir = os.path.join(self.scene_dir(scene_id), "images")
        name = os.path.relpath(image_name, images_dir) \
            if os.path.isabs(image_name) else image_name
        sub = "inpainted_depth" if use_inpainted else \
            "ground_truth_depth"
        return os.path.join(self.scene_dir(scene_id), sub,
                            f"{name}.png")

    def read_depths(self, scene_id: str, imagecols,
                    use_inpainted: bool = True) -> dict:
        """{img_id: ETH3DDepthReader} for every image of the scene."""
        return {img_id: ETH3DDepthReader(self.get_depth_fname(
                    scene_id, imagecols.camimage(img_id).image_name,
                    use_inpainted=use_inpainted))
                for img_id in imagecols.get_img_ids()}

    def read_gt_scan(self, scene_id: str) -> np.ndarray:
        """GT laser scan point cloud (scan_clean ply files)."""
        from limap_tpu_torch.util.io import read_ply
        scan_dir = os.path.join(self.scene_dir(scene_id), "scan_clean")
        plys = sorted(f for f in os.listdir(scan_dir)
                      if f.endswith(".ply")) if os.path.isdir(scan_dir) \
            else []
        clouds = [read_ply(os.path.join(scan_dir, f)) for f in plys]
        return np.concatenate(clouds) if clouds else np.zeros((0, 3))
