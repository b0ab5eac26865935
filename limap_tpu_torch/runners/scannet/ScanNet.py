"""ScanNet scene loader (reference: runners/scannet/ScanNet.py).

Reads the exported ScanNet layout:
  <scene>/intrinsic/intrinsic_color.txt (or _info.txt style), frames
  under color/ and per-frame camera-to-world poses under pose/.
"""

import os

import numpy as np

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.depth_reader_base import BaseDepthReader
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection


class ScanNet:
    def __init__(self, data_dir, max_image_dim: int = -1):
        self.data_dir = data_dir
        self.max_image_dim = max_image_dim
        self.scene_dir = None
        self.stride = 1

    def set_scene_id(self, scene_id):
        self.scene_dir = os.path.join(self.data_dir, scene_id)

    def set_stride(self, stride):
        self.stride = stride

    def _read_intrinsics(self):
        # preferred: intrinsic/intrinsic_color.txt with a 4x4 matrix
        fname = os.path.join(self.scene_dir, "intrinsic",
                             "intrinsic_color.txt")
        if os.path.isfile(fname):
            M = np.loadtxt(fname)
            return M[:3, :3]
        # fallback: _info.txt key=value export
        fname = os.path.join(self.scene_dir, "_info.txt")
        K = np.eye(3)
        with open(fname) as f:
            for line in f:
                if "=" not in line:
                    continue
                key, val = [t.strip() for t in line.split("=", 1)]
                if key == "fx_color":
                    K[0, 0] = float(val)
                elif key == "fy_color":
                    K[1, 1] = float(val)
                elif key == "mx_color":
                    K[0, 2] = float(val)
                elif key == "my_color":
                    K[1, 2] = float(val)
        return K

    def read_imagecols(self):
        import cv2

        K = self._read_intrinsics()
        color_dir = os.path.join(self.scene_dir, "color")
        pose_dir = os.path.join(self.scene_dir, "pose")
        frames = sorted(f for f in os.listdir(color_dir)
                        if f.endswith((".jpg", ".png")))
        frames = frames[::self.stride]
        first = cv2.imread(os.path.join(color_dir, frames[0]))
        h, w = first.shape[:2]
        scale = 1.0
        if self.max_image_dim > 0 and max(h, w) > self.max_image_dim:
            scale = self.max_image_dim / max(h, w)
        Ks = K.copy()
        Ks[:2] *= scale
        cams = {0: Camera(K=Ks, hw=(int(round(h * scale)),
                                    int(round(w * scale))), cam_id=0)}
        images = {}
        for idx, fr in enumerate(frames):
            stem = os.path.splitext(fr)[0]
            Twc = np.loadtxt(os.path.join(pose_dir, stem + ".txt"))
            if not np.all(np.isfinite(Twc)):
                continue
            R = Twc[:3, :3].T                      # world-to-cam
            t = -R @ Twc[:3, 3]
            images[idx] = CameraImage(
                0, CameraPose(R=R, tvec=t),
                image_name=os.path.join(color_dir, fr))
        return ImageCollection(cams, images)


class ScanNetDepthReader(BaseDepthReader):
    """ScanNet exports depth as 16-bit PNG millimeters
    (reference ScanNet.py:131-135)."""

    def read(self, filename: str) -> np.ndarray:
        import cv2

        depth = cv2.imread(filename, cv2.IMREAD_UNCHANGED)
        return depth.astype(np.float32) / 1000.0


def read_scene_scannet(cfg, dataset: ScanNet, scene_id: str,
                       load_depth: bool = False):
    dataset.set_scene_id(scene_id)
    dataset.set_stride(cfg.get("stride", 1))
    imagecols = dataset.read_imagecols()
    if not load_depth:
        return imagecols
    depth_dir = os.path.join(dataset.scene_dir, "depth")
    depths = {}
    for img_id in imagecols.get_img_ids():
        stem = os.path.splitext(os.path.basename(
            imagecols.images[img_id].image_name))[0]
        depths[img_id] = ScanNetDepthReader(
            os.path.join(depth_dir, stem + ".png"))
    return imagecols, depths
