"""ImageCollection: map of cameras + map of posed images, with a
:meth:`ImageCollection.batch` view as a :class:`CameraViewsBatch`."""

from __future__ import annotations

from typing import Dict, List, Optional

from limap_tpu_torch.base.camera import (Camera, CameraPose, CameraView,
                                         CameraViewsBatch)


class CameraImage:
    """cam_id + pose + image name."""

    def __init__(self, cam_id: int, pose: Optional[CameraPose] = None,
                 image_name: str = "none"):
        self.cam_id = int(cam_id)
        self.pose = pose if pose is not None else CameraPose(initialized=False)
        self.image_name = image_name


class ImageCollection:
    def __init__(self, cameras=None, images=None):
        """cameras: {cam_id: Camera} | [Camera]; images: {img_id:
        CameraImage} | [CameraImage]."""
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, CameraImage] = {}
        if cameras is not None:
            if isinstance(cameras, dict):
                self.cameras = {int(k): v for k, v in cameras.items()}
            else:
                for cam in cameras:
                    cid = cam.camera_id if cam.camera_id >= 0 else len(
                        self.cameras)
                    self.cameras[cid] = cam
        if images is not None:
            if isinstance(images, dict):
                self.images = {int(k): v for k, v in images.items()}
            else:
                self.images = {i: im for i, im in enumerate(images)}

    def get_img_ids(self) -> List[int]:
        return sorted(self.images.keys())

    def camview(self, img_id: int) -> CameraView:
        im = self.images[img_id]
        return CameraView(self.cameras[im.cam_id], im.pose, im.image_name)

    def get_camviews(self) -> List[CameraView]:
        return [self.camview(i) for i in self.get_img_ids()]

    def IsUndistorted(self) -> bool:
        return all(cam.is_undistorted() for cam in self.cameras.values())

    def batch(self, device=None) -> CameraViewsBatch:
        """Views ordered by sorted image id, on ``device``."""
        return CameraViewsBatch.from_views(self.get_camviews(), device)

    def img_id_to_index(self) -> Dict[int, int]:
        """img_id -> row in :meth:`batch` order."""
        return {img_id: i for i, img_id in enumerate(self.get_img_ids())}
