"""ImageCollection: map of cameras + map of posed images, with a
:meth:`ImageCollection.batch` view as a :class:`CameraViewsBatch`."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from limap_tpu_torch.base.camera import (Camera, CameraPose, CameraView,
                                         CameraViewsBatch)


class CameraImage:
    """cam_id + pose + image name."""

    def __init__(self, cam_id: int, pose: Optional[CameraPose] = None,
                 image_name: str = "none"):
        self.cam_id = int(cam_id)
        self.pose = pose if pose is not None else CameraPose(initialized=False)
        self.image_name = image_name

    def R(self) -> np.ndarray:
        return self.pose.R()

    def T(self) -> np.ndarray:
        return self.pose.T()

    def as_dict(self) -> dict:
        return {"cam_id": self.cam_id, "pose": self.pose.as_dict(),
                "image_name": self.image_name}

    @classmethod
    def from_dict(cls, d: dict) -> "CameraImage":
        return cls(d["cam_id"], CameraPose.from_dict(d["pose"]),
                   d.get("image_name", "none"))


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

    @classmethod
    def from_views(cls, camviews: List[CameraView]) -> "ImageCollection":
        """One image a view, ids in list order; a camera without an id
        takes its view's."""
        cams, imgs = {}, {}
        for i, v in enumerate(camviews):
            cid = v.cam.camera_id if v.cam.camera_id >= 0 else i
            cams[cid] = v.cam
            imgs[i] = CameraImage(cid, v.pose, v.image_name)
        return cls(cams, imgs)

    def NumCameras(self) -> int:
        return len(self.cameras)

    def NumImages(self) -> int:
        return len(self.images)

    def get_cameras(self) -> List[Camera]:
        return [self.cameras[i] for i in self.get_cam_ids()]

    def get_images(self) -> List[CameraImage]:
        return [self.images[i] for i in self.get_img_ids()]

    def get_map_locations(self) -> Dict[int, np.ndarray]:
        return {i: self.campose(i).center() for i in self.get_img_ids()}

    def get_image_name_list(self) -> List[str]:
        return [self.images[i].image_name for i in self.get_img_ids()]

    def get_image_name_dict(self) -> Dict[int, str]:
        return {i: self.images[i].image_name for i in self.get_img_ids()}

    def exist_cam(self, cam_id: int) -> bool:
        return cam_id in self.cameras

    def set_camera_params(self, cam_id: int, params) -> None:
        self.cameras[cam_id].params = np.asarray(params, dtype=np.float64)

    def change_image(self, img_id: int, camimage: CameraImage) -> None:
        self.images[img_id] = camimage

    def subset_by_camera_ids(self, valid_camera_ids) -> "ImageCollection":
        """The given cameras and the images that use them."""
        valid = set(valid_camera_ids)
        cams = {k: v for k, v in self.cameras.items() if k in valid}
        imgs = {k: v for k, v in self.images.items() if v.cam_id in valid}
        return ImageCollection(cams, imgs)

    def subset_initialized(self) -> "ImageCollection":
        return self.subset_by_image_ids(
            [i for i in self.get_img_ids() if self.images[i].pose.initialized])

    def apply_similarity_transform(self, scale, R, t) -> "ImageCollection":
        """A copy in the world scale * R @ world + t (the cameras
        shared)."""
        out = ImageCollection(dict(self.cameras), {})
        R, t = np.asarray(R), np.asarray(t)
        for img_id, im in self.images.items():
            new_R = im.pose.R() @ R.T
            new_t = scale * im.pose.tvec - new_R @ t
            out.images[img_id] = CameraImage(
                im.cam_id, CameraPose(R=new_R, tvec=new_t), im.image_name)
        return out

    def get_first_image_id_by_camera_id(self, cam_id: int) -> int:
        for img_id in self.get_img_ids():
            if self.images[img_id].cam_id == cam_id:
                return img_id
        return -1

    def init_uninitialized_cameras(self) -> None:
        """A camera of known size and all-zero parameters gets focal
        1.2 max(w, h) and the image centre."""
        for cam in self.cameras.values():
            if cam.w() <= 0 or cam.h() <= 0:
                continue
            if np.all(cam.params == 0):
                cam.params[list(cam.focal_idxs())] = 1.2 * max(cam.w(),
                                                               cam.h())
                pi = cam.pp_idxs()
                cam.params[pi[0]] = cam.w() / 2.0
                cam.params[pi[1]] = cam.h() / 2.0

    def uninitialize_poses(self) -> None:
        for im in self.images.values():
            im.pose = CameraPose(initialized=False)

    def uninitialize_intrinsics(self) -> None:
        for cam in self.cameras.values():
            cam.params[:] = 0.0

    def IsUndistortedCameraModel(self) -> bool:
        return all(cam.model_id in (0, 1) for cam in self.cameras.values())

    def get_img_ids(self) -> List[int]:
        return sorted(self.images.keys())

    def get_cam_ids(self) -> List[int]:
        return sorted(self.cameras.keys())

    def exist_image(self, img_id: int) -> bool:
        return img_id in self.images

    def campose(self, img_id: int) -> CameraPose:
        return self.images[img_id].pose

    def cam(self, cam_id: int) -> Camera:
        return self.cameras[cam_id]

    def set_camera_pose(self, img_id: int, pose: CameraPose) -> None:
        self.images[img_id].pose = pose

    def get_camera_pose(self, img_id: int) -> CameraPose:
        return self.images[img_id].pose

    def get_map_camviews(self) -> Dict[int, CameraView]:
        return {i: self.camview(i) for i in self.get_img_ids()}

    def camimage(self, img_id: int) -> CameraImage:
        return self.images[img_id]

    def change_camera(self, cam_id: int, cam: Camera) -> None:
        self.cameras[cam_id] = cam

    def change_image_name(self, img_id: int, new_name: str) -> None:
        self.images[img_id].image_name = new_name

    def get_locations(self) -> List:
        """Camera centres in sorted image id order."""
        return [self.campose(i).center() for i in self.get_img_ids()]

    def subset_by_image_ids(self, valid_image_ids) -> "ImageCollection":
        """The given images and the cameras they use."""
        valid = set(valid_image_ids)
        imgs = {k: v for k, v in self.images.items() if k in valid}
        used_cams = {im.cam_id for im in imgs.values()}
        cams = {k: v for k, v in self.cameras.items() if k in used_cams}
        return ImageCollection(cams, imgs)

    def image_name(self, img_id: int) -> str:
        return self.images[img_id].image_name

    def read_image(self, img_id: int, set_gray: bool = False):
        return self.camview(img_id).read_image(set_gray)

    def set_max_image_dim(self, val: int) -> None:
        for cam in self.cameras.values():
            cam.set_max_image_dim(val)

    def update_neighbors(self, neighbors: Dict[int, List[int]]):
        """Drop neighbour entries that are not in the collection."""
        out = {}
        for img_id, ngs in neighbors.items():
            if not self.exist_image(img_id):
                continue
            out[img_id] = [n for n in ngs if self.exist_image(n)]
        return out

    def as_dict(self) -> dict:
        return {
            "cameras": {k: v.as_dict() for k, v in self.cameras.items()},
            "images": {k: v.as_dict() for k, v in self.images.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ImageCollection":
        cams = {int(k): Camera.from_dict(v) for k, v in d["cameras"].items()}
        imgs = {int(k): CameraImage.from_dict(v)
                for k, v in d["images"].items()}
        return cls(cams, imgs)

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
