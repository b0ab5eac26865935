"""The port's undistortion (limap_tpu_torch/undistortion and
runners.functions.undistort_images) against the JAX package's, on the
CPU: the same PINHOLE cameras, the same undistorted points (1e-9 px)
and the same undistorted images (bit-equal: both call OpenCV alike)."""

import os

import cv2
import numpy as np
import pytest

from limap_tpu.base.camera import Camera as RefCamera
from limap_tpu.base.image_collection import ImageCollection as RefCollection
from limap_tpu.runners import functions as ref_runners
from limap_tpu.undistortion import undistort as ref_und
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.runners import functions as runners
from limap_tpu_torch.undistortion import (undistort_camera,
                                          undistort_image_camera,
                                          undistort_points)
from torch_threads import two_torch_threads  # noqa: F401

MODELS = {
    "PINHOLE": [300.0, 310.0, 160.0, 120.0],
    "SIMPLE_RADIAL": [300.0, 160.0, 120.0, 0.08],
    "RADIAL": [300.0, 160.0, 120.0, 0.05, -0.02],
    "OPENCV": [300.0, 305.0, 160.0, 120.0, 0.05, -0.01, 0.001, -0.002],
    "OPENCV_FISHEYE": [300.0, 305.0, 160.0, 120.0, 0.02, -0.01, 0.003,
                       0.0],
}


def image(rng, path):
    img = (rng.random((240, 320, 3)) * 255).astype(np.uint8)
    cv2.line(img, (20, 30), (300, 200), (0, 0, 0), 3)
    cv2.imwrite(str(path), img)
    return str(path)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_camera_points_and_image_equal_reference(rng, tmp_path, model):
    cam = Camera(model, MODELS[model], cam_id=4, hw=(240, 320))
    ref = RefCamera(model, MODELS[model], cam_id=4, hw=(240, 320))
    out, ref_out = undistort_camera(cam), ref_und.undistort_camera(ref)
    assert out.as_dict() == ref_out.as_dict()
    assert out.model_name == "PINHOLE" and out.is_undistorted()

    pts = rng.uniform([0, 0], [320, 240], (50, 2))
    np.testing.assert_allclose(undistort_points(pts, cam),
                               ref_und.undistort_points(pts, ref),
                               atol=1e-9)

    src = image(rng, tmp_path / "in.png")
    a = undistort_image_camera(cam, src, str(tmp_path / "port.png"))
    b = ref_und.undistort_image_camera(ref, src, str(tmp_path / "ref.png"))
    assert a.as_dict() == b.as_dict()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "ref.png")))


def test_undistort_images_of_a_collection_equals_reference(rng, tmp_path):
    cams = {0: Camera("SIMPLE_RADIAL", MODELS["SIMPLE_RADIAL"], cam_id=0,
                      hw=(240, 320)),
            1: Camera("PINHOLE", MODELS["PINHOLE"], cam_id=1,
                      hw=(240, 320))}
    images = {k: CameraImage(k % 2, CameraPose(tvec=(0.1 * k, 0.0, 0.0)),
                             image(rng, tmp_path / f"im_{k}.png"))
              for k in range(4)}
    cols = ImageCollection(cams, images)
    before = cols.as_dict()
    out = runners.undistort_images(cols, str(tmp_path / "port"))
    ref = ref_runners.undistort_images(
        RefCollection.from_dict(before), str(tmp_path / "ref"))
    assert out.IsUndistorted() and ref.IsUndistorted()
    assert cols.as_dict() == before          # the input is left as it was
    od, rd = out.as_dict(), ref.as_dict()
    for k in range(4):
        o, r = od["images"][k], rd["images"][k]
        np.testing.assert_allclose(o["pose"]["qvec"], r["pose"]["qvec"],
                                   rtol=1e-12)
        assert o["pose"]["tvec"] == r["pose"]["tvec"]
        assert o["cam_id"] == r["cam_id"]
        assert o["image_name"].replace("port", "ref") == r["image_name"]
    assert od["cameras"] == rd["cameras"]
    np.testing.assert_array_equal(cv2.imread(out.image_name(0)),
                                  cv2.imread(ref.image_name(0)))
    # the JAX package writes the first image of a camera only (ROADMAP.md
    # section 3); the port writes each, as OpenCV undistorts it
    assert not os.path.exists(ref.image_name(2))
    ref_und.undistort_image_camera(
        RefCamera("SIMPLE_RADIAL", MODELS["SIMPLE_RADIAL"], cam_id=0,
                  hw=(240, 320)), cols.image_name(2),
        str(tmp_path / "ref_2.png"))
    np.testing.assert_array_equal(cv2.imread(out.image_name(2)),
                                  cv2.imread(str(tmp_path / "ref_2.png")))
    assert runners.undistort_images(out, str(tmp_path / "x")) is out
