"""Camera and image undistortion (OpenCV, imported inside the calls)."""

from limap_tpu_torch.undistortion.undistort import (undistort_camera,
                                                    undistort_image_camera,
                                                    undistort_points)

__all__ = ["undistort_camera", "undistort_image_camera", "undistort_points"]
