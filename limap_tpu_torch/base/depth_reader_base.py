"""Depth map readers: a file-backed base class and an in-memory one."""

from __future__ import annotations

import numpy as np


class BaseDepthReader:
    def __init__(self, filename: str):
        self.filename = filename

    def read(self, filename: str) -> np.ndarray:
        raise NotImplementedError

    def read_depth(self, img_hw=None) -> np.ndarray:
        """The depth map [H, W], resized (nearest) to ``img_hw`` when its
        size differs; OpenCV is imported only then."""
        depth = self.read(self.filename)
        if img_hw is not None and depth.shape != tuple(img_hw):
            import cv2
            depth = cv2.resize(depth, (img_hw[1], img_hw[0]),
                               interpolation=cv2.INTER_NEAREST)
        return depth


class ArrayDepthReader(BaseDepthReader):
    """An in-memory depth map."""

    def __init__(self, depth: np.ndarray):
        super().__init__("<array>")
        self.depth = np.asarray(depth)

    def read(self, filename: str) -> np.ndarray:
        return self.depth
