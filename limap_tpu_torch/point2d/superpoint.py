"""The classical keypoint extractor: Harris corners with normalized
patch descriptors (no checkpoint needed).  OpenCV is imported inside the
call."""

from __future__ import annotations

from typing import Dict

import numpy as np


class HarrisPatchExtractor:
    """Up to ``max_keypoints`` corners an image, each described by its
    ``block`` x ``block`` patch resized to 8 x 8, mean-free and
    L2-normalized (64 floats)."""

    def __init__(self, max_keypoints: int = 2048, block: int = 9):
        self.max_keypoints = max_keypoints
        self.block = block

    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        import cv2
        img = np.asarray(image)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img32 = img.astype(np.float32)
        corners = cv2.goodFeaturesToTrack(
            img32, self.max_keypoints, 0.01, 5)
        if corners is None:
            return {"keypoints": np.zeros((0, 2), np.float32),
                    "scores": np.zeros(0),
                    "descriptors": np.zeros((0, 64))}
        kps = corners.reshape(-1, 2)
        half = self.block // 2
        pad = np.pad(img32, half, mode="edge")
        descs = []
        for x, y in kps:
            xi, yi = int(round(x)), int(round(y))
            patch = pad[yi:yi + self.block, xi:xi + self.block]
            v = cv2.resize(patch, (8, 8)).reshape(-1)
            v = v - v.mean()
            descs.append(v / (np.linalg.norm(v) + 1e-8))
        return {"keypoints": kps.astype(np.float32),
                "scores": np.ones(len(kps)),
                "descriptors": np.stack(descs)}
