"""Point-map readers: a 3D world point per pixel, the dense-scan
counterpart of a depth map (the point-map fitting path)."""

from __future__ import annotations

import numpy as np


class BaseP3DReader:
    def __init__(self, filename: str):
        self.filename = filename

    def read(self, filename: str) -> np.ndarray:
        """-> [H, W, 3] world point per pixel (NaN, inf or 0 = miss)."""
        raise NotImplementedError

    def read_p3ds(self) -> np.ndarray:
        return self.read(self.filename)


class ArrayP3DReader(BaseP3DReader):
    """An in-memory point map."""

    def __init__(self, p3ds: np.ndarray):
        super().__init__("<array>")
        self._p3ds = np.asarray(p3ds)

    def read(self, filename: str) -> np.ndarray:
        return self._p3ds
