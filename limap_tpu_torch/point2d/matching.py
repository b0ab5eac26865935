"""Mutual nearest-neighbour point matching."""

from __future__ import annotations

import numpy as np


def mutual_nn_match(desc1: np.ndarray, desc2: np.ndarray,
                    min_score: float = 0.7) -> np.ndarray:
    """[M, 2] index pairs that are each other's best match by the dot
    product of L2-normalized descriptors, with score >= ``min_score``
    (the first index on ties)."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros((0, 2), np.int64)
    s = np.asarray(desc1) @ np.asarray(desc2).T
    b2 = s.argmax(1)
    b1 = s.argmax(0)
    i = np.arange(len(desc1))
    good = (b1[b2] == i) & (s[i, b2] >= min_score)
    return np.stack([i[good], b2[good]], axis=1)
