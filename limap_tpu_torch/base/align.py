"""Similarity alignment of camera sets and line tracks (Umeyama)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform y ~ s R x + t.

    x, y: [3, N] point sets.  Returns (R, t, s).
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != y.shape or x.shape[0] != 3:
        raise ValueError("expected matching [3, N] arrays")
    n = x.shape[1]
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc = x - mx
    yc = y - my
    cov = yc @ xc.T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / n
        s = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        s = 1.0
    t = my[:, 0] - s * R @ mx[:, 0]
    return R, t, s


def align_imagecols_umeyama(imagecols_src, imagecols_dst):
    """Align two ImageCollections by camera centers (align.py:5-40).

    Returns ((R, t, s), transformed src collection).
    """
    shared = sorted(set(imagecols_src.get_img_ids())
                    & set(imagecols_dst.get_img_ids()))
    if len(shared) < 3:
        raise ValueError("need >= 3 shared images to align")
    c_src = np.stack([imagecols_src.campose(i).center()
                      for i in shared]).T
    c_dst = np.stack([imagecols_dst.campose(i).center()
                      for i in shared]).T
    R, t, s = umeyama_alignment(c_src, c_dst, with_scale=True)
    aligned = imagecols_src.apply_similarity_transform(s, R, t)
    return (R, t, s), aligned


def transform_linetracks(linetracks, R, t, s):
    """Apply a Sim3 to track geometry."""
    R = np.asarray(R)
    t = np.asarray(t)
    for track in linetracks:
        track.line = (s * track.line @ R.T) + t
        track.line3d_list = [(s * l @ R.T) + t for l in track.line3d_list]
    return linetracks
