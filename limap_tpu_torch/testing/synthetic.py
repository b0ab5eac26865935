"""The synthetic protocol scene of the reference's ``bench.py``: random
GT segments seen by posed pinhole views, their exact projections as the
2D detections, and identity matches between each view and its
``n_neighbors`` nearest views by index."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from limap_tpu_torch.base import line_geometry as lg
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.base.lines import Segments


def build_scene(n_views: int, n_lines: int, n_neighbors: int, seed: int = 0,
                device=None):
    """Returns (imagecols, segs {img_id: [n_lines, 4]}, matches
    {img_id: {nbr_id: [n_lines, 2]}}, gt [n_lines, 2, 3]).  The
    projections run on ``device`` (``None`` means cuda)."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    cams = {0: Camera(K=K, hw=(480, 640), cam_id=0)}
    images = {}
    for k in range(n_views):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
        t = np.array([0.4 * (k % 8), 0.3 * (k // 8), 0.1 * k])
        images[k] = CameraImage(0, CameraPose(R=R, tvec=t))
    imagecols = ImageCollection(cams, images)
    gt_start = rng.normal(size=(n_lines, 3)).astype(np.float32) * 3
    gt_start[:, 2] += 12
    gt_end = gt_start + rng.normal(size=(n_lines, 3)).astype(np.float32)
    vb = imagecols.batch(device)
    rows = torch.arange(n_views, device=vb.kvec.device).repeat_interleave(
        n_lines)
    seg = Segments(torch.as_tensor(gt_start, device=vb.kvec.device)
                   .repeat(n_views, 1),
                   torch.as_tensor(gt_end, device=vb.kvec.device)
                   .repeat(n_views, 1))
    l2d = lg.project_segments(seg, vb.select(rows))
    arr = torch.cat([l2d.start, l2d.end], 1).reshape(
        n_views, n_lines, 4).cpu().numpy()
    segs = {k: arr[k] for k in range(n_views)}
    matches = np.stack([np.arange(n_lines)] * 2, axis=1)
    half = n_neighbors // 2
    nbrs = {i: {j: matches
                for j in range(max(0, i - half), min(n_views, i + half + 1))
                if j != i}
            for i in range(n_views)}
    return imagecols, segs, nbrs, np.stack([gt_start, gt_end], 1)


def gt_point_cloud(gt: np.ndarray, points_per_segment: int) -> np.ndarray:
    """[n_lines * points_per_segment, 3] points evenly along each GT
    segment (both ends included)."""
    t = np.linspace(0.0, 1.0, points_per_segment, dtype=np.float32)
    pts = gt[:, None, 0] + t[None, :, None] * (gt[:, None, 1] - gt[:, None, 0])
    return pts.reshape(-1, 3).astype(np.float32)
