"""Point SfM with known poses: the sparse point model that feeds the
visual neighbours and the scene ranges, built in-process.

1. keypoints and descriptors per image (the Harris-patch extractor; a
   learned SuperPoint front end is ROADMAP.md queue 1 item 14),
2. mutual nearest-neighbour matching over candidate pairs (host),
3. two-ray midpoint triangulation against the known poses with the
   cheirality, triangulation-angle and reprojection gates, every match
   of every pair in one batch of torch ops on ``device``,
4. tracks by union-find over the verified matches and a median point
   per track (host), in the order of the pairs and their matches.

Output: {pid: {"xyz": [3], "image_ids": [...], "p2ds": {img_id: [2]}}},
which :meth:`SfmModel.from_imagecols_and_points` takes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch


def triangulate_pairs(views: CameraViewsBatch, rows1, rows2, p1, p2):
    """Batched two-ray midpoint triangulation: rows1/rows2 [M] view rows,
    p1/p2 [M, 2] pixels, all on the views' device.  Returns xyz [M, 3],
    valid [M] (both ray parameters positive, rays not parallel) and the
    |cosine| of the ray angle [M]."""
    v1 = views.select(rows1)
    v2 = views.select(rows2)
    d1 = v1.ray_direction(p1)
    d2 = v2.ray_direction(p2)
    c1 = v1.center()
    c2 = v2.center()
    b = c2 - c1
    d11 = torch.sum(d1 * d1, -1)
    d22 = torch.sum(d2 * d2, -1)
    d12 = torch.sum(d1 * d2, -1)
    denom = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(denom) < 1e-12,
                      torch.full_like(denom, 1e-12), denom)
    t1 = (torch.sum(b * d1, -1) * d22 - torch.sum(b * d2, -1) * d12) / den
    t2 = (torch.sum(b * d1, -1) * d12 - torch.sum(b * d2, -1) * d11) / den
    x1 = c1 + d1 * t1[..., None]
    x2 = c2 + d2 * t2[..., None]
    xyz = 0.5 * (x1 + x2)
    cos = torch.abs(d12) / torch.sqrt(d11 * d22 + 1e-12)
    valid = (t1 > 0) & (t2 > 0) & (torch.abs(denom) > 1e-12)
    return xyz, valid, cos


class _UnionFind:
    """Union-find over hashable nodes; ``parent`` keeps the order in
    which nodes were first seen, which orders the tracks."""

    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        while p != x:
            self.parent[x] = self.parent.setdefault(p, p)
            x = self.parent[x]
            p = self.parent.setdefault(x, x)
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def run_sfm_with_known_poses(
        imagecols, images: Optional[Dict[int, np.ndarray]] = None,
        features: Optional[Dict[int, dict]] = None,
        pair_ids: Optional[List[Tuple[int, int]]] = None,
        n_neighbors: int = 8,
        min_tri_angle_deg: float = 1.5,
        max_reproj_px: float = 4.0,
        ratio: float = 0.7,
        weight_path: Optional[str] = None,
        min_track_length: int = 2, device=None) -> Dict[int, dict]:
    """Triangulate a sparse point model against the known poses.

    images: {img_id: grayscale array}; or precomputed ``features``
    ({img_id: {keypoints, descriptors}}).  ``pair_ids`` restricts
    matching (default: each image with its ``n_neighbors`` nearest
    cameras).  ``device=None`` means cuda."""
    device = resolve_device(device)
    ids = imagecols.get_img_ids()
    id2row = imagecols.img_id_to_index()
    views = imagecols.batch(device)

    # 1. features
    if features is None:
        from limap_tpu_torch.point2d.superpoint import (HarrisPatchExtractor,
                                                        SuperPoint)
        if weight_path is not None:
            extractor = SuperPoint(weight_path=weight_path, device=device)
        else:
            extractor = HarrisPatchExtractor()
        features = {i: extractor(images[i]) for i in ids}

    # 2. candidate pairs
    if pair_ids is None:
        from limap_tpu_torch.runners.functions import compute_pose_neighbors
        nbrs = compute_pose_neighbors(imagecols, n_neighbors)
        pair_ids = sorted({(min(i, j), max(i, j))
                           for i in ids for j in nbrs[i]})

    # 3. match every pair, then triangulate and verify all at once
    from limap_tpu_torch.point2d.matching import mutual_nn_match
    pairs, matched = [], []
    for (i, j) in pair_ids:
        fi, fj = features[i], features[j]
        if len(fi["keypoints"]) == 0 or len(fj["keypoints"]) == 0:
            continue
        m = mutual_nn_match(fi["descriptors"], fj["descriptors"],
                            min_score=ratio)
        if len(m):
            pairs.append((i, j))
            matched.append(m)
    uf = _UnionFind()
    obs_xyz: Dict[Tuple[int, int], list] = {}
    if pairs:
        cat = lambda xs: torch.as_tensor(np.concatenate(xs), device=device)
        p1 = cat([np.asarray(features[i]["keypoints"], np.float32)[m[:, 0]]
                  for (i, _), m in zip(pairs, matched)])
        p2 = cat([np.asarray(features[j]["keypoints"], np.float32)[m[:, 1]]
                  for (_, j), m in zip(pairs, matched)])
        r1 = cat([np.full(len(m), id2row[i], np.int64)
                  for (i, _), m in zip(pairs, matched)])
        r2 = cat([np.full(len(m), id2row[j], np.int64)
                  for (_, j), m in zip(pairs, matched)])
        xyz, valid, cos = triangulate_pairs(views, r1, r2, p1, p2)
        e1 = torch.linalg.vector_norm(views.select(r1).project(xyz) - p1,
                                      dim=-1)
        e2 = torch.linalg.vector_norm(views.select(r2).project(xyz) - p2,
                                      dim=-1)
        cos_th = float(np.cos(np.radians(min_tri_angle_deg)))
        ok = (valid & (cos < cos_th) & (e1 < max_reproj_px)
              & (e2 < max_reproj_px)).cpu().numpy()
        xyz = xyz.cpu().numpy()
        k0 = 0
        for (i, j), m in zip(pairs, matched):
            for k in np.nonzero(ok[k0:k0 + len(m)])[0]:
                a = (i, int(m[k, 0]))
                b = (j, int(m[k, 1]))
                uf.union(a, b)
                obs_xyz.setdefault(a, []).append(xyz[k0 + k])
                obs_xyz.setdefault(b, []).append(xyz[k0 + k])
            k0 += len(m)

    # 4. merge into tracks
    groups: Dict[Tuple[int, int], list] = {}
    for node in uf.parent:
        groups.setdefault(uf.find(node), []).append(node)

    points3d = {}
    pid = 0
    for nodes in groups.values():
        img_ids = sorted({n[0] for n in nodes})
        if len(img_ids) < min_track_length:
            continue
        all_xyz = np.concatenate([np.asarray(obs_xyz[n])
                                  for n in nodes if n in obs_xyz])
        p2ds = {}
        for (img_id, kp_id) in nodes:
            p2ds.setdefault(img_id, features[img_id]["keypoints"][kp_id])
        points3d[pid] = {"xyz": np.median(all_xyz, axis=0),
                         "image_ids": img_ids, "p2ds": p2ds}
        pid += 1
    return points3d
