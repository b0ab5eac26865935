"""SfM model: 3D points and their visibility, visual-neighbour ranking
and robust scene ranges.

Per-image point counts, pairwise shared points, percentile
triangulation angles, neighbours ranked by IoU, Dice or overlap, and
percentile ranges with a stretch.  Host numpy, vectorized over the
(point, image pair) incidences; the ranking breaks ties by image order,
as a stable sort does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# (point, image pair) incidences evaluated at once
PAIR_BUDGET = 1 << 22


class SfmModel:
    def __init__(self):
        self.points: List[np.ndarray] = []         # [3] xyz
        self.tracks: List[List[int]] = []          # image indices per point
        self.reg_image_ids: List[int] = []         # index -> img_id
        self.centers: List[np.ndarray] = []        # per image camera center

    # ------------------------------------------------------------ build
    def add_image(self, center, img_id: Optional[int] = None) -> None:
        if img_id is None:
            img_id = len(self.reg_image_ids)
        self.reg_image_ids.append(int(img_id))
        self.centers.append(np.asarray(center, np.float64))

    def add_point(self, xyz, image_idx_list) -> None:
        """``image_idx_list`` holds indices into ``reg_image_ids``."""
        self.points.append(np.asarray(xyz, np.float64))
        self.tracks.append([int(i) for i in image_idx_list])

    @classmethod
    def from_imagecols_and_points(cls, imagecols, points3d: Dict[int, dict]):
        """points3d: {point_id: {"xyz": [3], "image_ids": [img ids]}}."""
        model = cls()
        img_ids = imagecols.get_img_ids()
        id2idx = {img_id: i for i, img_id in enumerate(img_ids)}
        for img_id in img_ids:
            model.add_image(imagecols.campose(img_id).center(), img_id)
        for _, rec in points3d.items():
            idxs = [id2idx[i] for i in rec["image_ids"] if i in id2idx]
            if idxs:
                model.add_point(rec["xyz"], idxs)
        return model

    # ------------------------------------------------------- statistics
    def num_images(self) -> int:
        return len(self.reg_image_ids)

    def _incidence(self):
        """(point index, image index) of every distinct observation."""
        if not self.tracks:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lens = np.asarray([len(t) for t in self.tracks], np.int64)
        pt = np.repeat(np.arange(len(self.tracks)), lens)
        img = np.concatenate([np.asarray(t, np.int64) for t in self.tracks])
        key = np.unique(pt * self.num_images() + img)
        return key // self.num_images(), key % self.num_images()

    def compute_num_points(self) -> np.ndarray:
        """Observations an image, each point counted once per listing."""
        num = np.zeros(self.num_images(), np.int64)
        for track in self.tracks:
            np.add.at(num, np.asarray(track, np.int64), 1)
        return num

    def _pairs(self):
        """Yield (point, image a, image b) of every point's distinct image
        pairs a < b, in chunks."""
        pt, img = self._incidence()
        starts = np.searchsorted(pt, np.arange(len(self.tracks) + 1))
        lens = np.diff(starts)
        n_pairs = lens * (lens - 1) // 2
        p0 = 0
        while p0 < len(lens):
            p1 = p0 + 1
            total = n_pairs[p0]
            while p1 < len(lens) and total + n_pairs[p1] <= PAIR_BUDGET:
                total += n_pairs[p1]
                p1 += 1
            ai, bi = np.triu_indices(int(lens[p0:p1].max()), 1)
            sel_pts = np.arange(p0, p1)
            # a point's pairs are those of its own length
            ok = bi[None, :] < lens[sel_pts, None]
            pp = np.broadcast_to(sel_pts[:, None], ok.shape)[ok]
            aa = np.broadcast_to(ai[None], ok.shape)[ok]
            bb = np.broadcast_to(bi[None], ok.shape)[ok]
            yield pp, img[starts[pp] + aa], img[starts[pp] + bb]
            p0 = p1

    def compute_shared_points(self) -> np.ndarray:
        """Dense [I, I] pairwise shared-point counts."""
        I = self.num_images()
        shared = np.zeros((I, I), np.int64)
        for _, a, b in self._pairs():
            np.add.at(shared, (a, b), 1)
        return shared + shared.T

    def compute_triangulation_angles(self,
                                     percentile: float = 75.0) -> np.ndarray:
        """[I, I] percentile triangulation angle (radians) over the
        shared points of each pair, linear between order statistics."""
        I = self.num_images()
        out = np.zeros((I, I))
        if not self.tracks:
            return out
        centers = np.asarray(self.centers)
        pts = np.asarray(self.points)
        keys, angs = [], []
        for p, a, b in self._pairs():
            ra = centers[a] - pts[p]
            rb = centers[b] - pts[p]
            ra = ra / np.maximum(np.linalg.norm(ra, axis=1), 1e-12)[:, None]
            rb = rb / np.maximum(np.linalg.norm(rb, axis=1), 1e-12)[:, None]
            cos = np.einsum("ij,ij->i", ra, rb)
            keys.append(a * I + b)
            angs.append(np.arccos(np.clip(cos, -1, 1)))
        if not keys:
            return out
        key = np.concatenate(keys)
        ang = np.concatenate(angs)
        order = np.lexsort((ang, key))
        key, ang = key[order], ang[order]
        uk, start, count = np.unique(key, return_index=True,
                                     return_counts=True)
        # numpy's "linear" percentile and its two-sided lerp
        pos = (count - 1) * (percentile / 100.0)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, count - 1)
        t = pos - lo
        va, vb = ang[start + lo], ang[start + hi]
        d = vb - va
        v = np.where(t >= 0.5, vb - d * (1 - t), va + d * t)
        out[uk // I, uk % I] = v
        out[uk % I, uk // I] = v
        return out

    # -------------------------------------------------------- neighbors
    def _ranked_neighbors(self, metric: str, n_neighbors: int,
                          min_triangulation_angle: float
                          ) -> Dict[int, List[int]]:
        shared = self.compute_shared_points()
        num = self.compute_num_points()
        tri_ang = self.compute_triangulation_angles()
        min_rad = np.deg2rad(min_triangulation_angle)

        inter = shared.astype(np.float64)
        union = num[:, None] + num[None, :] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            if metric == "overlap":
                score = inter
            elif metric == "iou":
                score = np.where(union > 0, inter / union, 0.0)
            elif metric == "dice":
                score = np.where(union + inter > 0,
                                 2 * inter / (union + inter), 0.0)
            else:
                raise ValueError(f"unknown neighbor metric {metric!r}")
        valid = (shared > 0) & (tri_ang >= min_rad)
        score = np.where(valid, score, -1.0)
        np.fill_diagonal(score, -1.0)

        order = np.argsort(-score, axis=1, kind="stable")[:, :n_neighbors]
        keep = np.take_along_axis(score, order, 1) > 0
        ids = np.asarray(self.reg_image_ids)
        return {int(ids[i]): [int(ids[j]) for j in order[i][keep[i]]]
                for i in range(self.num_images())}

    def GetMaxOverlapImages(self, n, min_triangulation_angle=1.0):
        return self._ranked_neighbors("overlap", n, min_triangulation_angle)

    def GetMaxIoUImages(self, n, min_triangulation_angle=1.0):
        return self._ranked_neighbors("iou", n, min_triangulation_angle)

    def GetMaxDiceCoeffImages(self, n, min_triangulation_angle=1.0):
        return self._ranked_neighbors("dice", n, min_triangulation_angle)

    # ----------------------------------------------------------- ranges
    def ComputeRanges(self, range_robust=(0.05, 0.95), kstretch=1.25):
        """Per-axis quantile range, stretched about its centre."""
        if not self.points:
            return (np.full(3, -1e9), np.full(3, 1e9))
        pts = np.asarray(self.points)
        lo = np.quantile(pts, range_robust[0], axis=0)
        hi = np.quantile(pts, range_robust[1], axis=0)
        center = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo) * kstretch
        return (center - half, center + half)


def compute_neighbors(model: SfmModel, n_neighbors: int,
                      min_triangulation_angle: float = 1.0,
                      neighbor_type: str = "dice") -> Dict[int, List[int]]:
    """The ``n_neighbors`` best images of each image by
    ``neighbor_type`` (``iou``, ``overlap`` or ``dice``)."""
    if neighbor_type == "iou":
        return model.GetMaxIoUImages(n_neighbors, min_triangulation_angle)
    if neighbor_type == "overlap":
        return model.GetMaxOverlapImages(n_neighbors, min_triangulation_angle)
    if neighbor_type == "dice":
        return model.GetMaxDiceCoeffImages(n_neighbors,
                                           min_triangulation_angle)
    raise NotImplementedError(neighbor_type)


def compute_metainfos(cfg: dict, model: SfmModel, n_neighbors: int = 20):
    """(neighbours, ranges) of the model under the ``sfm`` config."""
    neighbors = compute_neighbors(
        model, n_neighbors,
        min_triangulation_angle=cfg.get("min_triangulation_angle", 1.0),
        neighbor_type=cfg.get("neighbor_type", "dice"))
    rcfg = cfg.get("ranges", {})
    ranges = model.ComputeRanges(
        rcfg.get("range_robust", (0.05, 0.95)), rcfg.get("k_stretch", 1.25))
    return neighbors, ranges
