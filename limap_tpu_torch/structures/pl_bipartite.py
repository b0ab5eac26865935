"""Point-line bipartite structures (2D and 3D) and junctions.

Adjacency between points (keypoints, point tracks) and lines, with
keypoints attached to the lines within a pixel distance, line-line
intersection junctions, and the 3D instantiation over point and line
tracks.  The keypoint attachment is one [P, L] point-segment distance on
the bipartite's device, the intersection test one [n, n] evaluation; the
adjacency itself stays in host dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.util import dataclass_from_dict


@dataclasses.dataclass
class Point2d:
    """A keypoint and the id of its 3D point (-1: none)."""

    p: np.ndarray
    point3D_id: int = -1


@dataclasses.dataclass
class Junction:
    """A point with the ids of its incident lines."""

    p: object
    line_ids: List[int]


@dataclasses.dataclass(frozen=True)
class PL_Bipartite2dConfig:
    threshold_keypoints: float = 2.0
    threshold_intersection: float = 2.0
    threshold_merge_junctions: float = 2.0

    @classmethod
    def from_dict(cls, d):
        return dataclass_from_dict(cls, d)


class PL_BipartiteBase:
    """Points and lines by id, and the edges between them."""

    def __init__(self):
        self.points_: Dict[int, object] = {}
        self.lines_: Dict[int, object] = {}
        self.np2l: Dict[int, List[int]] = {}  # point -> lines
        self.nl2p: Dict[int, List[int]] = {}  # line -> points

    def count_points(self):
        return len(self.points_)

    def count_lines(self):
        return len(self.lines_)

    def count_edges(self):
        return sum(len(v) for v in self.np2l.values())

    def add_point(self, p, point_id: int, neighbors: List[int]):
        self.points_[point_id] = p
        self.np2l[point_id] = list(neighbors)
        for l in neighbors:
            self.nl2p.setdefault(l, []).append(point_id)

    def add_line(self, line, line_id: int):
        self.lines_[line_id] = line
        self.nl2p.setdefault(line_id, [])

    def point(self, point_id):
        return self.points_[point_id]

    def line(self, line_id):
        return self.lines_[line_id]

    def get_point_ids(self):
        return sorted(self.points_.keys())

    def get_line_ids(self):
        return sorted(self.lines_.keys())

    def neighbor_points(self, line_id) -> List[int]:
        return self.nl2p.get(line_id, [])

    def neighbor_lines(self, point_id) -> List[int]:
        return self.np2l.get(point_id, [])

    def pdegree(self, point_id):
        return len(self.np2l.get(point_id, []))

    def ldegree(self, line_id):
        return len(self.nl2p.get(line_id, []))

    def get_default_new_point_id(self):
        return max(self.points_.keys(), default=-1) + 1


def segment_point_distance(seg: Segments, p: torch.Tensor) -> torch.Tensor:
    """Distance of point(s) ``p`` to segment(s), the foot clamped to the
    endpoints (broadcast over leading dims)."""
    d = seg.direction()
    t = torch.sum((p - seg.start) * d, dim=-1)
    t = torch.minimum(torch.clamp(t, min=0.0), seg.length())
    foot = seg.start + t[..., None] * d
    return torch.linalg.vector_norm(p - foot, dim=-1)


class PL_Bipartite2d(PL_BipartiteBase):
    """Keypoints and 2D segments of one image, on ``device``."""

    def __init__(self, config: PL_Bipartite2dConfig = PL_Bipartite2dConfig(),
                 device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)

    def init_lines(self, segs: np.ndarray):
        """segs: (N, >=4); line ids are row indices."""
        segs = np.asarray(segs, np.float64)
        for i, s in enumerate(segs):
            self.add_line(s[:4].copy(), i)

    def _line_segments(self) -> Tuple[Segments, List[int]]:
        ids = self.get_line_ids()
        arr = np.stack([self.lines_[i] for i in ids]) if ids else \
            np.zeros((0, 4))
        arr = torch.as_tensor(arr, dtype=torch.float32, device=self.device)
        return Segments(arr[:, :2], arr[:, 2:4]), ids

    def add_keypoints_with_point3D_ids(self, points: np.ndarray,
                                       point3D_ids, ids=None):
        """Attach each keypoint to the lines within
        ``threshold_keypoints`` of it, all points in one distance
        matrix."""
        points = np.asarray(points, np.float64).reshape(-1, 2)
        seg, line_ids = self._line_segments()
        if len(points) == 0:
            return
        if seg.start.shape[0]:
            q = torch.as_tensor(points, dtype=torch.float32,
                                device=self.device)[:, None, :]
            close = (segment_point_distance(seg, q)
                     <= self.config.threshold_keypoints).cpu().numpy()
        else:
            close = np.zeros((len(points), 0), bool)
        for i, (p, pid3) in enumerate(zip(points, point3D_ids)):
            point_id = (ids[i] if ids is not None
                        else self.get_default_new_point_id())
            neighbors = [line_ids[j] for j in np.nonzero(close[i])[0]]
            self.add_point(Point2d(p, int(pid3)), point_id, neighbors)

    def compute_intersections(self) -> List[Junction]:
        """Junctions where two lines meet within ``threshold_intersection``
        of both segments' extents: pairs i < j in row-major order, then
        merged greedily in that order."""
        seg, line_ids = self._line_segments()
        n = seg.start.shape[0]
        if n < 2:
            return []
        th = self.config.threshold_intersection
        coords = seg.coords()
        ph = torch.cross(coords[:, None].expand(n, n, 3),
                         coords[None, :].expand(n, n, 3), dim=-1)
        z = ph[..., 2]
        ok = torch.abs(z) >= 1e-9
        p = ph[..., :2] / torch.where(ok, z, torch.ones_like(z))[..., None]
        d = seg.end - seg.start
        L = torch.linalg.vector_norm(d, dim=-1)
        L2 = torch.clamp(L * L, min=1e-12)

        def within(k_axis):
            s = seg.start[:, None] if k_axis == 0 else seg.start[None, :]
            dk = d[:, None] if k_axis == 0 else d[None, :]
            Lk = L[:, None] if k_axis == 0 else L[None, :]
            L2k = L2[:, None] if k_axis == 0 else L2[None, :]
            t = torch.sum((p - s) * dk, dim=-1) / L2k
            return (t * Lk >= -th) & ((t - 1) * Lk <= th)

        ok = ok & within(0) & within(1) & torch.triu(
            torch.ones((n, n), dtype=torch.bool, device=ok.device), 1)
        pairs = torch.nonzero(ok).cpu().numpy()          # row-major
        pts = p[ok].cpu().numpy()
        juncs = [Junction(pt, [line_ids[i], line_ids[j]])
                 for (i, j), pt in zip(pairs, pts)]
        return self._merge_junctions(juncs)

    def _merge_junctions(self, juncs: List[Junction]) -> List[Junction]:
        th = self.config.threshold_merge_junctions
        merged: List[Junction] = []
        for j in juncs:
            hit = None
            for m in merged:
                if np.linalg.norm(np.asarray(m.p) - np.asarray(j.p)) <= th:
                    hit = m
                    break
            if hit is None:
                merged.append(Junction(np.asarray(j.p), list(j.line_ids)))
            else:
                hit.line_ids = sorted(set(hit.line_ids) | set(j.line_ids))
        return merged


class PL_Bipartite3d(PL_BipartiteBase):
    """Point tracks and line tracks by id."""

    def get_point_cloud(self) -> np.ndarray:
        return np.stack([np.asarray(p.p) for p in
                         self.points_.values()]) if self.points_ else \
            np.zeros((0, 3))

    def get_line_cloud(self) -> np.ndarray:
        return np.stack([np.asarray(t.line) for t in
                         self.lines_.values()]) if self.lines_ else \
            np.zeros((0, 2, 3))


@dataclasses.dataclass
class PointTrack:
    """A 3D point and its observations."""

    p: np.ndarray
    image_id_list: List[int] = dataclasses.field(default_factory=list)
    p2d_id_list: List[int] = dataclasses.field(default_factory=list)
    p2d_list: List[np.ndarray] = dataclasses.field(default_factory=list)

    def count_images(self):
        return len(self.image_id_list)


def compute_2d_bipartites_from_points(
        points3d: Dict[int, dict], points2d: Dict[int, np.ndarray],
        all_2d_segs: Dict[int, np.ndarray],
        cfg: PL_Bipartite2dConfig = PL_Bipartite2dConfig(),
        device=None):
    """Per-image 2D bipartites and the 3D point map.

    points2d: {img_id: (P, 3) array of x, y, point3D_id}.
    Returns (all_bpt2ds {img_id: PL_Bipartite2d}, sfm_points {pid: xyz}).
    """
    device = resolve_device(device)
    all_bpt2ds = {}
    for img_id, segs in all_2d_segs.items():
        bpt = PL_Bipartite2d(cfg, device=device)
        bpt.init_lines(np.asarray(segs))
        kps = points2d.get(img_id)
        if kps is not None and len(kps):
            sel = kps[:, 2] >= 0
            bpt.add_keypoints_with_point3D_ids(kps[sel, :2],
                                               kps[sel, 2].astype(np.int64))
        all_bpt2ds[img_id] = bpt
    sfm_points = {int(pid): np.asarray(rec["xyz"])
                  for pid, rec in points3d.items()}
    return all_bpt2ds, sfm_points
