"""Multi-view VP tracks: per-image VPs clustered into world directions,
with line tracks as anchors (host numpy)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from limap_tpu_torch.ops.connected_components import union_find_numpy
from limap_tpu_torch.vplib.jlinkage import VPResult


class VPTrack:
    """World direction + supporting (img_id, vp_id) nodes."""

    def __init__(self, direction=None, supports=None):
        self.direction = (np.zeros(3) if direction is None
                          else np.asarray(direction, np.float64))
        self.supports: List[Tuple[int, int]] = list(supports or [])

    def length(self):
        return len(self.supports)

    def as_dict(self):
        return {"direction": self.direction.tolist(),
                "supports": list(self.supports)}

    @classmethod
    def from_dict(cls, d):
        return cls(d["direction"], [tuple(s) for s in d["supports"]])


def merge_vptracks_by_direction(vptracks: List[VPTrack],
                                th_angle_merge: float = 1.0
                                ) -> List[VPTrack]:
    """Merge tracks whose directions agree within ``th_angle_merge``
    degrees, each direction the support-weighted mean of its members."""
    n = len(vptracks)
    if n <= 1:
        return vptracks
    dirs = np.stack([t.direction / (np.linalg.norm(t.direction) + 1e-12)
                     for t in vptracks])
    cos = np.abs(dirs @ dirs.T)
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    edges = np.argwhere(np.triu(ang <= th_angle_merge, k=1))
    labels = union_find_numpy(n, edges)
    groups: Dict[int, List[int]] = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    out = []
    for members in groups.values():
        supports = []
        vecs = []
        w = []
        for m in members:
            supports += vptracks[m].supports
            vecs.append(dirs[m] * (1 if dirs[m] @ dirs[members[0]] >= 0
                                   else -1))
            w.append(vptracks[m].length())
        direction = np.average(np.stack(vecs), axis=0, weights=w)
        direction /= np.linalg.norm(direction) + 1e-12
        out.append(VPTrack(direction, supports))
    return out


@dataclasses.dataclass(frozen=True)
class GlobalVPTrackConstructorConfig:
    min_common_lines: int = 3
    th_angle_verify: float = 10.0  # degrees
    min_track_length: int = 5

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class GlobalVPTrackConstructor:
    """Cluster per-image VPs into world-direction tracks using line
    tracks as anchors.

    Two per-image VPs (i, a) and (j, b) connect when they share >=
    min_common_lines line tracks and their unprojected world directions
    agree within th_angle_verify.
    """

    def __init__(self, cfg: GlobalVPTrackConstructorConfig =
                 GlobalVPTrackConstructorConfig()):
        self.cfg = cfg
        self.vpresults: Dict[int, VPResult] = {}

    def Init(self, vpresults: Dict[int, VPResult]) -> None:
        self.vpresults = dict(vpresults)

    def cluster_line_tracks(self, linetracks, imagecols) -> List[VPTrack]:
        # node index per (img_id, vp_id)
        nodes = []
        node_of = {}
        for img_id, res in self.vpresults.items():
            for vp_id in range(res.count_vps()):
                node_of[(img_id, vp_id)] = len(nodes)
                nodes.append((img_id, vp_id))
        if not nodes:
            return []

        # world direction of every per-image VP
        dirs = np.zeros((len(nodes), 3))
        for (img_id, vp_id), ni in node_of.items():
            view = imagecols.camview(img_id)
            dirs[ni] = view.get_direction_from_vp(
                self.vpresults[img_id].GetVPbyCluster(vp_id))

        # count co-supporting line tracks per VP pair
        pair_counts: Dict[Tuple[int, int], int] = {}
        for track in linetracks:
            vp_nodes = set()
            for img_id, line_id in zip(track.image_id_list,
                                       track.line_id_list):
                res = self.vpresults.get(img_id)
                if res is None or line_id >= res.count_lines():
                    continue
                if res.HasVP(line_id):
                    vp_nodes.add(node_of[(img_id, res.GetVPLabel(line_id))])
            vp_nodes = sorted(vp_nodes)
            for i in range(len(vp_nodes)):
                for j in range(i + 1, len(vp_nodes)):
                    key = (vp_nodes[i], vp_nodes[j])
                    pair_counts[key] = pair_counts.get(key, 0) + 1

        # pose-verified edges
        edges = []
        for (a, b), cnt in pair_counts.items():
            if cnt < self.cfg.min_common_lines:
                continue
            cos = abs(float(dirs[a] @ dirs[b]))
            ang = np.degrees(np.arccos(min(cos, 1.0)))
            if ang <= self.cfg.th_angle_verify:
                edges.append((a, b))

        labels = union_find_numpy(len(nodes), np.asarray(edges).reshape(
            -1, 2))
        groups: Dict[int, List[int]] = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(i)

        out = []
        for members in groups.values():
            if len(members) < self.cfg.min_track_length:
                continue
            ref = dirs[members[0]]
            vecs = [dirs[m] * (1 if dirs[m] @ ref >= 0 else -1)
                    for m in members]
            direction = np.mean(np.stack(vecs), axis=0)
            direction /= np.linalg.norm(direction) + 1e-12
            out.append(VPTrack(direction, [nodes[m] for m in members]))
        return out

    # reference-style alias
    ClusterLineTracks = cluster_line_tracks
