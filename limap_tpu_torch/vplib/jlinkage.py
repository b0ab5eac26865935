"""Vanishing point detection: batched sequential multi-model RANSAC.

Hypotheses are the intersections of random pairs of lines; every
(hypothesis, line) consistency test of an image is one ``[H, N]``
evaluation and the clusters come from sequential best-model selection
with an eigenvector refit.  :func:`detect_vps` runs every image in one
call of kernel J (``ops/vp_detect.py``); the hypotheses' line pairs come
from an explicit CPU ``torch.Generator`` and are passed in, so the card
and the CPU test the same hypotheses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops import vp_detect
from limap_tpu_torch.ops.vp_detect import vp_line_distance

__all__ = ["JLinkageConfig", "VPResult", "vp_line_distance", "JLinkage",
           "draw_hypotheses", "detect_vps"]


@dataclasses.dataclass(frozen=True)
class JLinkageConfig:
    """The VP detector's options (the reference's BaseVPDetectorConfig
    defaults)."""

    min_length: float = 40.0
    inlier_threshold: float = 1.0   # pixels
    min_num_supports: int = 10
    n_hypotheses: int = 512
    max_num_vps: int = 8

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "JLinkageConfig":
        if d is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class VPResult:
    """Per-image VP labels of the lines and the VPs."""

    def __init__(self, labels, vps):
        self.labels = np.asarray(labels, np.int64)
        self.vps = np.asarray(vps, np.float64).reshape(-1, 3)

    def count_lines(self):
        return len(self.labels)

    def count_vps(self):
        return len(self.vps)

    def GetVPLabel(self, line_id):
        return int(self.labels[line_id])

    def HasVP(self, line_id):
        return self.labels[line_id] >= 0

    def GetVP(self, line_id):
        return self.vps[self.labels[line_id]]

    def GetVPbyCluster(self, vp_id):
        return self.vps[vp_id]

    def as_dict(self):
        return {"labels": self.labels.tolist(), "vps": self.vps.tolist()}

    @classmethod
    def from_dict(cls, d):
        return cls(d["labels"], d["vps"])


def draw_hypotheses(gen: torch.Generator, n: int, n_hyp: int):
    """Line pairs (ia, ib) [n_hyp] int32 of one image of ``n`` lines:
    uniform draws, ``ib`` moved to the next line where it equals
    ``ia``."""
    ia = torch.randint(0, n, (n_hyp,), generator=gen)
    ib = torch.randint(0, n, (n_hyp,), generator=gen)
    ib = torch.where(ib == ia, (ib + 1) % n, ib)
    return ia.to(torch.int32), ib.to(torch.int32)


def segment_tensors(segs: np.ndarray, min_length: float, device):
    """(coords [N, 3], mids [N, 2], starts [N, 2], valid [N]) of one
    image's segments (N, >= 4) on ``device``: float32 endpoints,
    ``valid`` where the float64 length reaches ``min_length``."""
    segs = np.asarray(segs, np.float64).reshape(-1, 4) if len(segs) \
        else np.zeros((0, 4))
    seg = Segments(torch.as_tensor(segs[:, :2], dtype=torch.float32,
                                   device=device),
                   torch.as_tensor(segs[:, 2:4], dtype=torch.float32,
                                   device=device))
    lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1)
    valid = torch.as_tensor(lengths >= min_length, device=device)
    return seg.coords(), seg.midpoint(), seg.start, valid


def detect_vps(per_image: List[tuple], ia, ib, max_vps: int,
               min_supports: int, inlier_th: float, device):
    """Kernel J over images given as (coords, mids, starts, valid) with
    their hypotheses ia / ib [I, H]: a list of (labels [N] int64 numpy,
    vps [n_found, 3] float64 numpy)."""
    if not per_image:
        return []
    n = [p[0].shape[0] for p in per_image]
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(n)]),
                              dtype=torch.int64, device=device)
    cat = [torch.cat([p[k] for p in per_image]) for k in range(4)]
    labels, vps, n_found = vp_detect.detect(
        *cat, offsets, ia.to(device), ib.to(device), max_vps, min_supports,
        float(inlier_th))
    labels = labels.cpu().numpy().astype(np.int64)
    vps = vps.cpu().numpy().astype(np.float64)
    n_found = n_found.cpu().numpy()
    off = np.concatenate([[0], np.cumsum(n)])
    return [(labels[off[i]:off[i + 1]], vps[i, :n_found[i]])
            for i in range(len(per_image))]


class JLinkage:
    """VP detector with the reference's config surface; ``seed`` seeds
    the hypotheses' generator, drawn image after image."""

    def __init__(self, cfg: JLinkageConfig = JLinkageConfig(), seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def get_module_name(self):
        return "jlinkage"

    def _too_few(self, n: int) -> bool:
        return n < max(2 * self.cfg.min_num_supports, 20) // 2

    def compute_vp_labels(self, segs: np.ndarray) -> VPResult:
        """segs: (N, >= 4) array -> VPResult."""
        return self.detect_vp_all_images({0: segs})[0]

    def detect_vp_all_images(self, all_2d_segs: Dict[int, np.ndarray],
                             camviews=None) -> Dict[int, VPResult]:
        """Every image with enough lines in one launch of kernel J; the
        others get no VP."""
        cfg = self.cfg
        out, ids, per_image, ia, ib = {}, [], [], [], []
        for img_id, segs in all_2d_segs.items():
            n = len(segs)
            if self._too_few(n):
                out[img_id] = VPResult(np.full(n, -1), np.zeros((0, 3)))
                continue
            ids.append(img_id)
            per_image.append(segment_tensors(segs, cfg.min_length,
                                             self.device))
            a, b = draw_hypotheses(self.gen, n, cfg.n_hypotheses)
            ia.append(a)
            ib.append(b)
        if ids:
            res = detect_vps(per_image, torch.stack(ia), torch.stack(ib),
                             cfg.max_num_vps, cfg.min_num_supports,
                             cfg.inlier_threshold, self.device)
            for img_id, (labels, vps) in zip(ids, res):
                out[img_id] = VPResult(labels, vps)
        return {img_id: out[img_id] for img_id in all_2d_segs}
