"""Progressive-X-style multi-VP detection.

With no spatial coherence and a Tanimoto similarity of 1 (the settings
the reference calls pyprogressivex with), Progressive-X reduces to
proposals and greedy model growth with length-weighted sampling: here a
length-weighted resample of each image's lines, then kernel J on the
resampled lines (every image in one launch), then every original line
labelled by its nearest found VP within the inlier threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.vplib.jlinkage import (VPResult, detect_vps,
                                            draw_hypotheses,
                                            segment_tensors, vp_line_distance)


@dataclasses.dataclass(frozen=True)
class ProgressiveXConfig:
    """Progressive-X's options and the kernel's."""

    min_length: float = 20.0
    inlier_threshold: float = 1.0
    n_hypotheses: int = 2000
    max_num_vps: int = 8
    min_num_supports: int = 5

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ProgressiveXConfig":
        if d is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class ProgressiveX:
    def __init__(self, cfg: ProgressiveXConfig = ProgressiveXConfig(),
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def get_module_name(self):
        return "progressive-x"

    def compute_vp_labels(self, segs: np.ndarray) -> VPResult:
        return self.detect_vp_all_images({0: segs})[0]

    def detect_vp_all_images(self, all_2d_segs: Dict[int, np.ndarray],
                             camviews=None) -> Dict[int, VPResult]:
        cfg = self.cfg
        out, ids, orig, resampled, ia, ib = {}, [], [], [], [], []
        for img_id, segs in all_2d_segs.items():
            n = len(segs)
            segs = np.asarray(segs, np.float64)
            lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1) \
                if n else np.zeros(0)
            w = np.where(lengths >= cfg.min_length, lengths, 0.0)
            if n < 10 or w.sum() <= 0:
                out[img_id] = VPResult(np.full(n, -1), np.zeros((0, 3)))
                continue
            t = segment_tensors(segs, cfg.min_length, self.device)
            # length-weighted resample of the lines
            rng = np.random.default_rng(int(torch.randint(
                0, 2 ** 31 - 1, (), generator=self.gen)))
            idx = torch.as_tensor(rng.choice(n, size=n, p=w / w.sum()),
                                  device=self.device)
            ids.append(img_id)
            orig.append(t)
            resampled.append(tuple(x[idx] for x in t))
            a, b = draw_hypotheses(self.gen, n, cfg.n_hypotheses)
            ia.append(a)
            ib.append(b)
        if ids:
            res = detect_vps(resampled, torch.stack(ia), torch.stack(ib),
                             cfg.max_num_vps, cfg.min_num_supports,
                             cfg.inlier_threshold, self.device)
            for img_id, (_, mids, starts, valid), (_, vps) in zip(ids, orig,
                                                                  res):
                n = mids.shape[0]
                labels = np.full(n, -1, np.int64)
                if len(vps):
                    dist = vp_line_distance(
                        torch.as_tensor(vps, dtype=torch.float32,
                                        device=self.device), mids, starts)
                    best = torch.argmin(dist, dim=0)
                    ok = (dist[best, torch.arange(n, device=self.device)]
                          <= cfg.inlier_threshold) & valid
                    ok, best = ok.cpu().numpy(), best.cpu().numpy()
                    labels[ok] = best[ok]
                out[img_id] = VPResult(labels, vps)
        return {img_id: out[img_id] for img_id in all_2d_segs}
