"""Distance of a line map to a ground-truth point cloud: per-line inlier
ratios, the Hypersim protocol's length recall and precision at tau, and
track statistics; and the recall of reference lines by a line map.

Each line is sampled at ``n_samples`` points and each sample's distance
to the cloud comes from :func:`~limap_tpu_torch.ops.nn_distance.nn_min_dist`
(the CUDA kernel for a cloud on the GPU).  :class:`RefLineEvaluator`
reduces the sample-to-segment distances in chunks of samples, so the
[samples, lines, 3] grid is never built whole.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.nn_distance import nn_min_dist

DEFAULT_N_SAMPLES = 1000


def sample_points_on_segments(seg: Segments, n_samples: int) -> torch.Tensor:
    """Uniform samples [N, n_samples, 3] along each segment."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=seg.start.dtype,
                       device=seg.start.device)
    return seg.start[:, None, :] + t[None, :, None] \
        * (seg.end - seg.start)[:, None, :]


class PointCloudEvaluator:
    """Distance evaluation against a GT point cloud [M, 3]."""

    def __init__(self, points: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.points = torch.as_tensor(np.asarray(points, np.float32),
                                      device=self.device).contiguous()

    def ComputeDistPoint(self, p) -> float:
        """Distance of one point [3] to the cloud."""
        q = torch.as_tensor(np.asarray(p, np.float32).reshape(1, 3),
                            device=self.device)
        return float(nn_min_dist(q, self.points)[0])

    def ComputeDistsLine(self, seg: Segments,
                         n_samples: int = DEFAULT_N_SAMPLES) -> torch.Tensor:
        """[N, n_samples] sample distances of a batch of lines."""
        samples = sample_points_on_segments(seg, n_samples)
        d = nn_min_dist(samples.reshape(-1, 3).contiguous(), self.points)
        return d.reshape(samples.shape[:-1])

    def ComputeInlierRatio(self, seg: Segments, threshold: float,
                           n_samples: int = DEFAULT_N_SAMPLES) -> torch.Tensor:
        """Per-line fraction of samples within ``threshold``."""
        d = self.ComputeDistsLine(seg, n_samples)
        return torch.mean((d <= threshold).to(torch.float32), dim=1)

    def ComputeInlierRatioOneLine(self, line, threshold: float,
                                  n_samples: int = DEFAULT_N_SAMPLES) -> float:
        """The inlier ratio of one line [2, 3]."""
        return float(self.ComputeInlierRatio(
            _segments(line, self.device), threshold, n_samples)[0])


def _segments(lines, device) -> Segments:
    """Segments of lines [..., 2, 3] (numpy or torch) on ``device``."""
    t = torch.as_tensor(np.asarray(lines, np.float32).reshape(-1, 2, 3),
                        device=device)
    return Segments(t[:, 0], t[:, 1])


def point_segment_distance(points: torch.Tensor,
                           seg: Segments) -> torch.Tensor:
    """[P, N] distance of each point [P, 3] to each segment, the foot
    clamped to the segment (a zero-length segment's squared length is
    taken as 1e-12)."""
    d = seg.end - seg.start                                   # [N, 3]
    L2 = torch.sum(d * d, -1)
    disp = points[:, None, :] - seg.start[None]               # [P, N, 3]
    t = torch.sum(disp * d[None], -1) / torch.clamp(L2, min=1e-12)[None]
    t = torch.clamp(t, 0.0, 1.0)
    foot = seg.start[None] + t[..., None] * d[None]
    return torch.linalg.norm(points[:, None] - foot, dim=-1)


# (sample, line) pairs a chunk of RefLineEvaluator's reduction
REF_PAIR_BUDGET = 1 << 22


class RefLineEvaluator:
    """Recall of reference lines [R, 2, 3] by a line map."""

    def __init__(self, ref_lines, device=None):
        self.device = resolve_device(device)
        self.ref = _segments(ref_lines, self.device)

    def SumLength(self) -> float:
        return float(torch.sum(self.ref.length()))

    def ComputeRecallRef(self, lines, threshold: float,
                         n_samples: int = DEFAULT_N_SAMPLES) -> float:
        """Total reference length within ``threshold`` of the predicted
        lines [N, 2, 3]: each reference line's share of samples within
        it times its length."""
        pred = _segments(lines, self.device)
        N = pred.start.shape[0]
        samples = sample_points_on_segments(self.ref, n_samples).reshape(
            -1, 3)
        if N == 0 or samples.shape[0] == 0:
            return 0.0
        step = max(1, REF_PAIR_BUDGET // N)
        d = torch.cat([point_segment_distance(samples[i:i + step],
                                              pred).amin(1)
                       for i in range(0, samples.shape[0], step)])
        d = d.reshape(-1, n_samples)
        ratio = torch.mean((d <= threshold).to(torch.float32), dim=1)
        return float(torch.sum(ratio * self.ref.length()))


def report_error_to_gt(evaluator: PointCloudEvaluator, lines: np.ndarray,
                       thresholds: Sequence[float],
                       n_samples: int = DEFAULT_N_SAMPLES) -> Dict[str, Dict]:
    """Length recall = sum(length * inlier ratio); precision = % of lines
    with any inlier.  The distances are computed once for all taus."""
    lines = np.asarray(lines, np.float32).reshape(-1, 2, 3)
    t = torch.as_tensor(lines, device=evaluator.device)
    seg = Segments(t[:, 0], t[:, 1])
    lengths = seg.length()
    d = evaluator.ComputeDistsLine(seg, n_samples)
    out = {"recall": {}, "precision": {}}
    for tau in thresholds:
        ratios = torch.mean((d <= tau).to(torch.float32), dim=1)
        out["recall"][tau] = float(torch.sum(ratios * lengths))
        out["precision"][tau] = float(torch.mean(
            (ratios > 0).to(torch.float32))) * 100.0 if len(lines) else 0.0
    return out


def report_track_stats(linetracks, n_visible_views: int = 4) -> Dict:
    """Track count and support statistics."""
    counts = np.array([t.count_images() for t in linetracks])
    supports = np.array([t.count_lines() for t in linetracks])
    out = {"n_tracks": len(linetracks)}
    for nv in (2, 3, 4, 5, 6):
        out[f"n_tracks_nv{nv}"] = int((counts >= nv).sum())
    sel = counts >= n_visible_views
    out["avg_supporting_images"] = float(counts[sel].mean()) if sel.any() \
        else 0.0
    out["avg_supporting_lines"] = float(supports[sel].mean()) if sel.any() \
        else 0.0
    return out
