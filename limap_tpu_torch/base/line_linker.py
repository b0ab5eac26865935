"""Line linkers: thresholded connection tests and exp-decay scores over
broadcasting :class:`Segments`."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.util import dataclass_from_dict


def expscore(val, sigma):
    """exp(-(val/sigma)^2 / 2)."""
    return torch.exp(-((val / sigma) ** 2) / 2.0)


def _multiplier(score_th: float) -> float:
    """exp(-(v/sigma)^2/2) >= th  <=>  v <= sigma/multiplier."""
    return 1.0 / math.sqrt(-math.log(score_th) * 2.0)


@dataclasses.dataclass(frozen=True)
class LineLinker2dConfig:
    score_th: float = 0.5
    th_angle: float = 8.0
    use_angle: bool = True
    th_overlap: float = 0.1
    use_overlap: bool = True
    th_smartoverlap: float = 0.2
    th_smartangle: float = 1.0
    use_smartangle: bool = True
    th_perp: float = 5.0       # pixels
    use_perp: bool = True
    th_innerseg: float = 5.0   # pixels
    use_innerseg: bool = False

    @property
    def multiplier(self) -> float:
        return _multiplier(self.score_th)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LineLinker2dConfig":
        return dataclass_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class LineLinker3dConfig:
    score_th: float = 0.5
    th_angle: float = 10.0
    use_angle: bool = True
    th_overlap: float = 0.01
    use_overlap: bool = True
    th_smartoverlap: float = 0.1
    th_smartangle: float = 1.0
    use_smartangle: bool = True
    th_perp: float = 0.02
    use_perp: bool = False
    th_innerseg: float = 0.02
    use_innerseg: bool = True
    th_scaleinv: float = 0.01
    use_scaleinv: bool = False

    @property
    def multiplier(self) -> float:
        return _multiplier(self.score_th)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LineLinker3dConfig":
        return dataclass_from_dict(cls, d)

    def to_shared_parent_scoring(self) -> "LineLinker3dConfig":
        return dataclasses.replace(self, use_angle=True, use_overlap=False,
                                   use_perp=False, use_innerseg=False,
                                   use_scaleinv=True)

    def to_spatial_merging(self) -> "LineLinker3dConfig":
        return dataclasses.replace(self, use_angle=True, use_overlap=True,
                                   use_perp=False, use_innerseg=True,
                                   use_scaleinv=False)

    def to_avgtest_merging(self) -> "LineLinker3dConfig":
        return dataclasses.replace(self, use_angle=True, use_overlap=False,
                                   use_perp=True, use_innerseg=False,
                                   use_scaleinv=False)


def _gated(score, score_th):
    """Zero the scores below the threshold."""
    return torch.where(score < score_th, torch.zeros_like(score), score)


def _smartangle_score(l1, l2, cfg):
    """Angle score with an overlap-adaptive sigma."""
    ang = ld.angle(l1, l2)
    overlap = ld.compute_bioverlap(l1, l2)
    ratio = torch.clamp((cfg.th_smartoverlap - overlap)
                        / (cfg.th_smartoverlap - cfg.th_overlap), max=1.0)
    th_adapt = cfg.th_angle - ratio * (cfg.th_angle - cfg.th_smartangle)
    th = torch.where(overlap < cfg.th_smartoverlap, th_adapt,
                     torch.full_like(th_adapt, cfg.th_angle))
    return _gated(expscore(ang, th * cfg.multiplier), cfg.score_th)


def _min_uncertainty(l1: Segments, l2: Segments):
    if l1.uncertainty is None or l2.uncertainty is None:
        return 1.0
    return torch.minimum(l1.uncertainty, l2.uncertainty)


def _ones(l1: Segments, l2: Segments, dtype):
    shape = torch.broadcast_shapes(l1.start.shape[:-1], l2.start.shape[:-1])
    return torch.ones(shape, dtype=dtype, device=l1.start.device)


def _overlap_indicator(l1, l2, th):
    return (ld.compute_bioverlap(l1, l2) > th).to(l1.start.dtype)


def score_2d(l1: Segments, l2: Segments, cfg: LineLinker2dConfig):
    """Joint 2D linker score, broadcasting."""
    score = _ones(l1, l2, l1.start.dtype)
    if cfg.use_angle:
        s = _gated(expscore(ld.angle(l1, l2),
                            cfg.th_angle * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    if cfg.use_overlap:
        score = torch.minimum(score, _overlap_indicator(l1, l2,
                                                        cfg.th_overlap))
    if cfg.use_angle and cfg.use_overlap and cfg.use_smartangle:
        score = torch.minimum(score, _smartangle_score(l1, l2, cfg))
    if cfg.use_perp:
        s = _gated(expscore(ld.dist_endpoints_perpendicular(l1, l2),
                            cfg.th_perp * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    if cfg.use_innerseg:
        s = _gated(expscore(ld.dist_innerseg(l1, l2),
                            cfg.th_innerseg * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    return score


def check_2d(l1: Segments, l2: Segments, cfg: LineLinker2dConfig):
    """Joint 2D connection test, broadcasting.  The angle check uses the
    raw threshold, not the gated score, so this is not ``score_2d > 0``."""
    ok = _ones(l1, l2, torch.bool)
    if cfg.use_angle:
        ok = ok & (ld.angle(l1, l2) <= cfg.th_angle)
    if cfg.use_overlap:
        ok = ok & (ld.compute_bioverlap(l1, l2) > cfg.th_overlap)
    if cfg.use_angle and cfg.use_overlap and cfg.use_smartangle:
        ok = ok & (_smartangle_score(l1, l2, cfg) >= cfg.score_th)
    if cfg.use_perp:
        s = expscore(ld.dist_endpoints_perpendicular(l1, l2),
                     cfg.th_perp * cfg.multiplier)
        ok = ok & (s >= cfg.score_th)
    if cfg.use_innerseg:
        s = expscore(ld.dist_innerseg(l1, l2),
                     cfg.th_innerseg * cfg.multiplier)
        ok = ok & (s >= cfg.score_th)
    return ok


def score_3d(l1: Segments, l2: Segments, cfg: LineLinker3dConfig):
    """Joint 3D linker score, broadcasting; the perp/innerseg sigmas
    scale with min(uncertainty)."""
    score = _ones(l1, l2, l1.start.dtype)
    if cfg.use_angle:
        s = _gated(expscore(ld.angle(l1, l2),
                            cfg.th_angle * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    if cfg.use_overlap:
        score = torch.minimum(score, _overlap_indicator(l1, l2,
                                                        cfg.th_overlap))
    if cfg.use_angle and cfg.use_overlap and cfg.use_smartangle:
        score = torch.minimum(score, _smartangle_score(l1, l2, cfg))
    if cfg.use_perp:
        u = _min_uncertainty(l1, l2)
        s = _gated(expscore(ld.dist_endpoints_perpendicular(l1, l2),
                            cfg.th_perp * u * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    if cfg.use_innerseg:
        u = _min_uncertainty(l1, l2)
        s = _gated(expscore(ld.dist_innerseg(l1, l2),
                            cfg.th_innerseg * u * cfg.multiplier),
                   cfg.score_th)
        score = torch.minimum(score, s)
    if cfg.use_scaleinv:
        s = _gated(expscore(ld.dist_endpoints_scaleinv_oneway(l1, l2),
                            cfg.th_scaleinv * cfg.multiplier), cfg.score_th)
        score = torch.minimum(score, s)
    return score


def check_3d(l1: Segments, l2: Segments, cfg: LineLinker3dConfig):
    """Joint 3D connection test, broadcasting."""
    ok = _ones(l1, l2, torch.bool)
    if cfg.use_angle:
        ok = ok & (ld.angle(l1, l2) <= cfg.th_angle)
    if cfg.use_overlap:
        ok = ok & (ld.compute_bioverlap(l1, l2) > cfg.th_overlap)
    if cfg.use_angle and cfg.use_overlap and cfg.use_smartangle:
        ok = ok & (_smartangle_score(l1, l2, cfg) >= cfg.score_th)
    if cfg.use_perp:
        u = _min_uncertainty(l1, l2)
        s = expscore(ld.dist_endpoints_perpendicular(l1, l2),
                     cfg.th_perp * u * cfg.multiplier)
        ok = ok & (s >= cfg.score_th)
    if cfg.use_innerseg:
        u = _min_uncertainty(l1, l2)
        s = expscore(ld.dist_innerseg(l1, l2),
                     cfg.th_innerseg * u * cfg.multiplier)
        ok = ok & (s >= cfg.score_th)
    if cfg.use_scaleinv:
        s = expscore(ld.dist_endpoints_scaleinv_oneway(l1, l2),
                     cfg.th_scaleinv * cfg.multiplier)
        ok = ok & (s >= cfg.score_th)
    return ok


@dataclasses.dataclass(frozen=True)
class LineLinker:
    """Joint 2D + 3D linker."""

    linker_2d: LineLinker2dConfig = LineLinker2dConfig()
    linker_3d: LineLinker3dConfig = LineLinker3dConfig()

    @classmethod
    def from_dicts(cls, d2d=None, d3d=None) -> "LineLinker":
        return cls(LineLinker2dConfig.from_dict(d2d),
                   LineLinker3dConfig.from_dict(d3d))

    def score_2d(self, l1, l2):
        return score_2d(l1, l2, self.linker_2d)

    def check_2d(self, l1, l2):
        return check_2d(l1, l2, self.linker_2d)

    def score_3d(self, l1, l2):
        return score_3d(l1, l2, self.linker_3d)

    def check_3d(self, l1, l2):
        return check_3d(l1, l2, self.linker_3d)
