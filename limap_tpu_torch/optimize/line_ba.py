"""Fixed-camera line bundle adjustment: every track's minimal line is an
independent 4-DOF problem, all solved at once, on the card by kernel H
(``ops/lm_line_ba.py``, one launch a solve) and on the CPU by
:func:`lm_solve` with :func:`ba_residual`; then segments are re-trimmed
from the refined lines and their 2D supports.

The robust loss is applied as an IRLS weight computed from detached
residuals (Cauchy(0.25) by default).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import (
    MinimalInfiniteLines3d, segment_from_infinite_line_2d_supports)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import TrackBatch
from limap_tpu_torch.ops import lm_line_ba
from limap_tpu_torch.optimize import residuals as res
from limap_tpu_torch.optimize.lm import LMResult
from limap_tpu_torch.util import dataclass_from_dict


@dataclasses.dataclass(frozen=True)
class LineBAConfig:
    """Fixed-camera subset of the hybrid BA / refinement configuration."""

    geometric_alpha: float = 10.0
    min_num_images: int = 4       # tracks below stay constant
    num_outliers_aggregator: int = 2
    loss: str = "cauchy"          # "trivial" | "cauchy" | "huber"
    loss_scale: float = 0.25
    max_num_iterations: int = 100

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LineBAConfig":
        return dataclass_from_dict(cls, d)


def robust_weight(r2: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    """IRLS weight rho'(s) of the robust loss."""
    if loss == "trivial":
        return torch.ones_like(r2)
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / (scale * scale))
    if loss == "huber":
        r = torch.sqrt(r2 + 1e-12)
        return torch.where(r <= scale, torch.ones_like(r), scale / r)
    raise ValueError(f"unknown loss {loss}")


def pack_minimal_lines(lines: MinimalInfiniteLines3d) -> torch.Tensor:
    return torch.cat([lines.uvec, lines.wvec], dim=-1)


def unpack_minimal_lines(params: torch.Tensor) -> MinimalInfiniteLines3d:
    return MinimalInfiniteLines3d(uvec=params[..., :4], wvec=params[..., 4:6])


def ba_residual(cfg: LineBAConfig):
    """Batched residual: params [T, 6], supports [T, S, ...] ->
    flattened residuals [T, 2S] (support-major, x/y interleaved)."""

    def residual(params, kvec, qvec, tvec, p_start, p_end, w, valid):
        line = unpack_minimal_lines(params)
        r = res.line_geometric_residual(
            line.uvec[:, None], line.wvec[:, None],
            CameraViewsBatch(kvec, qvec, tvec), Segments(p_start, p_end),
            cfg.geometric_alpha)                               # [T, S, 2]
        # padded supports carry arbitrary cameras/segments: zero them
        # before the robust weighting
        r = torch.where(valid[..., None], r, torch.zeros_like(r))
        rw = robust_weight(torch.sum(r * r, dim=-1).detach(), cfg.loss,
                           cfg.loss_scale)
        scale = torch.sqrt(w * rw + 1e-12)[..., None]
        r = torch.where((w > 0)[..., None], r * scale, torch.zeros_like(r))
        return r.reshape(r.shape[0], -1)

    return residual


def solve_line_bundle_adjustment(
        batch: TrackBatch, views: CameraViewsBatch,
        cfg: LineBAConfig = LineBAConfig(),
        num_iterations: int = 20) -> Tuple[MinimalInfiniteLines3d, LMResult]:
    """Refine every track line with fixed cameras; returns the refined
    minimal lines and the LM diagnostics."""
    params0 = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(
        Segments(batch.line.start, batch.line.end)))
    sup_views = views.select(batch.img_index)               # [T, S, ...]
    # tracks seen in too few images keep zero weights: zero update
    free = (batch.count_images() >= cfg.min_num_images) & batch.track_mask
    weights = res.compute_line_weights(batch.line2d) * batch.mask \
        * free[:, None]
    result = lm_line_ba.solve(
        params0.contiguous(), sup_views.kvec, sup_views.qvec, sup_views.tvec,
        batch.line2d.start, batch.line2d.end, weights, batch.mask, cfg,
        num_iterations)
    return unpack_minimal_lines(result.params), result


def get_output_tracks(batch: TrackBatch, views: CameraViewsBatch,
                      refined: MinimalInfiniteLines3d,
                      num_outliers: int = 2) -> TrackBatch:
    """Re-trim segments from the refined infinite lines using the 2D
    supports; padded or empty tracks keep their line."""
    seg = segment_from_infinite_line_2d_supports(
        refined.to_plucker(), views.select(batch.img_index), batch.line2d,
        batch.mask, num_outliers)
    ok = (batch.track_mask & (batch.mask.sum(1) > 0))[:, None]
    return batch._replace(line=Segments(
        torch.where(ok, seg.start, batch.line.start),
        torch.where(ok, seg.end, batch.line.end)))
