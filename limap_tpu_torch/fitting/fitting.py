"""3D segments from depth: sample points along each 2D segment, lift
them with the depth map (or read them from a point map), and fit a line
to each segment's points with a batched RANSAC and a TLS refit.

The RANSAC is split in two: :func:`draw_hypotheses` draws the sample
pairs from a CPU ``torch.Generator`` (so the card and the CPU fit with
the same hypotheses), and :func:`fit_lines_from_hypotheses` scores them
(``ops/line_ransac.py``: one kernel launch on the card) and refits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.pose import quat_normalize, quat_rotate
from limap_tpu_torch.merging.aggregator import principal_direction
from limap_tpu_torch.ops.line_ransac import line_ransac

_BIG = 1e30

__all__ = ["sample_segment_depths", "unproject_points", "draw_hypotheses",
           "fit_lines_from_hypotheses", "fit_lines_ransac",
           "depth_fit_inputs", "points3d_fit_inputs",
           "estimate_segs3d_from_depth", "estimate_segs3d_from_points3d"]


def sample_grid(n_samples: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: i * f32(1 / (n - 1)), the
    last entry 1.0 (``torch.linspace`` rounds differently in the last
    place, which moves a rounded pixel coordinate)."""
    if n_samples == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    t = np.arange(n_samples, dtype=np.float32) * np.float32(
        1.0 / (n_samples - 1))
    t[-1] = 1.0
    return torch.as_tensor(t, device=device)


def _segment_samples(segs2d: Segments, n_samples: int) -> torch.Tensor:
    t = sample_grid(n_samples, segs2d.start.device)
    return (segs2d.start[:, None, :]
            + t[None, :, None] * (segs2d.end - segs2d.start)[:, None, :])


def sample_segment_depths(segs2d: Segments, depth: torch.Tensor,
                          n_samples: int):
    """Pixels uniformly along each 2D segment and the depths under them
    (nearest pixel, rounded half to even).  Returns (points2d [N, S, 2],
    depths [N, S], valid [N, S])."""
    H, W = depth.shape
    pts = _segment_samples(segs2d, n_samples)
    xi = torch.round(pts[..., 0]).to(torch.int32)
    yi = torch.round(pts[..., 1]).to(torch.int32)
    inside = (xi >= 0) & (yi >= 0) & (xi < W) & (yi < H)
    d = depth[torch.clamp(yi, 0, H - 1).long(),
              torch.clamp(xi, 0, W - 1).long()]
    valid = inside & torch.isfinite(d) & (d > 0)
    return pts, d, valid


def unproject_points(pts2d: torch.Tensor, depths: torch.Tensor,
                     view: CameraViewsBatch) -> torch.Tensor:
    """Pixels + depths -> world points; ``view`` holds one camera."""
    u = (pts2d[..., 0] - view.kvec[2]) / view.kvec[0]
    v = (pts2d[..., 1] - view.kvec[3]) / view.kvec[1]
    p_cam = torch.stack([u * depths, v * depths, depths], dim=-1)
    qc = view.qvec * view.qvec.new_tensor([1.0, -1.0, -1.0, -1.0])
    return quat_rotate(quat_normalize(qc), p_cam - view.tvec)


def nanmedian_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of the valid entries of each row as ``jnp.nanmedian`` gives
    it (the mean of the two middle values for an even count;
    ``torch.nanmedian`` takes the lower one), 1.0 where none is valid."""
    k = valid.sum(-1)
    s = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))),
                   dim=-1).values
    lo = torch.gather(s, -1, torch.clamp((k - 1) // 2, min=0)[..., None])[..., 0]
    hi = torch.gather(s, -1, torch.clamp(k // 2, max=x.shape[-1] - 1)
                      [..., None])[..., 0]
    med = torch.where(k % 2 == 1, lo, lo * 0.5 + hi * 0.5)
    return torch.where(k > 0, med, torch.ones_like(med))


def draw_hypotheses(N: int, S: int, H: int,
                    generator: torch.Generator) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Sample pairs [N, H] int32 on the CPU; a pair never repeats a
    sample (b == a moves to (b + 1) % S)."""
    idx_a = torch.randint(0, S, (N, H), generator=generator,
                          dtype=torch.int32)
    idx_b = torch.randint(0, S, (N, H), generator=generator,
                          dtype=torch.int32)
    return idx_a, torch.where(idx_b == idx_a, (idx_b + 1) % S, idx_b)


def fit_lines_from_hypotheses(points: torch.Tensor, valid: torch.Tensor,
                              inlier_th: torch.Tensor, idx_a: torch.Tensor,
                              idx_b: torch.Tensor,
                              min_inlier_ratio: float = 0.6,
                              min_points: int = 7) -> Segments:
    """Score the given hypotheses, refit each segment's best inliers by
    TLS and take the extreme projections as endpoints.  Returns Segments
    [N, 3] with score = inlier ratio, or -1 (and zero endpoints) where
    the fit is rejected.  The TLS axis has no fixed sign, so start and
    end may come out swapped relative to another implementation.  Unlike
    the JAX package, a non-finite point outside the inliers leaves the
    segment finite (there it turns the segment into NaN)."""
    inliers, n_inl, n_valid, _ = line_ransac(
        points, valid, inlier_th, idx_a.to(points.device),
        idx_b.to(points.device))
    ratio = n_inl / torch.clamp(n_valid, min=1)
    # only the inliers enter the refit; an invalid sample's point may be
    # NaN or inf (a hole in the depth map), which a masking product
    # would carry into the whole row
    points = torch.where(inliers[..., None], points, torch.zeros_like(points))
    direc, center = principal_direction(points, inliers)
    proj = torch.sum((points - center[:, None]) * direc[:, None], dim=-1)
    t_lo = torch.amin(torch.where(inliers, proj, torch.full_like(proj, _BIG)),
                      dim=-1)
    t_hi = torch.amax(torch.where(inliers, proj,
                                  torch.full_like(proj, -_BIG)), dim=-1)
    start = center + direc * t_lo[:, None]
    end = center + direc * t_hi[:, None]
    ok = (ratio >= min_inlier_ratio) & (n_valid > min_points) & (n_inl >= 2)
    zero = torch.zeros_like(start)
    return Segments(start=torch.where(ok[:, None], start, zero),
                    end=torch.where(ok[:, None], end, zero),
                    score=torch.where(ok, ratio, torch.full_like(ratio, -1.0)))


def fit_lines_ransac(points: torch.Tensor, valid: torch.Tensor,
                     inlier_th: torch.Tensor, generator: torch.Generator,
                     n_hypotheses: int = 32, min_inlier_ratio: float = 0.6,
                     min_points: int = 7) -> Segments:
    """Batched line RANSAC over [N, S, 3] point sets, with hypotheses
    drawn from ``generator`` (a CPU ``torch.Generator``)."""
    N, S = valid.shape
    idx_a, idx_b = draw_hypotheses(N, S, n_hypotheses, generator)
    return fit_lines_from_hypotheses(points, valid, inlier_th, idx_a, idx_b,
                                     min_inlier_ratio, min_points)


def depth_fit_inputs(segs2d: Segments, depth: torch.Tensor,
                     view: CameraViewsBatch, ransac_th: float = 0.75,
                     var2d: float = 5.0, n_samples: int = 64):
    """One image's RANSAC inputs from its depth map: (points [N, S, 3],
    valid [N, S], inlier_th [N] = ransac_th * var2d * median depth /
    focal)."""
    pts2d, d, valid = sample_segment_depths(segs2d, depth, n_samples)
    points = unproject_points(pts2d, d, view)
    med = nanmedian_valid(d, valid)
    f = 0.5 * (view.kvec[0] + view.kvec[1])
    return points, valid, ransac_th * (var2d * med / f)


def points3d_fit_inputs(segs2d: Segments, p3d_map: torch.Tensor,
                        view: CameraViewsBatch, img_hw,
                        ransac_th: float = 0.75, var2d: float = 5.0,
                        n_samples: int = 64):
    """One image's RANSAC inputs from a point map [H, W, 3] (NaN, inf or
    0 = miss); the threshold scales with the median ray depth over
    0.7 max(H, W)."""
    H, W = img_hw
    pts = _segment_samples(segs2d, n_samples)
    xi = torch.clamp(torch.round(pts[..., 0]).to(torch.int32), 0, W - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).to(torch.int32), 0, H - 1)
    inside = ((pts[..., 0] >= 0) & (pts[..., 1] >= 0)
              & (pts[..., 0] < W) & (pts[..., 1] < H))
    points = p3d_map[yi.long(), xi.long()]
    finite = torch.all(torch.isfinite(points), -1) \
        & (torch.sum(torch.abs(points), -1) > 0)
    valid = inside & finite
    ray = points - view.center()
    ray_depth = torch.sqrt(ray[..., 0] * ray[..., 0] + ray[..., 1] * ray[..., 1]
                           + ray[..., 2] * ray[..., 2])
    med = nanmedian_valid(ray_depth, valid)
    scale = torch.tensor(0.7 * max(H, W), dtype=torch.float32,
                         device=med.device)
    return points, valid, ransac_th * (var2d * med / scale)


def estimate_segs3d_from_depth(segs2d: Segments, depth: torch.Tensor,
                               view: CameraViewsBatch,
                               generator: torch.Generator,
                               ransac_th: float = 0.75,
                               min_percentage_inliers: float = 0.6,
                               var2d: float = 5.0, n_samples: int = 64,
                               n_hypotheses: int = 32) -> Segments:
    """All segments of one image -> 3D segments; ``view`` holds one
    camera."""
    points, valid, th = depth_fit_inputs(segs2d, depth, view, ransac_th,
                                         var2d, n_samples)
    return fit_lines_ransac(points, valid, th, generator, n_hypotheses,
                            min_percentage_inliers)


def estimate_segs3d_from_points3d(segs2d: Segments, p3d_map: torch.Tensor,
                                  view: CameraViewsBatch,
                                  generator: torch.Generator, img_hw,
                                  ransac_th: float = 0.75,
                                  min_percentage_inliers: float = 0.6,
                                  var2d: float = 5.0, n_samples: int = 64,
                                  n_hypotheses: int = 32) -> Segments:
    """The point-map variant of :func:`estimate_segs3d_from_depth`."""
    points, valid, th = points3d_fit_inputs(segs2d, p3d_map, view, img_hw,
                                            ransac_th, var2d, n_samples)
    return fit_lines_ransac(points, valid, th, generator, n_hypotheses,
                            min_percentage_inliers)
