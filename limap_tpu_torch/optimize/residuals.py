"""Residuals of the fixed-camera line refinement and association."""

from __future__ import annotations

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import (get_direction_from_vp,
                                                line_world_to_pixel,
                                                minimal_to_plucker)
from limap_tpu_torch.base.lines import EPS, Segments
from limap_tpu_torch.base.pose import cross, quat_rotate


def cosine_weighted_perpendicular_dist2d(coor: torch.Tensor,
                                         p1: torch.Tensor, p2: torch.Tensor,
                                         alpha: float = 10.0) -> torch.Tensor:
    """Both endpoint-to-line distances [..., 2], times
    exp(alpha * (1 - |cos|)) of the angle between line and segment."""
    direc_norm = torch.sqrt(coor[..., 0] ** 2 + coor[..., 1] ** 2 + EPS)
    d1 = (p1[..., 0] * coor[..., 0] + p1[..., 1] * coor[..., 1]
          + coor[..., 2]) / direc_norm
    d2 = (p2[..., 0] * coor[..., 0] + p2[..., 1] * coor[..., 1]
          + coor[..., 2]) / direc_norm
    dir2d = torch.stack([-coor[..., 1], coor[..., 0]], dim=-1) \
        / direc_norm[..., None]
    seg_dir = p2 - p1
    seg_norm = torch.sqrt(torch.sum(seg_dir * seg_dir, dim=-1) + EPS)
    cosine = torch.clamp(torch.abs(torch.sum(dir2d * seg_dir, dim=-1))
                         / seg_norm, max=1.0)
    weight = torch.exp(alpha * (1.0 - cosine))
    return torch.stack([d1 * weight, d2 * weight], dim=-1)


def line_geometric_residual(uvec: torch.Tensor, wvec: torch.Tensor,
                            views: CameraViewsBatch, line2d: Segments,
                            alpha: float = 10.0) -> torch.Tensor:
    """Geometric refinement residual [..., 2] of a minimal line against
    2D segments in their views."""
    d, m = minimal_to_plucker(uvec, wvec)
    coor = line_world_to_pixel(views.kvec, views.qvec, views.tvec, d, m)
    return cosine_weighted_perpendicular_dist2d(coor, line2d.start,
                                                line2d.end, alpha)


def point_geometric_residual(p3d: torch.Tensor, views: CameraViewsBatch,
                             p2d: torch.Tensor) -> torch.Tensor:
    """Pinhole reprojection residual [..., 2]."""
    return views.project(p3d) - p2d


def vp_constraint_residual(uvec: torch.Tensor, wvec: torch.Tensor,
                           views: CameraViewsBatch,
                           vp: torch.Tensor) -> torch.Tensor:
    """Sine between a line's direction in the camera frame and its VP's
    direction [...]."""
    d, _ = minimal_to_plucker(uvec, wvec)
    d_rot = quat_rotate(views.qvec, d)
    d_rot = d_rot / (torch.linalg.vector_norm(d_rot, dim=-1, keepdim=True)
                     + EPS)
    return torch.linalg.vector_norm(cross(d_rot, get_direction_from_vp(
        vp, views.kvec)), dim=-1)


def compute_line_weights(line2d: Segments) -> torch.Tensor:
    """length / 30 per supporting 2D segment."""
    return line2d.length() / 30.0
