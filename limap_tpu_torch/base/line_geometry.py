"""Segment <-> view geometry: projection, sensitivity, uncertainty."""

from __future__ import annotations

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments


def project_segments(seg3d: Segments, views: CameraViewsBatch) -> Segments:
    """Project 3D segments into views (broadcasting)."""
    return Segments(start=views.project(seg3d.start),
                    end=views.project(seg3d.end))


def sensitivity(seg3d: Segments, views: CameraViewsBatch) -> torch.Tensor:
    """90 - angle(direction, midpoint ray), in degrees."""
    seg2d = project_segments(seg3d, views)
    ray = views.ray_direction(seg2d.midpoint())
    cosv = torch.abs(torch.sum(seg3d.direction() * ray, dim=-1))
    return 90.0 - torch.rad2deg(torch.arccos(torch.clamp(cosv, -1.0, 1.0)))


def compute_uncertainty(seg3d: Segments, views: CameraViewsBatch,
                        var2d: float = 5.0) -> torch.Tensor:
    """Per-view depth uncertainty of the segment midpoint depth."""
    d1 = views.projdepth(seg3d.start)
    d2 = views.projdepth(seg3d.end)
    return views.uncertainty(0.5 * (d1 + d2), var2d)
