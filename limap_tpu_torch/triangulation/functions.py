"""Two-view line triangulation primitives, broadcasting over batch dims.

Invalid results carry ``score = -1`` with start 0 / end 1 and depths -1,
like the reference.  VP-directed, one-point and known-line triangulation
wait for a later slice.
"""

from __future__ import annotations

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import EPS, Segments
from limap_tpu_torch.base.pose import (cross, quat_conjugate, quat_normalize,
                                       quat_rotate)

INVALID_SCORE = -1.0


def _norm(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + EPS)


def _select(valid, good: Segments, start: torch.Tensor) -> Segments:
    """``good`` where valid, the invalid sentinel elsewhere."""
    v = valid[..., None]
    return Segments(
        start=torch.where(v, good.start, torch.zeros_like(start)),
        end=torch.where(v, good.end, torch.ones_like(start)),
        score=torch.where(valid, good.score,
                          torch.full_like(good.score, INVALID_SCORE)),
        depths=torch.where(v, good.depths, torch.full_like(good.depths, -1.0)))


def test_line_inside_ranges(line: Segments, ranges) -> torch.Tensor:
    """Axis-aligned scene-range test."""
    lo, hi = ranges
    ok_s = torch.all((line.start >= lo) & (line.start <= hi), dim=-1)
    ok_e = torch.all((line.end >= lo) & (line.end <= hi), dim=-1)
    return ok_s & ok_e


def get_normal_direction(l2d: Segments,
                         views: CameraViewsBatch) -> torch.Tensor:
    """Unit normal of the back-projection plane of a 2D segment."""
    return _norm(cross(views.ray_direction(l2d.start),
                       views.ray_direction(l2d.end)))


def epipolar_line(view1: CameraViewsBatch, view2: CameraViewsBatch,
                  p1: torch.Tensor) -> torch.Tensor:
    """``F @ [p1; 1]`` matrix-free: K2^-T [t_rel]x R2 R1^T K1^-1 p1."""
    u = (p1[..., 0] - view1.kvec[..., 2]) / view1.kvec[..., 0]
    v = (p1[..., 1] - view1.kvec[..., 3]) / view1.kvec[..., 1]
    x1 = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    q1c = quat_normalize(quat_conjugate(view1.qvec))
    rx = quat_rotate(view2.qvec, quat_rotate(q1c, x1))
    rt = quat_rotate(view2.qvec, quat_rotate(q1c, view1.tvec))
    ex = cross(view2.tvec - rt, rx)
    fx2, fy2 = view2.kvec[..., 0], view2.kvec[..., 1]
    cx2, cy2 = view2.kvec[..., 2], view2.kvec[..., 3]
    return torch.stack([ex[..., 0] / fx2, ex[..., 1] / fy2,
                        ex[..., 2] - (cx2 / fx2) * ex[..., 0]
                        - (cy2 / fy2) * ex[..., 1]], dim=-1)


def compute_epipolar_iou(l1: Segments, view1: CameraViewsBatch,
                         l2: Segments, view2: CameraViewsBatch
                         ) -> torch.Tensor:
    """IoU of l2 with the epipolar band of l1."""
    coor_l2 = l2.coords()

    def intersect_at(p):
        epline = _norm(epipolar_line(view1, view2, p))
        c_homo = cross(coor_l2, epline)
        return c_homo[..., :2] / (c_homo[..., 2:3] + EPS)

    c_start = intersect_at(l1.start)
    c_end = intersect_at(l1.end)
    dir2 = l2.direction()
    len2 = l2.length()
    c1 = torch.sum((c_start - l2.start) * dir2, dim=-1) / (len2 + EPS)
    c2 = torch.sum((c_end - l2.start) * dir2, dim=-1) / (len2 + EPS)
    lo = torch.minimum(c1, c2)
    hi = torch.maximum(c1, c2)
    return (torch.clamp(hi, max=1.0) - torch.clamp(lo, min=0.0)) / (
        torch.clamp(hi, min=1.0) - torch.clamp(lo, max=0.0) + EPS)


def triangulate_point(p1, view1: CameraViewsBatch,
                      p2, view2: CameraViewsBatch):
    """Two-ray midpoint triangulation + cheirality: (point, valid)."""
    C1 = view1.center()
    C2 = view2.center()
    n1 = view1.ray_direction(p1)
    n2 = view2.ray_direction(p2)
    a11 = torch.sum(n1 * n1, dim=-1)
    a12 = -torch.sum(n1 * n2, dim=-1)
    a22 = torch.sum(n2 * n2, dim=-1)
    b1 = torch.sum(n1 * (C2 - C1), dim=-1)
    b2 = torch.sum(n2 * (C1 - C2), dim=-1)
    det = a11 * a22 - a12 * a12
    small = torch.abs(det) < EPS
    det_safe = torch.where(small, torch.ones_like(det), det)
    t1 = (b1 * a22 - b2 * a12) / det_safe
    t2 = (a11 * b2 - a12 * b1) / det_safe
    point = 0.5 * (n1 * t1[..., None] + C1 + n2 * t2[..., None] + C2)
    valid = ((view1.projdepth(point) >= EPS)
             & (view2.projdepth(point) >= EPS) & ~small)
    return point, valid


def triangulate_line_by_endpoints(l1: Segments, view1: CameraViewsBatch,
                                  l2: Segments,
                                  view2: CameraViewsBatch) -> Segments:
    """Endpoint-wise triangulation."""
    ps, ok_s = triangulate_point(l1.start, view1, l2.start, view2)
    pe, ok_e = triangulate_point(l1.end, view1, l2.end, view2)
    z_s = view1.projdepth(ps)
    z_e = view1.projdepth(pe)
    good = Segments(start=ps, end=pe, score=torch.ones_like(z_s),
                    depths=torch.stack([z_s, z_e], dim=-1))
    return _select(ok_s & ok_e, good, ps)


def triangulate_line_algebraic(l1: Segments, view1: CameraViewsBatch,
                               l2: Segments,
                               view2: CameraViewsBatch) -> Segments:
    """Asymmetric plane-ray triangulation: l1's endpoint rays meet the
    back-projection plane of l2 (Cramer's rule on the 3x3 system)."""
    c1_start = view1.ray_direction(l1.start)
    c1_end = view1.ray_direction(l1.end)
    c2_start = view2.ray_direction(l2.start)
    c2_end = view2.ray_direction(l2.end)
    C1 = view1.center()
    B = view2.center() - C1
    n2 = cross(c2_start, c2_end)
    nume = torch.sum(B * n2, dim=-1)

    def solve_depth(ray):
        denom = torch.sum(ray * n2, dim=-1)
        return nume / torch.where(torch.abs(denom) < EPS,
                                  torch.full_like(denom, EPS), denom)

    p_start = c1_start * solve_depth(c1_start)[..., None] + C1
    p_end = c1_end * solve_depth(c1_end)[..., None] + C1
    z_s = view1.projdepth(p_start)
    z_e = view1.projdepth(p_end)
    valid = ((z_s >= EPS) & (z_e >= EPS)
             & (view2.projdepth(p_start) >= EPS)
             & (view2.projdepth(p_end) >= EPS)
             & torch.all(torch.isfinite(p_start), -1)
             & torch.all(torch.isfinite(p_end), -1))
    good = Segments(start=p_start, end=p_end, score=torch.ones_like(z_s),
                    depths=torch.stack([z_s, z_e], dim=-1))
    return _select(valid, good, p_start)
