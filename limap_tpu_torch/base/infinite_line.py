"""Infinite lines: 2D homogeneous coordinates, 3D Plücker coordinates,
the minimal (orthonormal) parameterization the optimizer works in, their
projection into views, and the re-trim of a segment from its 2D or 3D
supports."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.pose import (cross, quat_rotate, quat_to_rotmat,
                                       rotmat_to_quat)

EPS = 1e-12


def _normalize(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + EPS)


def get_direction_from_vp(vp: torch.Tensor, kvec: torch.Tensor
                          ) -> torch.Tensor:
    """Unit camera-frame direction of a vanishing point [..., 3] in
    homogeneous pixels: K^-1 vp, normalized.  (Its world direction, R^T
    K^-1 vp, is ``triangulation.functions.get_direction_from_vp``.)"""
    fx, fy, cx, cy = kvec.unbind(-1)
    return _normalize(torch.stack([vp[..., 0] / fx - cx / fx * vp[..., 2],
                                   vp[..., 1] / fy - cy / fy * vp[..., 2],
                                   vp[..., 2]], dim=-1))


def infline2d_from_segment(seg: Segments) -> torch.Tensor:
    """Normalized homogeneous coords [..., 3] of a 2D segment's line."""
    return seg.coords()


def infline2d_from_point_direction(p: torch.Tensor,
                                   direc: torch.Tensor) -> torch.Tensor:
    """(point, unit direction) -> normalized homogeneous coords."""
    coor = torch.stack([direc[..., 1], -direc[..., 0],
                        -direc[..., 1] * p[..., 0]
                        + direc[..., 0] * p[..., 1]], dim=-1)
    return _normalize(coor)


def infline2d_direction(coords: torch.Tensor) -> torch.Tensor:
    """Unit direction of homogeneous line(s)."""
    return _normalize(torch.stack([coords[..., 1], -coords[..., 0]], -1))


def infline2d_point_projection(coords: torch.Tensor,
                               q: torch.Tensor) -> torch.Tensor:
    """Perpendicular foot of 2D point(s) q on homogeneous line(s)."""
    a, b, c = coords[..., 0], coords[..., 1], coords[..., 2]
    d = (a * q[..., 0] + b * q[..., 1] + c) / (a * a + b * b + EPS)
    return torch.stack([q[..., 0] - a * d, q[..., 1] - b * d], dim=-1)


def infline2d_point_distance(coords: torch.Tensor,
                             q: torch.Tensor) -> torch.Tensor:
    a, b, c = coords[..., 0], coords[..., 1], coords[..., 2]
    return torch.abs(a * q[..., 0] + b * q[..., 1] + c) / torch.sqrt(
        a * a + b * b + EPS)


def intersect_infinite_lines_2d(c1: torch.Tensor, c2: torch.Tensor):
    """Intersection of two homogeneous 2D lines: (point [..., 2], valid)."""
    p_homo = _normalize(cross(c1, c2))
    valid = torch.abs(p_homo[..., 2]) >= EPS
    z = torch.where(valid, p_homo[..., 2], torch.ones_like(p_homo[..., 2]))
    return p_homo[..., :2] / z[..., None], valid


class InfiniteLines3d(NamedTuple):
    """Plücker lines: unit direction ``d`` and moment ``m``, [..., 3]."""

    d: torch.Tensor
    m: torch.Tensor

    @classmethod
    def from_point_direction(cls, p, direc) -> "InfiniteLines3d":
        direc = _normalize(direc)
        return cls(d=direc, m=cross(p, direc))

    @classmethod
    def from_segments(cls, seg: Segments) -> "InfiniteLines3d":
        d = seg.direction()
        return cls(d=d, m=cross(seg.start, d))

    def point(self) -> torch.Tensor:
        """Closest point to the origin."""
        return cross(self.d, self.m)

    def point_projection(self, q: torch.Tensor) -> torch.Tensor:
        """Perpendicular foot of q on the line."""
        return q + cross(self.d, self.m + cross(self.d, q))

    def point_distance(self, q: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(q - self.point_projection(q), dim=-1)

    def project_from_infinite_line(self, other: "InfiniteLines3d"
                                   ) -> torch.Tensor:
        """The point of this line closest to the line ``other``."""
        l1, m1, l2, m2 = self.d, self.m, other.d, other.m
        cr = cross(l1, l2)
        p = (-cross(m1, cross(l2, cr))
             + torch.sum(m2 * cr, dim=-1, keepdim=True) * l1)
        return p / (torch.sum(cr * cr, dim=-1, keepdim=True) + EPS)

    def project_to_infinite_line(self, other: "InfiniteLines3d"
                                 ) -> torch.Tensor:
        return other.project_from_infinite_line(self)

    def projection(self, views: CameraViewsBatch) -> torch.Tensor:
        """2D homogeneous line coords in the views."""
        return line_world_to_pixel(views.kvec, views.qvec, views.tvec,
                                   self.d, self.m)

    def unprojection(self, p2d: torch.Tensor,
                     views: CameraViewsBatch) -> torch.Tensor:
        """Point on the line closest to the camera ray of pixel p2d."""
        p1 = self.point()
        C0 = p1 - views.center()
        C1 = _normalize(self.d)
        C2 = views.ray_direction(p2d)
        A12 = torch.sum(C1 * C2, dim=-1)
        B1 = -torch.sum(C0 * C1, dim=-1)
        B2 = -torch.sum(C0 * C2, dim=-1)
        det = 1.0 - A12 * A12
        par = det < EPS
        t_gen = (B1 - B2 * A12) / torch.where(par, torch.ones_like(det), det)
        t = torch.where(par, B1, t_gen)
        return p1 + t[..., None] * C1


class MinimalInfiniteLines3d(NamedTuple):
    """Orthonormal representation: uvec [..., 4] (SO(3) quaternion) and
    wvec [..., 2] (unit SO(2) vector)."""

    uvec: torch.Tensor
    wvec: torch.Tensor

    @classmethod
    def from_plucker(cls, line: InfiniteLines3d) -> "MinimalInfiniteLines3d":
        a_n = _normalize(line.d)
        b = line.m
        b_norm = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        wvec = _normalize(torch.cat([torch.ones_like(b_norm), b_norm], -1))
        col1_reg = b / (b_norm + EPS)
        # |m| ~ 0: any unit vector orthogonal to d, from the axis least
        # aligned with d
        ex = a_n.new_tensor([1.0, 0.0, 0.0]).expand(a_n.shape)
        ey = a_n.new_tensor([0.0, 1.0, 0.0]).expand(a_n.shape)
        ref = torch.where(torch.abs(a_n[..., :1]) < 0.9, ex, ey)
        col1_deg = _normalize(cross(a_n, ref))
        col1 = torch.where(b_norm <= EPS, col1_deg, col1_reg)
        col2 = _normalize(cross(a_n, col1))
        Q = torch.stack([a_n, col1, col2], dim=-1)
        return cls(uvec=rotmat_to_quat(Q), wvec=wvec)

    @classmethod
    def from_segments(cls, seg: Segments) -> "MinimalInfiniteLines3d":
        return cls.from_plucker(InfiniteLines3d.from_segments(seg))

    def to_plucker(self) -> InfiniteLines3d:
        d, m = minimal_to_plucker(self.uvec, self.wvec)
        return InfiniteLines3d(d=d, m=m)


def minimal_to_plucker(uvec: torch.Tensor, wvec: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uvec, wvec) -> (d, m)."""
    Q = quat_to_rotmat(uvec)
    w1 = torch.abs(wvec[..., 0])
    w2 = torch.abs(wvec[..., 1])
    return Q[..., :, 0], Q[..., :, 1] * (w2 / (w1 + EPS))[..., None]


def line_img_from_cam(kvec: torch.Tensor, mvec: torch.Tensor) -> torch.Tensor:
    """Camera-frame moment -> normalized 2D homogeneous line coords
    (det(K) K^-T m in closed form)."""
    fx, fy, cx, cy = kvec.unbind(-1)
    m0, m1, m2 = mvec.unbind(-1)
    coor = torch.stack([fy * m0, fx * m1,
                        fx * fy * m2 - cx * fy * m0 - cy * fx * m1], dim=-1)
    return _normalize(coor)


def line_world_to_pixel(kvec, qvec, tvec, dvec, mvec) -> torch.Tensor:
    """World Plücker line -> 2D homogeneous coords: m_cam = R m + t x R d."""
    Rm = quat_rotate(qvec, mvec)
    Rd = quat_rotate(qvec, dvec)
    return line_img_from_cam(kvec, Rm + cross(tvec, Rd))


def segment_from_infinite_line_2d_supports(
        line: InfiniteLines3d, views: CameraViewsBatch, line2d: Segments,
        support_mask: torch.Tensor, num_outliers: int = 2) -> Segments:
    """Re-trim segments from their supporting 2D segments.

    Batched over leading dims: ``line`` fields [..., 3]; ``views``,
    ``line2d`` and ``support_mask`` carry one more axis, the S supports.
    The trim count is clamped so that small tracks stay valid.
    """
    direction = line.d
    p_ref = line.point()
    dS = direction.unsqueeze(-2)
    lineS = InfiniteLines3d(dS, line.m.unsqueeze(-2))
    coords = lineS.projection(views)                        # [..., S, 3]
    ps3d = lineS.unprojection(
        infline2d_point_projection(coords, line2d.start), views)
    pe3d = lineS.unprojection(
        infline2d_point_projection(coords, line2d.end), views)
    ts = torch.sum((ps3d - p_ref.unsqueeze(-2)) * dS, dim=-1)
    te = torch.sum((pe3d - p_ref.unsqueeze(-2)) * dS, dim=-1)
    values = torch.cat([ts, te], dim=-1)                    # [..., 2S]
    mask2 = torch.cat([support_mask, support_mask], dim=-1)
    big = 1e30
    lo_vals = torch.sort(torch.where(mask2, values,
                                     torch.full_like(values, big)),
                         dim=-1).values
    hi_vals = torch.sort(torch.where(mask2, values,
                                     torch.full_like(values, -big)),
                         dim=-1).values
    n_valid = 2 * support_mask.sum(-1)
    k = torch.clamp(torch.clamp((n_valid - 1) // 2, min=0),
                    max=max(num_outliers, 0))
    t_lo = torch.gather(lo_vals, -1, k[..., None])[..., 0]
    t_hi = torch.gather(hi_vals, -1,
                        (values.shape[-1] - 1 - k)[..., None])[..., 0]
    return Segments(start=p_ref + direction * t_lo[..., None],
                    end=p_ref + direction * t_hi[..., None])


def segment_from_infinite_line_3d_supports(
        line: InfiniteLines3d, line3d: Segments, support_mask: torch.Tensor,
        num_outliers: int = 2) -> Segments:
    """Re-trim a segment of one line (fields [3]) from its supporting 3D
    segments [S, 3], anchored on the projection of the first valid
    support's start; the trim count is clamped as in the 2D variant."""
    direction = line.d
    first = int(torch.argmax(support_mask.to(torch.int32)))
    p_ref = line.point_projection(line3d.start[first])
    ts = torch.sum((line3d.start - p_ref) * direction, dim=-1)
    te = torch.sum((line3d.end - p_ref) * direction, dim=-1)
    values = torch.cat([ts, te], dim=-1)
    mask2 = torch.cat([support_mask, support_mask], dim=-1)
    big = 1e30
    lo_vals = torch.sort(torch.where(mask2, values,
                                     torch.full_like(values, big))).values
    hi_vals = torch.sort(torch.where(mask2, values,
                                     torch.full_like(values, -big))).values
    n_valid = 2 * int(support_mask.sum())
    k = min(max(num_outliers, 0), max((n_valid - 1) // 2, 0))
    return Segments(start=p_ref + direction * lo_vals[k],
                    end=p_ref + direction * hi_vals[values.shape[0] - 1 - k])
