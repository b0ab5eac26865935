"""Line-to-line distances used by the linkers and the track filters.

Every function takes two broadcasting :class:`Segments`.  Only the
distances the slice's linkers and filters call are here; the rest of the
reference's seventeen wait for a later slice.
"""

from __future__ import annotations

import torch

from limap_tpu_torch.base.lines import EPS, Segments

MAX_DIST = 1e12


def cosine(l1: Segments, l2: Segments) -> torch.Tensor:
    return torch.abs(torch.sum(l1.direction() * l2.direction(), dim=-1))


def angle(l1: Segments, l2: Segments) -> torch.Tensor:
    """Angle between directions in degrees."""
    c = torch.clamp(cosine(l1, l2), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(c))


def _perp_dist_point_to_infline(p, origin, direction):
    disp = p - origin
    along = torch.sum(disp * direction, dim=-1)
    d2 = torch.sum(disp * disp, dim=-1) - along * along
    return torch.sqrt(torch.clamp(d2, min=0.0))


def dists_endpoints_perpendicular_oneway(l1: Segments, l2: Segments):
    """(d_start, d_end): l1's endpoints to l2's infinite line."""
    v2 = l2.direction()
    return (_perp_dist_point_to_infline(l1.start, l2.start, v2),
            _perp_dist_point_to_infline(l1.end, l2.start, v2))


def dist_endpoints_perpendicular_oneway(l1, l2) -> torch.Tensor:
    ds, de = dists_endpoints_perpendicular_oneway(l1, l2)
    return torch.maximum(ds, de)


def dist_endpoints_perpendicular(l1, l2) -> torch.Tensor:
    return torch.maximum(dist_endpoints_perpendicular_oneway(l1, l2),
                         dist_endpoints_perpendicular_oneway(l2, l1))


def dist_endpoints_scaleinv_oneway(l1, l2) -> torch.Tensor:
    """Aligned endpoint distance over l1's depths."""
    ds = torch.linalg.vector_norm(l1.start - l2.start, dim=-1)
    de = torch.linalg.vector_norm(l1.end - l2.end, dim=-1)
    return torch.maximum(ds / (l1.depths[..., 0] + EPS),
                         de / (l1.depths[..., 1] + EPS))


def compute_overlap(l1: Segments, l2: Segments) -> torch.Tensor:
    """Signed intersection ratio of l1 projected onto l2."""
    length = l2.length()
    v = l2.direction()
    p1 = torch.sum((l1.start - l2.start) * v, dim=-1) / (length + EPS)
    p2 = torch.sum((l1.end - l2.start) * v, dim=-1) / (length + EPS)
    lo = torch.minimum(p1, p2)
    hi = torch.maximum(p1, p2)
    return torch.clamp(hi, max=1.0) - torch.clamp(lo, min=0.0)


def compute_bioverlap(l1, l2) -> torch.Tensor:
    return torch.maximum(compute_overlap(l1, l2), compute_overlap(l2, l1))


def _innerseg(l1: Segments, l2: Segments):
    """Inner segment of l2 under l1's endpoints, unprojected along l1's
    direction: (start, end, valid)."""
    v1 = l1.direction()
    seg2 = l2.end - l2.start
    denom = torch.sum(seg2 * v1, dim=-1)
    t1 = torch.sum((l1.start - l2.start) * v1, dim=-1) / (denom + EPS)
    t2 = torch.sum((l1.end - l2.start) * v1, dim=-1) / (denom + EPS)
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    valid = (tlo < 1.0) & (thi > 0.0)
    start = l2.start + seg2 * torch.clamp(tlo, min=0.0)[..., None]
    end = l2.start + seg2 * torch.clamp(thi, max=1.0)[..., None]
    return start, end, valid


def dist_innerseg(l1: Segments, l2: Segments) -> torch.Tensor:
    """Mutual inner-segment perpendicular distance; MAX_DIST when the
    unprojections do not overlap."""
    s1, e1, ok1 = _innerseg(l2, l1)
    s2, e2, ok2 = _innerseg(l1, l2)
    d = dist_endpoints_perpendicular(Segments(s1, e1), Segments(s2, e2))
    return torch.where(ok1 & ok2, d, torch.full_like(d, MAX_DIST))
