"""Line-to-line distances: the reference's seventeen types, the
infinite-line distances and the ``compute_distance`` dispatcher.

Every function takes two broadcasting :class:`Segments`; undefined
cases (non-overlapping inner segments) give ``MAX_DIST``.
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


def dist_angular(l1: Segments, l2: Segments) -> torch.Tensor:
    return 1.0 - cosine(l1, l2)


def dist_midpoint(l1: Segments, l2: Segments) -> torch.Tensor:
    return torch.linalg.vector_norm(l1.midpoint() - l2.midpoint(), dim=-1)


def dist_endpoints(l1: Segments, l2: Segments) -> torch.Tensor:
    """Minimum over the two endpoint pairings."""
    n = lambda a, b: torch.linalg.vector_norm(a - b, dim=-1)
    return torch.minimum(n(l1.start, l2.start) + n(l1.end, l2.end),
                         n(l1.start, l2.end) + n(l1.end, l2.start))


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


def dist_midpoint_perpendicular(l1: Segments, l2: Segments) -> torch.Tensor:
    """Mean of each midpoint's distance to the other infinite line."""
    d12 = _perp_dist_point_to_infline(l1.midpoint(), l2.start,
                                      l2.direction())
    d21 = _perp_dist_point_to_infline(l2.midpoint(), l1.start,
                                      l1.direction())
    return 0.5 * (d12 + d21)


def dist_endpoints_perpendicular_scaleinv_line3dpp_oneway(l1, l2):
    """Line3D++ scale-invariant perpendicular distance over l1's depths."""
    ds, de = dists_endpoints_perpendicular_oneway(l1, l2)
    return torch.maximum(ds / (l1.depths[..., 0] + EPS),
                         de / (l1.depths[..., 1] + EPS))


def dist_endpoints_perpendicular_scaleinv_line3dpp(l1, l2):
    return torch.maximum(
        dist_endpoints_perpendicular_scaleinv_line3dpp_oneway(l1, l2),
        dist_endpoints_perpendicular_scaleinv_line3dpp_oneway(l2, l1))


def dist_endpoints_perpendicular_scaleinv_oneway(l1, l2):
    """Perpendicular distance over the depth interpolated along l2;
    ``MAX_DIST`` where an endpoint projects before l2's start."""
    ds, de = dists_endpoints_perpendicular_oneway(l1, l2)
    dir2 = l2.direction()
    len2 = l2.length()
    a_s = torch.sum((l1.start - l2.start) * dir2, dim=-1) / (len2 + EPS)
    a_e = torch.sum((l1.end - l2.start) * dir2, dim=-1) / (len2 + EPS)
    z0, z1 = l2.depths[..., 0], l2.depths[..., 1]
    val = torch.maximum(ds / (z0 + a_s * (z1 - z0)),
                        de / (z0 + a_e * (z1 - z0)))
    bad = (a_s < 100 * EPS) | (a_e < 100 * EPS)
    return torch.where(bad, torch.full_like(val, MAX_DIST), val)


def dist_endpoints_perpendicular_scaleinv(l1, l2):
    return torch.maximum(dist_endpoints_perpendicular_scaleinv_oneway(l1, l2),
                         dist_endpoints_perpendicular_scaleinv_oneway(l2, l1))


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


def dist_endpoints_scaleinv(l1, l2) -> torch.Tensor:
    return torch.maximum(dist_endpoints_scaleinv_oneway(l1, l2),
                         dist_endpoints_scaleinv_oneway(l2, l1))


def dist_overlap(l1, l2) -> torch.Tensor:
    return 1.0 - compute_bioverlap(l1, l2)


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


def dist_minpoint_oneway(l1: Segments, l2: Segments) -> torch.Tensor:
    """Min distance from a point on segment l1 to the infinite line l2;
    works for 2D and 3D."""
    v1 = l1.direction()
    v2 = l2.direction()
    disp = l2.start - l1.start
    start_vec = disp - torch.sum(disp * v2, dim=-1, keepdim=True) * v2
    val = torch.linalg.vector_norm(start_vec, dim=-1)
    sv_unit = start_vec / (val[..., None] + EPS)
    beta1 = torch.sum(v1 * sv_unit, dim=-1)
    if l1.start.shape[-1] == 2:
        res_in = torch.clamp(val - beta1 * l1.length(), min=0.0)
    else:
        beta2 = torch.sum(v1 * v2, dim=-1)
        beta3 = torch.sqrt(torch.clamp(1.0 - beta1 ** 2 - beta2 ** 2,
                                       min=0.0))
        peak = (beta1 * val) / (beta1 ** 2 + beta3 ** 2 + EPS)
        x = torch.minimum(peak, l1.length())
        res_in = torch.sqrt((val - beta1 * x) ** 2 + (beta3 * x) ** 2)
    res = torch.where(beta1 <= 0, val, res_in)
    return torch.where(val < EPS, torch.zeros_like(res), res)


def dist_minpoint(l1, l2) -> torch.Tensor:
    return torch.minimum(dist_minpoint_oneway(l1, l2),
                         dist_minpoint_oneway(l2, l1))


def infinite_dist_perpendicular(l1: Segments, l2: Segments) -> torch.Tensor:
    """Least distance between the two infinite 3D lines."""
    C0 = l1.start - l2.start
    Cp = l1.end - l1.start
    Cq = l2.start - l2.end
    dot = lambda a, b: torch.sum(a * b, dim=-1)
    A11, A22, A12 = dot(Cp, Cp), dot(Cq, Cq), dot(Cp, Cq)
    B1, B2 = -dot(C0, Cp), -dot(C0, Cq)
    det = A11 * A22 - A12 * A12
    par = det < EPS
    det_safe = torch.where(par, torch.ones_like(det), det)
    p = torch.where(par, B1 / (A11 + EPS), (B1 * A22 - B2 * A12) / det_safe)
    q = torch.where(par, torch.zeros_like(det),
                    (A11 * B2 - A12 * B1) / det_safe)
    return torch.linalg.vector_norm(C0 + Cp * p[..., None] + Cq * q[..., None],
                                    dim=-1)


def infinite_perpendicular_scaleinv_line3dpp(l1, l2) -> torch.Tensor:
    """Scale-invariant infinite perpendicular distance, one way, over
    l1's depths."""
    z1, z2 = l1.depths[..., 0], l1.depths[..., 1]
    vec2 = l2.end - l2.start
    v = vec2 / (torch.linalg.vector_norm(vec2, dim=-1, keepdim=True) + EPS)
    dz = (z2 - z1)[..., None]
    Ck = l1.start - (l1.end - l1.start) * (z1[..., None] / (dz + EPS)) \
        - l2.start
    Cz = (l1.end - l1.start) / (dz + EPS)
    CkTv = torch.sum(Ck * v, dim=-1)
    A = torch.sum(Ck * Ck, dim=-1) - CkTv ** 2
    B = torch.sum(Ck * Cz, dim=-1) - CkTv * torch.sum(Cz * v, dim=-1)
    k = -B / (A + EPS)
    w = Ck * k[..., None] + Cz
    d2 = torch.sum(w * w, dim=-1) - torch.sum(w * v, dim=-1) ** 2
    return torch.sqrt(torch.clamp(d2, min=0.0))


def infinite_dist_perpendicular_scaleinv_line3dpp(l1, l2) -> torch.Tensor:
    return torch.minimum(infinite_perpendicular_scaleinv_line3dpp(l1, l2),
                         infinite_perpendicular_scaleinv_line3dpp(l2, l1))


_DISPATCH = {
    "angular": angle,
    "angular_dist": dist_angular,
    "endpoints": dist_endpoints,
    "midpoint": dist_midpoint,
    "midpoint_perpendicular": dist_midpoint_perpendicular,
    "overlap": compute_overlap,
    "bioverlap": compute_bioverlap,
    "overlap_dist": dist_overlap,
    "perpendicular_oneway": dist_endpoints_perpendicular_oneway,
    "perpendicular": dist_endpoints_perpendicular,
    "innerseg": dist_innerseg,
    "perpendicular_scaleinv_line3dpp_oneway":
        dist_endpoints_perpendicular_scaleinv_line3dpp_oneway,
    "perpendicular_scaleinv_line3dpp":
        dist_endpoints_perpendicular_scaleinv_line3dpp,
    "perpendicular_scaleinv_oneway":
        dist_endpoints_perpendicular_scaleinv_oneway,
    "perpendicular_scaleinv": dist_endpoints_perpendicular_scaleinv,
    "endpoints_scaleinv_oneway": dist_endpoints_scaleinv_oneway,
    "endpoints_scaleinv": dist_endpoints_scaleinv,
}
DIST_TYPES = tuple(_DISPATCH)
_3D_ONLY = frozenset(k for k in _DISPATCH if "scaleinv" in k)


def compute_distance(l1: Segments, l2: Segments, dist_type: str):
    """The distance named ``dist_type`` (one of ``DIST_TYPES``)."""
    if dist_type not in _DISPATCH:
        raise ValueError(f"unknown distance type {dist_type!r}")
    if dist_type in _3D_ONLY and l1.dim == 2:
        raise ValueError(f"{dist_type} is not supported for 2D lines")
    return _DISPATCH[dist_type](l1, l2)


def pairwise(l1: Segments, l2: Segments, dist_type: str) -> torch.Tensor:
    """All-pairs distance matrix [N, M] of two segment batches."""
    return compute_distance(l1.expand(1), l2.expand(0), dist_type)
