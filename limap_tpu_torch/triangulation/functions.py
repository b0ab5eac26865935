"""Two-view line triangulation primitives, broadcasting over batch dims:
the epipolar geometry, algebraic and endpoint triangulation, known-line
and one-point triangulation, and the covariance of the algebraic one.

Invalid results carry ``score = -1`` with start 0 / end 1 and depths -1,
like the reference.
"""

from __future__ import annotations

import torch

import math

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import InfiniteLines3d
from limap_tpu_torch.base.lines import EPS, Segments
from limap_tpu_torch.base.pose import (cross, quat_conjugate, quat_normalize,
                                       quat_rotate, quat_to_rotmat)

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


def get_direction_from_vp(vp: torch.Tensor,
                          views: CameraViewsBatch) -> torch.Tensor:
    """Unit world direction of a vanishing point [..., 3] given in the
    pixels of ``views``: R^T K^-1 vp."""
    u = (vp[..., 0] - views.kvec[..., 2] * vp[..., 2]) / views.kvec[..., 0]
    v = (vp[..., 1] - views.kvec[..., 3] * vp[..., 2]) / views.kvec[..., 1]
    d_cam = torch.stack([u, v, vp[..., 2]], dim=-1)
    return _norm(quat_rotate(quat_normalize(quat_conjugate(views.qvec)),
                             d_cam))


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    rows = torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1)
    return rows.reshape(rows.shape[:-1] + (3, 3))


def _K_inv(views: CameraViewsBatch) -> torch.Tensor:
    fx, fy, cx, cy = views.kvec.unbind(-1)
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    Ki = torch.stack([1 / fx, z, -cx / fx, z, 1 / fy, -cy / fy, z, z, o],
                     dim=-1)
    return Ki.reshape(Ki.shape[:-1] + (3, 3))


def compute_essential_matrix(view1: CameraViewsBatch,
                             view2: CameraViewsBatch) -> torch.Tensor:
    """E = [t_rel]x R_rel of the pair, [..., 3, 3]."""
    R1, R2 = quat_to_rotmat(view1.qvec), quat_to_rotmat(view2.qvec)
    relR = R2 @ R1.transpose(-1, -2)
    relT = view2.tvec - torch.einsum("...ij,...j->...i", relR, view1.tvec)
    return _skew(relT) @ relR


def compute_fundamental_matrix(view1: CameraViewsBatch,
                               view2: CameraViewsBatch) -> torch.Tensor:
    """F = K2^-T E K1^-1, [..., 3, 3]."""
    E = compute_essential_matrix(view1, view2)
    return _K_inv(view2).transpose(-1, -2) @ E @ _K_inv(view1)


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


def triangulate_line_with_direction(
        l1: Segments, view1: CameraViewsBatch,
        l2: Segments, view2: CameraViewsBatch,
        direction: torch.Tensor) -> Segments:
    """VP-guided triangulation: the 3D line of known ``direction`` in
    l1's back-projection plane, placed by l2's plane."""
    n1 = get_normal_direction(l1, view1)
    direc = direction - torch.sum(n1 * direction, -1, keepdim=True) * n1
    dnorm = torch.linalg.vector_norm(direc, dim=-1)
    direc = direc / (dnorm[..., None] + EPS)

    perp = cross(n1, direc)
    v1s = view1.ray_direction(l1.start)
    v1e = view1.ray_direction(l1.end)
    a1s = torch.sum(v1s * perp, dim=-1)
    a1e = torch.sum(v1e * perp, dim=-1)
    flip = a1s < 0
    a1s = torch.where(flip, -a1s, a1s)
    a1e = torch.where(flip, -a1e, a1e)
    min_value = 0.001

    C1 = view1.center()
    C2 = view2.center()
    n2 = get_normal_direction(l2, view2)
    c1s = torch.sum(n2 * v1s, dim=-1)
    c1e = torch.sum(n2 * v1e, dim=-1)
    b = torch.sum(n2 * (C2 - C1), dim=-1)
    c1 = c1s
    c2 = c1e * a1s / (a1e + EPS)
    d1s = (c1 + c2) * b / (c1 * c1 + c2 * c2 + EPS)
    d1e = d1s * a1s / (a1e + EPS)

    p_start = v1s * d1s[..., None] + C1
    p_end = v1e * d1e[..., None] + C1
    z_s = view1.projdepth(p_start)
    z_e = view1.projdepth(p_end)
    valid = ((dnorm >= EPS) & (a1s >= min_value) & (a1e >= min_value)
             & (z_s >= EPS) & (z_e >= EPS)
             & (view2.projdepth(p_start) >= EPS)
             & (view2.projdepth(p_end) >= EPS)
             & torch.all(torch.isfinite(p_start), -1)
             & torch.all(torch.isfinite(p_end), -1))
    good = Segments(start=p_start, end=p_end, score=torch.ones_like(z_s),
                    depths=torch.stack([z_s, z_e], dim=-1))
    return _select(valid, good, p_start)


def triangulate_line_with_infinite_line(
        l1: Segments, view1: CameraViewsBatch,
        inf_line: InfiniteLines3d) -> Segments:
    """l1's endpoint rays meet a known 3D line (closest points)."""
    C = view1.center()
    p_start = inf_line.project_from_infinite_line(
        InfiniteLines3d.from_point_direction(C, view1.ray_direction(l1.start)))
    p_end = inf_line.project_from_infinite_line(
        InfiniteLines3d.from_point_direction(C, view1.ray_direction(l1.end)))
    z_s = view1.projdepth(p_start)
    z_e = view1.projdepth(p_end)
    good = Segments(start=p_start, end=p_end, score=torch.ones_like(z_s),
                    depths=torch.stack([z_s, z_e], dim=-1))
    return _select((z_s >= EPS) & (z_e >= EPS), good, p_start)


def _one_point_cost(theta, line, p, v1, v2):
    """Cost and depths of the line through p at angle theta: the two
    rays' points on it, squared distances to ``line`` (nx, ny, alpha)."""
    n = torch.stack([-torch.sin(theta), torch.cos(theta)], dim=-1)
    c = -torch.sum(n * p, dim=-1)

    def lam(v):
        denom = torch.sum(n * v, dim=-1)
        return -c / torch.where(torch.abs(denom) < EPS,
                                torch.full_like(denom, EPS), denom)

    lam1, lam2 = lam(v1), lam(v2)
    lx, ly, lz = line[..., 0], line[..., 1], line[..., 2]
    lnorm = torch.sqrt(lx * lx + ly * ly + EPS)

    def dist(lam_i, v):
        x = lam_i[..., None] * v
        return (lx * x[..., 0] + ly * x[..., 1] + lz) / lnorm

    e1, e2 = dist(lam1, v1), dist(lam2, v2)
    return e1 * e1 + e2 * e2, lam1, lam2


def triangulate_line_with_one_point_2d(line, p, v1, v2, n_grid: int = 64,
                                       n_newton: int = 8):
    """The reduced in-plane problem: (lambda1, lambda2), -1 on failure.

    A grid over the pencil of lines through ``p`` seeds ``n_newton``
    damped Newton steps (the second derivative by central differences of
    the gradient; a step is kept only where it lowers the cost).
    ``line`` [..., 3]; ``p``, ``v1``, ``v2`` [..., 2]."""
    f = lambda th: _one_point_cost(th, line, p, v1, v2)[0]
    thetas = torch.arange(n_grid, dtype=p.dtype, device=p.device) * (
        math.pi / n_grid)
    costs = f(thetas.reshape((n_grid,) + (1,) * (p.dim() - 1)))
    theta = thetas[torch.argmin(costs, dim=0)]

    def df(th):
        with torch.enable_grad():
            th = th.detach().requires_grad_(True)
            return torch.autograd.grad(f(th).sum(), th)[0]

    h = 1e-3
    for _ in range(n_newton):
        g = df(theta)
        hess = (df(theta + h) - df(theta - h)) / (2 * h)
        step = g / torch.where(torch.abs(hess) < EPS,
                               torch.full_like(hess, EPS), hess)
        th_new = theta - torch.clamp(step, -0.05, 0.05)
        theta = torch.where(f(th_new) <= f(theta), th_new, theta)
    _, lam1, lam2 = _one_point_cost(theta, line, p, v1, v2)
    ok = (lam1 > 0) & (lam2 > 0)
    return (torch.where(ok, lam1, torch.full_like(lam1, -1.0)),
            torch.where(ok, lam2, torch.full_like(lam2, -1.0)))


def triangulate_line_with_one_point(l1: Segments, view1: CameraViewsBatch,
                                    l2: Segments, view2: CameraViewsBatch,
                                    point: torch.Tensor) -> Segments:
    """Triangulation through a known 3D point: the in-plane frame of l1's
    back-projection plane, then the reduced problem."""
    n1 = get_normal_direction(l1, view1)
    C1 = view1.center()
    p_proj = point - torch.sum(n1 * (point - C1), -1, keepdim=True) * n1
    v1s = view1.ray_direction(l1.start)
    v1e = view1.ray_direction(l1.end)
    n2 = get_normal_direction(l2, view2)
    alpha = -torch.sum(n2 * view2.center(), dim=-1)
    e0 = v1s
    e1 = _norm(v1e - torch.sum(e0 * v1e, -1, keepdim=True) * e0)
    e2 = _norm(cross(e0, e1))
    R = torch.stack([e0, e1, e2], dim=-1)

    def to_frame(v):
        return torch.einsum("...ij,...i->...j", R, v)

    p_t = to_frame(p_proj - C1)[..., :2]
    n2_t = to_frame(n2)
    alpha_t = alpha + torch.sum(n2 * C1, dim=-1)
    line2d = torch.stack([n2_t[..., 0], n2_t[..., 1], alpha_t], dim=-1)
    v1_t = torch.stack([torch.ones_like(alpha_t), torch.zeros_like(alpha_t)],
                       dim=-1)
    v2_t = _norm(to_frame(v1e)[..., :2])
    lam1, lam2 = triangulate_line_with_one_point_2d(line2d, p_t, v1_t, v2_t)
    z = torch.zeros_like(lam1)[..., None]
    lstart = torch.einsum("...ij,...j->...i", R,
                          torch.cat([v1_t * lam1[..., None], z], -1)) + C1
    lend = torch.einsum("...ij,...j->...i", R,
                        torch.cat([v2_t * lam2[..., None], z], -1)) + C1
    z_s = view1.projdepth(lstart)
    z_e = view1.projdepth(lend)
    valid = ((lam1 > 0) & (lam2 > 0) & (z_s >= EPS) & (z_e >= EPS)
             & (view2.projdepth(lstart) >= EPS)
             & (view2.projdepth(lend) >= EPS))
    good = Segments(start=lstart, end=lend, score=torch.ones_like(z_s),
                    depths=torch.stack([z_s, z_e], dim=-1))
    return _select(valid, good, lstart)


def line_triangulation_covariance(l1: Segments, view1: CameraViewsBatch,
                                  l2: Segments, view2: CameraViewsBatch,
                                  covariance: torch.Tensor) -> torch.Tensor:
    """First-order propagation of the [..., 8, 8] covariance of the
    endpoint pixels (l1.start, l1.end, l2.start, l2.end) through the
    algebraic triangulation to the [..., 6, 6] covariance of the 3D
    endpoints, with the exact Jacobian by forward-mode autodiff."""
    x8 = torch.cat([l1.start, l1.end, l2.start, l2.end], dim=-1)
    batch = torch.broadcast_shapes(x8.shape[:-1], view1.kvec.shape[:-1],
                                   view2.kvec.shape[:-1])
    flat = lambda t: t.expand(batch + t.shape[-1:]).reshape(-1, t.shape[-1])

    def endpoints(x, k1, q1, t1, k2, q2, t2):
        v1 = CameraViewsBatch(k1, q1, t1)
        v2 = CameraViewsBatch(k2, q2, t2)
        c1s, c1e = v1.ray_direction(x[0:2]), v1.ray_direction(x[2:4])
        n2 = cross(v2.ray_direction(x[4:6]), v2.ray_direction(x[6:8]))
        C1 = v1.center()
        bn = torch.sum((v2.center() - C1) * n2)
        t_s = bn / (torch.sum(c1s * n2) + EPS)
        t_e = bn / (torch.sum(c1e * n2) + EPS)
        return torch.cat([C1 + t_s * c1s, C1 + t_e * c1e])

    J = torch.func.vmap(torch.func.jacfwd(endpoints))(
        flat(x8), *(flat(t) for t in (*view1, *view2)))
    J = J.reshape(batch + (6, 8))
    return J @ covariance @ J.transpose(-1, -2)
