"""Batched P3P minimal solver (Grunert) and rigid alignment.

The depth quartic is solved by :mod:`limap_tpu_torch.ops.polynomial`
and each of its up to four solutions is turned into a pose by a
3-point Kabsch alignment, for a whole batch of minimal samples at once.
"""

from __future__ import annotations

import torch

from limap_tpu_torch.ops.polynomial import solve_quartic_real

_EPS = 1e-12


def kabsch(src: torch.Tensor, dst: torch.Tensor):
    """Rigid transform dst = R @ src + t for [..., N, 3] point sets."""
    cs = src.mean(dim=-2, keepdim=True)
    cd = dst.mean(dim=-2, keepdim=True)
    H = (src - cs).transpose(-1, -2) @ (dst - cd)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    # R = V diag(1, 1, det) U^T with H = src_c^T dst_c
    R = (V * D[..., None, :]) @ Ut
    t = cd[..., 0, :] - (R @ cs[..., 0, :, None])[..., 0]
    return R, t


def p3p(bearings: torch.Tensor, points: torch.Tensor):
    """Grunert P3P, batched.

    Args:
      bearings: [..., 3, 3] unit rays in the camera frame.
      points:   [..., 3, 3] world points.

    Returns (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]): up to 4
    solutions with the world-to-camera convention x_cam = R x_world + t.
    """
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    X1, X2, X3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    a2 = torch.sum((X2 - X3) ** 2, -1)
    b2 = torch.sum((X1 - X3) ** 2, -1)
    c2 = torch.sum((X1 - X2) ** 2, -1)
    ca = torch.sum(f2 * f3, -1)  # cos(alpha)
    cb = torch.sum(f1 * f3, -1)  # cos(beta)
    cg = torch.sum(f1 * f2, -1)  # cos(gamma)

    b2s = torch.where(b2 < _EPS, torch.full_like(b2, _EPS), b2)
    acb = (a2 - c2) / b2s
    apb = (a2 + c2) / b2s

    A4 = (acb - 1.0) ** 2 - 4.0 * c2 / b2s * ca ** 2
    A3 = 4.0 * (acb * (1.0 - acb) * cb - (1.0 - apb) * ca * cg
                + 2.0 * c2 / b2s * ca ** 2 * cb)
    A2 = 2.0 * (acb ** 2 - 1.0 + 2.0 * acb ** 2 * cb ** 2
                + 2.0 * (b2 - c2) / b2s * ca ** 2
                - 4.0 * apb * ca * cb * cg
                + 2.0 * (b2 - a2) / b2s * cg ** 2)
    A1 = 4.0 * (-acb * (1.0 + acb) * cb + 2.0 * a2 / b2s * cg ** 2 * cb
                - (1.0 - apb) * ca * cg)
    A0 = (1.0 + acb) ** 2 - 4.0 * a2 / b2s * cg ** 2

    A4s = torch.where(torch.abs(A4) < _EPS, torch.full_like(A4, _EPS), A4)
    v = solve_quartic_real(A3 / A4s, A2 / A4s, A1 / A4s, A0 / A4s)  # [.., 4]
    v_ok = torch.isfinite(v) & (v > 0)
    v = torch.nan_to_num(v, nan=1.0)

    cbx, cax, cgx = cb[..., None], ca[..., None], cg[..., None]
    acbx = acb[..., None]
    denom_u = 2.0 * (cgx - v * cax)
    denom_u = torch.where(torch.abs(denom_u) < _EPS,
                          torch.full_like(denom_u, _EPS), denom_u)
    u = ((-1.0 + acbx) * v ** 2 - 2.0 * acbx * cbx * v + 1.0 + acbx) / denom_u

    s1_sq = b2[..., None] / torch.clamp(1.0 + v ** 2 - 2.0 * v * cbx,
                                        min=_EPS)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=0.0))
    s2 = u * s1
    s3 = v * s1
    ok = v_ok & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points per solution: [..., 4, 3 points, 3]
    cam_pts = torch.stack(
        [s1[..., None] * f1[..., None, :],
         s2[..., None] * f2[..., None, :],
         s3[..., None] * f3[..., None, :]], dim=-2)
    world_pts = torch.stack([X1, X2, X3], dim=-2)[..., None, :, :]
    R, t = kabsch(world_pts.expand(cam_pts.shape), cam_pts)
    return R, t, ok
