"""Quaternion helpers (w, x, y, z), broadcasting over leading dims."""

from __future__ import annotations

import torch

EPS = 1e-12


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last dim (operands of
    different ranks too, which torch.linalg.cross refuses)."""
    if a.dim() != b.dim():
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3]; the input is normalized first."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4], branch-free Shepperd extraction with the
    largest pivot chosen per row (first on ties), sign fixed to w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    pivots = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp(pivots, min=EPS))
    sw, sx, sy, sz = s.unbind(-1)
    cands = torch.stack([
        torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                     (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                     (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                     (m12 + m21) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                     (m12 + m21) / sz, 0.25 * sz], -1)], dim=-2)
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Exponential map [..., 3] -> [..., 4], with the small-angle series
    so forward-mode derivatives at zero stay finite."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + EPS)
    half = 0.5 * theta
    k = torch.where(theta2 > 1e-12, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    return torch.cat([torch.cos(half), k * aa], dim=-1)


def so2_rotate(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate unit 2-vectors w [..., 2] by theta [...]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * w[..., 0] - s * w[..., 1],
                        s * w[..., 0] + c * w[..., 1]], dim=-1)


def pose_center(qvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """Camera centre -R^T t of qvec [..., 4], tvec [..., 3]."""
    R = quat_to_rotmat(qvec)
    return -torch.einsum("...ji,...j->...i", R, tvec)


def projdepth(qvec: torch.Tensor, tvec: torch.Tensor,
              p3d: torch.Tensor) -> torch.Tensor:
    """Depth of world point(s) in the camera frame (z of R p + t)."""
    return (quat_rotate(qvec, p3d) + tvec)[..., 2]
