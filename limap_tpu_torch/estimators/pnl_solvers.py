"""Batched point-line minimal absolute-pose solvers: p2p1ll, p1p2ll, p3ll.

Every constraint left after eliminating the translation (and a point's
depth) is linear in the rotation's entries, Tr(C R) = 0 for a 3x3 C
built from the data; with one line-direction constraint n1.(R v1) = 0
this leaves the root finder of :mod:`limap_tpu_torch.ops.trace_roots`.
Each solver runs it twice per sample (two anchor lines, or the two
points swapped, to dodge the fold of one anchor) and returns the union
of the roots; both runs of all samples of one solver type go to the root
finder as one batch, so one kernel launch serves them.

Conventions: world-to-camera x_cam = R x_world + t; 2D lines enter as
camera-frame back-projection plane normals n, 3D lines as a point P and
a unit direction V.
"""

from __future__ import annotations

import torch

from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.ops.trace_roots import (alpha_grid, any_perp, normalize,
                                             trace_roots)

_EPS = 1e-12


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def solve_two_trace_constraints(v1, n1, C2, C3, n_grid: int = 256,
                                n_bisect: int = 48, n_roots: int = 8):
    """All rotations with n1.(R v1) = 0, Tr(C2 R) = 0, Tr(C3 R) = 0, for
    a batch: v1, n1 [B, 3], C2, C3 [B, 3, 3].  Returns (R [B, 2 n_roots,
    3, 3], valid [B, 2 n_roots])."""
    C2 = C2 / (torch.linalg.matrix_norm(C2)[..., None, None] + _EPS)
    C3 = C3 / (torch.linalg.matrix_norm(C3)[..., None, None] + _EPS)
    alphas = torch.as_tensor(alpha_grid(n_grid), device=v1.device)
    return trace_roots(v1.contiguous(), n1.contiguous(), C2.contiguous(),
                       C3.contiguous(), alphas, n_bisect, n_roots)


def _two_runs(v1, n1, C2, C3, n_grid, n_roots):
    """Both runs of every sample ([2, H, ...] inputs) as one batch;
    returns R [H, 4 n_roots, 3, 3], ok [H, 4 n_roots] (run 0's roots
    first)."""
    H = v1.shape[1]
    R, ok = solve_two_trace_constraints(
        v1.reshape(2 * H, 3), n1.reshape(2 * H, 3),
        C2.reshape(2 * H, 3, 3), C3.reshape(2 * H, 3, 3),
        n_grid=n_grid, n_roots=n_roots)
    S = 2 * n_roots
    R = R.reshape(2, H, S, 3, 3).transpose(0, 1).reshape(H, 2 * S, 3, 3)
    ok = ok.reshape(2, H, S).transpose(0, 1).reshape(H, 2 * S)
    return R, ok


def p3ll(n, P, V, n_grid: int = 256, n_roots: int = 8):
    """Pose from 3 lines, n/P/V [H, 3, 3].  Returns (R [H, 4 n_roots, 3,
    3], t [H, 4 n_roots, 3], valid [H, 4 n_roots]); each line serves
    once as the anchor of the rotation family in two runs."""
    n = normalize(n)
    V = normalize(V)
    o = [_outer(V[:, i], n[:, i]) for i in range(3)]
    R, ok = _two_runs(torch.stack([V[:, 0], V[:, 1]]),
                      torch.stack([n[:, 0], n[:, 1]]),
                      torch.stack([o[1], o[2]]), torch.stack([o[2], o[0]]),
                      n_grid, n_roots)
    # n_i . (R P_i + t) = 0  ->  N t = -[n_i . (R P_i)]
    RP = torch.einsum("hsij,hkj->hski", R, P)
    rhs = -torch.einsum("hkj,hskj->hsk", n, RP)
    N = n[:, None].expand(R.shape) + _EPS * torch.eye(
        3, dtype=n.dtype, device=n.device)
    # a singular system (a repeated line in the sample) gives a non-finite
    # t, as jnp.linalg.solve does, instead of raising
    t = torch.linalg.solve_ex(N, rhs[..., None])[0][..., 0]
    return R, t, ok


def p1p2ll(x, X, n, P, V, n_grid: int = 256, n_roots: int = 8):
    """Pose from 1 point (bearing x, world X: [H, 3]) and 2 lines (n/P/V
    [H, 2, 3]), with both lines as the anchor."""
    x = normalize(x)
    n = normalize(n)
    V = normalize(V)
    # depth eliminated across the two line-point constraints:
    # (n1.(R(P1-X))) (n2.x) - (n2.(R(P2-X))) (n1.x) = 0
    n1x = _dot(n[:, 0], x)
    n2x = _dot(n[:, 1], x)
    C3 = (n2x[:, None, None] * _outer(P[:, 0] - X, n[:, 0])
          - n1x[:, None, None] * _outer(P[:, 1] - X, n[:, 1]))
    R, ok = _two_runs(torch.stack([V[:, 0], V[:, 1]]),
                      torch.stack([n[:, 0], n[:, 1]]),
                      torch.stack([_outer(V[:, 1], n[:, 1]),
                                   _outer(V[:, 0], n[:, 0])]),
                      torch.stack([C3, C3]), n_grid, n_roots)
    # the depth from line 1, or from line 2 when n1.x ~ 0
    r1 = torch.einsum("hi,hsij,hj->hs", n[:, 0], R, P[:, 0] - X)
    r2 = torch.einsum("hi,hsij,hj->hs", n[:, 1], R, P[:, 1] - X)

    def safe(v):
        return torch.where(torch.abs(v) < _EPS, torch.full_like(v, _EPS), v)

    use1 = (torch.abs(n1x) >= torch.abs(n2x))[:, None]
    depth = torch.where(use1, -r1 / safe(n1x)[:, None],
                        -r2 / safe(n2x)[:, None])
    t = depth[..., None] * x[:, None] - torch.einsum("hsij,hj->hsi", R, X)
    return R, t, ok & (depth > 0)


def p2p1ll(x, X, n, P, V, n_grid: int = 256, n_roots: int = 8):
    """Pose from 2 points (x/X [H, 2, 3]) and 1 line (n/P/V [H, 3]),
    with the translation eliminated through either point."""
    x = normalize(x)
    n = normalize(n)
    V = normalize(V)
    order = (x, X), (x.flip(1), X.flip(1))
    C2s, C3s, geo = [], [], []
    for xs, Xs in order:
        dX = Xs[:, 1] - Xs[:, 0]
        dP = P - Xs[:, 0]
        n_x1 = _dot(n, xs[:, 0])
        n_x1s = torch.where(torch.abs(n_x1) < _EPS,
                            torch.full_like(n_x1, _EPS), n_x1)
        # w = R dX + d1 x1 parallel to x2: its components on (y1, y2)
        y1 = any_perp(xs[:, 1])
        y2 = cross(xs[:, 1], y1)
        ndP = _outer(dP, n)
        C2s.append(_outer(dX, y1) - (_dot(y1, xs[:, 0]) / n_x1s)[:, None,
                                                                 None] * ndP)
        C3s.append(_outer(dX, y2) - (_dot(y2, xs[:, 0]) / n_x1s)[:, None,
                                                                 None] * ndP)
        geo.append((xs, Xs, dP, n_x1s))
    R, ok = _two_runs(torch.stack([V, V]), torch.stack([n, n]),
                      torch.stack(C2s), torch.stack(C3s), n_grid, n_roots)
    S = 2 * n_roots
    ts, oks = [], []
    for k, (xs, Xs, dP, n_x1s) in enumerate(geo):
        Rk = R[:, k * S:(k + 1) * S]
        # d1 = -(n . R dP) / (n . x1)
        d1 = -torch.einsum("hi,hsij,hj->hs", n, Rk, dP) / n_x1s[:, None]
        t = d1[..., None] * xs[:, None, 0] - torch.einsum(
            "hsij,hj->hsi", Rk, Xs[:, 0])
        # the second point in front of the camera
        d2 = torch.einsum("hi,hsi->hs", xs[:, 1], torch.einsum(
            "hsij,hj->hsi", Rk, Xs[:, 1]) + t)
        ts.append(t)
        oks.append(ok[:, k * S:(k + 1) * S] & (d1 > 0) & (d2 > 0))
    return R, torch.cat(ts, dim=1), torch.cat(oks, dim=1)


def line2d_to_normal(l2d_start, l2d_end, kvec):
    """Unit back-projection plane normal [..., 3] (camera frame) of a
    pixel segment; kvec = (fx, fy, cx, cy)."""
    def norm_coords(p):
        u = (p[..., 0] - kvec[..., 2]) / kvec[..., 0]
        v = (p[..., 1] - kvec[..., 3]) / kvec[..., 1]
        return torch.stack([u, v, torch.ones_like(u)], dim=-1)

    return normalize(cross(norm_coords(l2d_start), norm_coords(l2d_end)))
