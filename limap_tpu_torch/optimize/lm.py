"""Batched Levenberg-Marquardt over many small independent problems.

Each row of ``params`` is one problem (one 4-DOF line per track in line
BA, one 6-DOF pose per local-optimization chain in localization).  The
Jacobian w.r.t. the tangent comes from forward-mode AD: one
``torch.func.jvp`` for all rows, vmapped over the D tangent directions
(eager forward-mode AD pays a large overhead per operation, so one pass
for all directions instead of one per direction); each iteration solves
the [T, D, D] damped normal equations by an unrolled Cholesky and
accepts or rejects per row.

This eager loop is the plain version of the two hand kernels that carry
the port's paths on the card, H (line BA, ``ops/lm_line_ba.py``) and I
(the localization's pose solve, ``ops/lm_jointloc.py``); it stays the
solver for arbitrary residuals.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from limap_tpu_torch.base.pose import (axis_angle_to_quat, quat_multiply,
                                       so2_rotate)


# the damping schedule (lambda init, up, down, min, max) of lm_solve and
# of the kernels, and the robust losses of line_ba.robust_weight in the
# order the kernels take them
LAMBDAS = (1e-3, 4.0, 0.5, 1e-9, 1e6)
LOSSES = ("trivial", "cauchy", "huber")


class LMResult(NamedTuple):
    params: torch.Tensor      # [T, P] final parameters
    cost0: torch.Tensor       # [T] initial cost
    cost: torch.Tensor        # [T] final cost
    n_accepted: torch.Tensor  # [T] accepted steps


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve small SPD systems [..., D, D] x = [..., D] by an unrolled
    Cholesky (pivots clamped at 1e-12) and two substitutions."""
    D = A.shape[-1]
    L = [[None] * D for _ in range(D)]
    for j in range(D):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        for i in range(j + 1, D):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * D
    for i in range(D):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def normal_equations(params: torch.Tensor, residual_fn: Callable,
                     retract_fn: Callable, tangent_dim: int, aux=()):
    """J^T J [T, D, D], J^T r [T, D] and sum r^2 [T] at ``params``, J
    the residual's Jacobian through the retraction at delta = 0."""
    T, D = params.shape[0], tangent_dim
    basis = torch.eye(D, dtype=params.dtype, device=params.device)
    zero = torch.zeros((T, D), dtype=params.dtype, device=params.device)
    f = lambda delta: residual_fn(retract_fn(params, delta), *aux)
    r, J = vmap(lambda e: jvp(f, (zero,), (e.expand(T, D),)),
                out_dims=(None, -1))(basis)                  # J [T, R, D]
    JTJ = J.transpose(1, 2) @ J
    JTr = (J.transpose(1, 2) @ r[..., None])[..., 0]
    return JTJ, JTr, torch.sum(r * r, dim=1)


def lm_solve(params0: torch.Tensor, residual_fn: Callable,
             retract_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
             tangent_dim: int, aux=(), num_iterations: int = 20,
             lambda_init: float = LAMBDAS[0], lambda_up: float = LAMBDAS[1],
             lambda_down: float = LAMBDAS[2], lambda_min: float = LAMBDAS[3],
             lambda_max: float = LAMBDAS[4],
             trace: Optional[list] = None) -> LMResult:
    """Minimize sum(residual_fn(p, *aux)^2) independently per row.

    residual_fn: ([T, P], *aux) -> [T, R], batched over rows;
    retract_fn: ([T, P], [T, D]) -> [T, P].  With ``trace`` a list, each
    iteration appends its [T, 2 + 2P] rows (cost, new cost, params, new
    params), the layout of the kernels' trace.
    """
    T = params0.shape[0]
    cost_of = lambda p: torch.sum(residual_fn(p, *aux) ** 2, dim=1)
    params = params0
    lam = torch.full((T,), lambda_init, dtype=params0.dtype,
                     device=params0.device)
    cost0 = cost_of(params0)
    cost = cost0
    n_acc = torch.zeros((T,), dtype=torch.int32, device=params0.device)
    for _ in range(num_iterations):
        JTJ, JTr, cost = normal_equations(params, residual_fn, retract_fn,
                                          tangent_dim, aux)
        diag = torch.diagonal(JTJ, dim1=-2, dim2=-1)
        A = JTJ + torch.diag_embed(lam[:, None] * torch.clamp(diag, min=1e-8))
        delta = torch.nan_to_num(-solve_spd(A, JTr))
        new_params = retract_fn(params, delta)
        new_cost = cost_of(new_params)
        accept = new_cost < cost
        if trace is not None:
            trace.append(torch.cat([cost[:, None], new_cost[:, None],
                                    params, new_params], 1))
        params = torch.where(accept[:, None], new_params, params)
        lam = torch.clamp(torch.where(accept, lam * lambda_down,
                                      lam * lambda_up),
                          lambda_min, lambda_max)
        cost = torch.where(accept, new_cost, cost)
        n_acc = n_acc + accept.to(torch.int32)
    return LMResult(params, cost0, cost, n_acc)


def retract_quat_so2(params: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """Minimal line retraction: params [..., 6] = (uvec[4], wvec[2]),
    delta [..., 4] = (so(3) tangent[3], so(2) angle[1])."""
    new_u = quat_multiply(axis_angle_to_quat(delta[..., :3]),
                          params[..., :4])
    new_w = so2_rotate(params[..., 4:6], delta[..., 3])
    return torch.cat([new_u, new_w], dim=-1)


def retract_pose(params: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Pose retraction: params [..., 7] = (qvec[4], tvec[3]), delta
    [..., 6] = (so(3) tangent[3], translation[3])."""
    new_q = quat_multiply(axis_angle_to_quat(delta[..., :3]),
                          params[..., :4])
    return torch.cat([new_q, params[..., 4:7] + delta[..., 3:6]], dim=-1)
