"""Hybrid (pose + intrinsics + line + point) bundle adjustment on one card.

The reference's HybridBAEngine hands one sparse problem to Ceres and
picks a Schur solver by image count (DENSE_SCHUR up to 50 images,
SPARSE_SCHUR up to 900, ITERATIVE_SCHUR + SCHUR_JACOBI beyond).  Here one
step is one Gauss-Newton/LM iteration of the joint problem:

  per track (line or point):
    residuals and Jacobians over the landmark tangent (4 | 3) and each
    support's camera tangent (6, + 2 focal)
    eliminate the landmark block (Schur complement)
  the reduced camera system over ``[I*6 poses | C*2 focal]``:
    a dense solve for small scenes, or matrix-free preconditioned CG
    over the per-track terms (the ITERATIVE_SCHUR + SCHUR_JACOBI
    equivalent: the reduced matrix is never built)
  back-substitute the landmark updates

On the card the per-track terms and the reduced system come from kernel
O, CG's product and the back-substitution from kernel P and the cost of
a state from kernel Q (``ops/hybrid_ba.py``, ``csrc/hybrid_ba.cu``); on
the CPU from the plain versions there, which use the helpers below.  The
dense solve, CG's scalar recurrence, the damping and the retractions
stay torch operations.

Residuals: a line's cosine-weighted endpoint-perpendicular distance to
its projection, a point's pixel reprojection error weighted by
``lw_point``.  Constancy flags as the reference's HybridBAConfig; the
focal lengths move only with ``optimize_focal``.  The gauge is fixed by
freezing the first ``n_fixed_poses`` poses.

Over a mesh of d ranks (``parallel/mesh.py``: a 1-D ``DeviceMesh``, one
process a rank) the step takes the global state and track arrays, rows a
multiple of d (the driver pads them with weight 0), and rank r builds
the terms of the r-th contiguous block of track rows, as JAX's
``shard_map`` gives device r its shard.  Per step, on each solver:

  dense: one all_reduce of [g | cost | Hp], D + 1 + D^2 floats
  CG:    one all_reduce of [g | cost | diag0], 2 D + 1 floats, then one
         of D floats a product (P's launches stay per rank)
  both:  one all_gather of the block's new landmark rows (6 a line, 3 a
         point), so every rank returns the global state

Every rank then solves the same camera step from the same summed numbers
(an all_reduce adds each element up once and copies the sum out), so the
ranks end a step with the same state bit for bit and the driver's LM
takes the same decisions everywhere.  The cost is Q on the block, summed
in one all_reduce of a scalar.  d partial sums are added in another
order than one card's, so a d-rank trajectory differs from the one-card
one by rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.optimize import residuals as res
from limap_tpu_torch.optimize.line_ba import (robust_weight,
                                              unpack_minimal_lines)
from limap_tpu_torch.optimize.lm import retract_pose, retract_quat_so2
from limap_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_sum,
                                           block, rank_mesh)


@dataclasses.dataclass(frozen=True)
class HybridBAOptions:
    geometric_alpha: float = 10.0
    loss: str = "cauchy"
    loss_scale: float = 0.25
    damping: float = 1e-3
    n_fixed_poses: int = 1  # gauge fixing
    lw_point: float = 0.1   # hybrid_bundle_adjustment_config.h:37
    constant_pose: bool = False
    constant_line: bool = False
    constant_point: bool = False
    optimize_focal: bool = False  # frees (fx, fy) per camera
    solver: str = "auto"    # auto | dense | cg
    dense_threshold: int = 256  # images; beyond -> CG (ITERATIVE_SCHUR)
    cg_iters: int = 64


class HybridBAState(NamedTuple):
    line_params: torch.Tensor   # [Tl, 6] minimal lines
    point_params: torch.Tensor  # [Tp, 3] points
    pose_params: torch.Tensor   # [I, 7] (qvec, tvec)
    cam_fxfy: torch.Tensor      # [C, 2] focal lengths


def _weighted(r, weight, opts):
    valid = (weight > 0)[..., None]
    r = torch.where(valid, r, torch.zeros_like(r))
    r2 = torch.sum(r * r, dim=-1).detach()
    rw = robust_weight(r2, opts.loss, opts.loss_scale)
    scale = torch.sqrt(weight * rw + 1e-12)[..., None]
    return torch.where(valid, r * scale, torch.zeros_like(r))


def _views(pose_packed, kvec_base, cam_fxfy, cam_index, d_cam):
    """Per-support views with perturbed focal (d_cam [..., 2])."""
    fxfy = cam_fxfy[cam_index] + d_cam
    kvec = torch.cat([fxfy, kvec_base[..., 2:4]], dim=-1)
    return CameraViewsBatch(kvec, pose_packed[..., :4], pose_packed[..., 4:7])


def _schur_terms(r0, J_land, J_cam, damping, land_dim, with_h_ll=False):
    """Landmark elimination, batched over leading track axes.

    r0 [..., S, R]; J_land [..., S, R, L]; J_cam [..., S, R, Dc].
    Returns (H_pp_diag [..., S, Dc, Dc], S_red [..., S, S, Dc, Dc],
    g_red [..., S, Dc], H_ll_inv [..., L, L], b_l [..., L],
    H_cl [..., S, Dc, L]), and with ``with_h_ll`` the undamped H_ll.
    """
    H_ll = torch.einsum("...sra,...srb->...ab", J_land, J_land)
    b_l = torch.einsum("...sra,...sr->...a", J_land, r0)
    H_cl = torch.einsum("...srp,...sra->...spa", J_cam, J_land)
    g_c = torch.einsum("...srp,...sr->...sp", J_cam, r0)
    H_cc_diag = torch.einsum("...srp,...srq->...spq", J_cam, J_cam)
    eye = torch.eye(land_dim, dtype=r0.dtype, device=r0.device)
    H_ll_inv = torch.linalg.inv(H_ll + (damping + 1e-8) * eye)
    A = H_cl @ H_ll_inv[..., None, :, :]
    S_red = -torch.einsum("...spa,...tqa->...stpq", A, H_cl)
    g_red = g_c - torch.einsum("...spa,...a->...sp", A, b_l)
    out = (H_cc_diag, S_red, g_red, H_ll_inv, b_l, H_cl)
    return out + (H_ll,) if with_h_ll else out


def _jacobians(f: Callable, zeros, land_dim: int, opts):
    """r0 and the Jacobians of f(delta_land, delta_pose, delta_focal) at
    zero.  A support's residual depends on its own camera tangent only,
    so one tangent direction set in every support gives each support's
    own block: [..., S, R, L], [..., S, R, Dc]."""
    def directions(argnum, dim):
        basis = torch.eye(dim, dtype=zeros[0].dtype, device=zeros[0].device)

        def one(e):
            tangents = tuple(e.expand(z.shape) if i == argnum
                             else torch.zeros_like(z)
                             for i, z in enumerate(zeros))
            return jvp(f, zeros, tangents)
        return vmap(one, out_dims=(None, -1))(basis)

    r0, J_l = directions(0, land_dim)
    _, J_p = directions(1, 6)
    if opts.optimize_focal:
        _, J_c = directions(2, 2)
        J_cam = torch.cat([J_p, J_c], dim=-1)
    else:
        J_cam = J_p
    if opts.constant_pose:
        J_cam = torch.cat([torch.zeros_like(J_cam[..., :6]),
                           J_cam[..., 6:]], dim=-1)
    return r0, J_l, J_cam


def _damping(lam, like):
    return torch.as_tensor(lam, dtype=like.dtype, device=like.device)


def _line_track_terms(line_params, pose_params, cam_fxfy, kvec, cam_index,
                      img_index, l2d_start, l2d_end, weight,
                      opts: HybridBAOptions, lam=None, with_h_ll=False):
    """Tracks [T] of lines: (r0 [T, S, 2],) + _schur_terms."""
    if lam is None:
        lam = opts.damping
    T, S = img_index.shape
    pose = pose_params[img_index]

    def f(delta_l, delta_p, delta_c):
        lp = retract_quat_so2(line_params, delta_l)
        views = _views(retract_pose(pose, delta_p), kvec, cam_fxfy,
                       cam_index, delta_c)
        line = unpack_minimal_lines(lp)
        r = res.line_geometric_residual(
            line.uvec[:, None], line.wvec[:, None], views,
            Segments(l2d_start, l2d_end), opts.geometric_alpha)
        return _weighted(r, weight, opts)

    z = line_params.new_zeros
    r0, J_l, J_cam = _jacobians(f, (z((T, 4)), z((T, S, 6)), z((T, S, 2))),
                                4, opts)
    if opts.constant_line:
        J_l = torch.zeros_like(J_l)
    return (r0,) + _schur_terms(r0, J_l, J_cam, _damping(lam, r0), 4,
                                with_h_ll)


def _point_track_terms(point, pose_params, cam_fxfy, kvec, cam_index,
                       img_index, p2d, weight, opts: HybridBAOptions,
                       lam=None, with_h_ll=False):
    """Tracks [T] of points: (r0 [T, S, 2],) + _schur_terms."""
    if lam is None:
        lam = opts.damping
    T, S = img_index.shape
    sw = float(np.sqrt(opts.lw_point))
    pose = pose_params[img_index]

    def f(delta_x, delta_p, delta_c):
        x = point + delta_x
        views = _views(retract_pose(pose, delta_p), kvec, cam_fxfy,
                       cam_index, delta_c)
        r = (views.project(x[:, None]) - p2d) * sw
        return _weighted(r, weight, opts)

    z = point.new_zeros
    r0, J_x, J_cam = _jacobians(f, (z((T, 3)), z((T, S, 6)), z((T, S, 2))),
                                3, opts)
    if opts.constant_point:
        J_x = torch.zeros_like(J_x)
    return (r0,) + _schur_terms(r0, J_x, J_cam, _damping(lam, r0), 3,
                                with_h_ll)


def _line_cost(line_params, pose_params, cam_fxfy, kvec, cam_index,
               img_index, l2d_start, l2d_end, weight, opts):
    """Weighted residuals [T, S, 2] of line tracks at a state."""
    views = _views(pose_params[img_index], kvec, cam_fxfy, cam_index,
                   torch.zeros_like(kvec[..., :2]))
    line = unpack_minimal_lines(line_params)
    r = res.line_geometric_residual(line.uvec[:, None], line.wvec[:, None],
                                    views, Segments(l2d_start, l2d_end),
                                    opts.geometric_alpha)
    return _weighted(r, weight, opts)


def _point_cost(point, pose_params, cam_fxfy, kvec, cam_index, img_index,
                p2d, weight, opts):
    """Weighted residuals [T, S, 2] of point tracks at a state."""
    views = _views(pose_params[img_index], kvec, cam_fxfy, cam_index,
                   torch.zeros_like(kvec[..., :2]))
    r = (views.project(point[:, None]) - p2d) * float(np.sqrt(opts.lw_point))
    return _weighted(r, weight, opts)


def _cols_for(img_index, cam_index, n_images, opts):
    """[..., S, Dc] flat column indices into the camera tangent vector."""
    ar = torch.arange(6, device=img_index.device)
    base = img_index.long()[..., None] * 6 + ar
    if not opts.optimize_focal:
        return base
    camc = n_images * 6 + cam_index.long()[..., None] * 2 + ar[:2]
    return torch.cat([base, camc], dim=-1)


def _accumulate_dense(D, cols, H_cc_diag, S_red):
    """Dense reduced matrix from per-track terms (small scenes)."""
    Hp = H_cc_diag.new_zeros((D, D))
    T, S, Dc = cols.shape
    ci = cols[:, :, None, :, None].expand(T, S, S, Dc, Dc)
    cj = cols[:, None, :, None, :].expand(T, S, S, Dc, Dc)
    Hp.index_put_((ci.reshape(-1), cj.reshape(-1)), S_red.reshape(-1),
                  accumulate=True)
    di = cols[:, :, :, None].expand(H_cc_diag.shape)
    dj = cols[:, :, None, :].expand(H_cc_diag.shape)
    Hp.index_put_((di.reshape(-1), dj.reshape(-1)), H_cc_diag.reshape(-1),
                  accumulate=True)
    return Hp


def _scatter_g(D, cols, g_red):
    return g_red.new_zeros(D).index_add_(0, cols.reshape(-1),
                                         g_red.reshape(-1))


def _matvec(v, cols, H_cc_diag, S_red):
    """Reduced-matrix vector product from per-track Schur terms."""
    vc = v[cols]                                          # [T, S, Dc]
    out = torch.einsum("tspq,tsq->tsp", H_cc_diag, vc) \
        + torch.einsum("tsupq,tuq->tsp", S_red, vc)
    return torch.zeros_like(v).index_add_(0, cols.reshape(-1),
                                          out.reshape(-1))


def _solve_cg(g, matvec_fn, precond_inv, iters):
    """Truncated preconditioned conjugate gradient (the SCHUR_JACOBI
    iterative-Schur equivalent).

    The reduced camera system has a near-null scale-gauge direction, so
    plain CG can blow up late in the iteration; this variant freezes the
    iterate on non-positive curvature (Steihaug-style) and on residual
    convergence.  Once frozen the iterate never moves again, so the loop
    ends there."""
    gnorm2 = torch.dot(g, g)
    x = torch.zeros_like(g)
    r = g
    z = precond_inv(r)
    p = z
    for _ in range(iters):
        Ap = matvec_fn(p)
        pAp = torch.dot(p, Ap)
        stop = (pAp <= 1e-12 * torch.dot(p, p)) \
            | (torch.dot(r, r) <= 1e-12 * gnorm2)
        if bool(stop):
            break
        rz = torch.dot(r, z)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond_inv(r)
        beta = torch.dot(r, z) / torch.where(rz == 0, torch.ones_like(rz),
                                             rz)
        p = z + beta * p
    return x


def _on(device, data):
    return tuple(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                 else x, device=device) for x in data)


def _state_on(device, state):
    return HybridBAState(*_on(device, state))


def _block(land, data, ranks):
    """The rank's contiguous block of a kind's track rows (all of them
    on one card)."""
    if ranks is None:
        return land, data
    rows = block(land.shape[0], ranks)
    return land[rows], tuple(x[rows] for x in data)


def _collectives(ranks):
    """(psum, gather) over the mesh's ranks: each takes tensors and
    returns a list, summed over the ranks or the blocks' rows gathered in
    rank order; on one card both hand their tensors back."""
    if ranks is None:
        same = lambda *xs: list(xs)
        return same, same
    return (lambda *xs: all_reduce_sum(xs, ranks),
            lambda *xs: all_gather_rows(xs, ranks))


def make_hybrid_ba_step(mesh, n_images: int, n_cameras: int = 1,
                        opts: HybridBAOptions = HybridBAOptions(),
                        device=None):
    """The BA step.

    Returned fn: (state, line_data, point_data, lam=None) ->
    (new_state, cost), cost the sum of squares at ``state``.
    line_data: (kvec [Tl,S,4], cam_index [Tl,S], img_index [Tl,S],
                l2d_start, l2d_end, weight)
    point_data: (kvec [Tp,Sp,4], cam_index, img_index, p2d [Tp,Sp,2],
                 weight) -- a track of weight 0 when there are no points.
    ``lam`` is the damping (``opts.damping`` when None), passed to the
    kernels as an argument, so nothing is rebuilt between iterations.
    ``mesh``: None (one card) or a ``DeviceMesh`` of d ranks (see the
    module docstring; the track rows a multiple of d).
    """
    from limap_tpu_torch.ops import hybrid_ba as O
    ranks = rank_mesh(mesh)
    psum, gather = _collectives(ranks)
    device = resolve_device(device)
    D = n_images * 6 + (n_cameras * 2 if opts.optimize_focal else 0)
    use_dense = opts.solver == "dense" or (
        opts.solver == "auto" and n_images <= opts.dense_threshold)
    ar = torch.arange(D, device=device)
    fixed = ar < opts.n_fixed_poses * 6
    if opts.constant_pose:
        fixed = fixed | (ar < n_images * 6)
    eye = torch.eye(D, device=device)

    def run(state, line_data, point_data, lam=None):
        if lam is None:
            lam = opts.damping
        state = _state_on(device, state)
        line_data = _on(device, line_data)
        point_data = _on(device, point_data)
        lines, line_data = _block(state.line_params, line_data, ranks)
        points, point_data = _block(state.point_params, point_data, ranks)
        kv_l, ci_l, ii_l, l2s, l2e, w_l = line_data
        kv_p, ci_p, ii_p, p2d, w_p = point_data
        lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
        tl = O.hybrid_terms("line", lines, state.pose_params,
                            state.cam_fxfy, kv_l, ci_l, ii_l, (l2s, l2e),
                            w_l, opts, lam_t, n_images, n_cameras,
                            use_dense)
        tp = O.hybrid_terms("point", points, state.pose_params,
                            state.cam_fxfy, kv_p, ci_p, ii_p, (p2d,), w_p,
                            opts, lam_t, n_images, n_cameras, use_dense)
        if use_dense:
            gp, cost, Hp = psum(tl.g + tp.g, tl.cost + tp.cost,
                                tl.Hp + tp.Hp)
        else:
            gp, cost, diag0 = psum(tl.g + tp.g, tl.cost + tp.cost,
                                   tl.diag0 + tp.diag0)
        g = torch.where(fixed, torch.zeros_like(gp), gp)
        if use_dense:
            A = Hp + lam_t * torch.diag(torch.clamp(torch.diagonal(Hp),
                                                    min=1e-8)) + 1e-8 * eye
            A = torch.where(fixed[:, None] | fixed[None, :], eye, A)
            delta = -torch.linalg.solve(A, g)
        else:
            # matrix-free CG with a Jacobi preconditioner: the reduced
            # matrix is applied from the per-track terms
            # (ITERATIVE_SCHUR + SCHUR_JACOBI), one all_reduce a product
            damp = lam_t * torch.clamp(diag0, min=1e-8) + 1e-8
            inv_diag = torch.where(fixed, torch.ones_like(diag0),
                                   1.0 / (diag0 + damp))

            def matvec_fn(v):
                v = torch.where(fixed, torch.zeros_like(v), v)
                out, = psum(O.hybrid_apply(tl, v) + O.hybrid_apply(tp, v))
                out = out + damp * v
                return torch.where(fixed, v, out)

            delta = -_solve_cg(g, matvec_fn, lambda r: inv_diag * r,
                               opts.cg_iters)
        dp = delta[:n_images * 6].reshape(n_images, 6)
        if opts.constant_pose:
            dp = torch.zeros_like(dp)
        new_pose = retract_pose(state.pose_params, dp)
        if opts.optimize_focal:
            new_fxfy = state.cam_fxfy + delta[n_images * 6:].reshape(
                n_cameras, 2)
        else:
            new_fxfy = state.cam_fxfy
        # back-substitute the landmark updates
        d_line = O.hybrid_apply(tl, delta, backsub=True)
        if opts.constant_line:
            d_line = torch.zeros_like(d_line)
        d_pt = O.hybrid_apply(tp, delta, backsub=True)
        if opts.constant_point:
            d_pt = torch.zeros_like(d_pt)
        new_lines, new_points = gather(retract_quat_so2(lines, d_line),
                                       points + d_pt)
        return HybridBAState(new_lines, new_points, new_pose,
                             new_fxfy), cost

    return run


def make_hybrid_ba_cost(mesh, opts: HybridBAOptions = HybridBAOptions(),
                        device=None):
    """Residual-only cost of a HybridBAState (no Jacobians): the driver's
    LM accept/reject loop evaluates candidate steps with it.  The card's
    kernel sums in a fixed order, so a state's cost is the same number
    every time.  Over a mesh: Q on the rank's block, summed over the
    ranks."""
    from limap_tpu_torch.ops import hybrid_ba as O
    ranks = rank_mesh(mesh)
    psum, _ = _collectives(ranks)
    device = resolve_device(device)

    def cost(state, line_data, point_data):
        state = _state_on(device, state)
        lines, line_data = _block(state.line_params,
                                  _on(device, line_data), ranks)
        points, point_data = _block(state.point_params,
                                    _on(device, point_data), ranks)
        c, = psum(O.hybrid_cost(state._replace(line_params=lines,
                                               point_params=points),
                                line_data, point_data, opts))
        return c

    return cost
