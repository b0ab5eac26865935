"""Kernels L and M: the line step and the point step of the joint
point-line-VP association, each a whole LM solve in one launch.

Kernel L (``solve_lines``) refines T minimal lines ``params0 [T, 6]``
(tangent 4) against, per track, its supports' geometric term (the line
BA's, robust), the distance to up to A associated points gathered by
index from the current points ``[P, 3]``, and the sine to up to A
associated VPs gathered from ``[V, 3]``.

Kernel M (``solve_points``) refines P points ``params0 [P, 3]``
(additive, tangent 3) against their reprojection error in up to S
views, gathered by image index from the full views ``[N, ...]``, times
sqrt(``lw_point``), and their distance to up to A associated lines
unpacked from the current minimal lines ``[T, 6]``.

CUDA tensors launch ``csrc/lm_assoc.cu`` (one warp a row, Jets for the
Jacobian); CPU tensors take the eager ``lm_solve`` with
:func:`line_residual` / :func:`point_residual`.
``normal_equations_lines`` / ``normal_equations_points`` are the check
entries (0 iterations).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import (InfiniteLines3d,
                                                minimal_to_plucker)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.optimize import lm

SOURCE = "lm_assoc.cu"
LINE_D, LINE_P = 4, 6
POINT_D, POINT_P = 3, 3


class LineAssocData(NamedTuple):
    kvec: torch.Tensor     # [T, S, 4] the supports' views
    qvec: torch.Tensor     # [T, S, 4]
    tvec: torch.Tensor     # [T, S, 3]
    p_start: torch.Tensor  # [T, S, 2]
    p_end: torch.Tensor    # [T, S, 2]
    weights: torch.Tensor  # [T, S]
    pt_idx: torch.Tensor   # [T, A] int32 rows of ``points``
    pt_w: torch.Tensor     # [T, A] (0: empty slot)
    vp_idx: torch.Tensor   # [T, A] int32 rows of ``vps``
    vp_w: torch.Tensor     # [T, A]
    points: torch.Tensor   # [P, 3] the current points (at least 1 row)
    vps: torch.Tensor      # [V, 3] the current VP directions (at least 1)


class PointAssocData(NamedTuple):
    views_k: torch.Tensor  # [N, 4] every view
    views_q: torch.Tensor  # [N, 4]
    views_t: torch.Tensor  # [N, 3]
    img_index: torch.Tensor  # [P, S] int32 view rows
    p2d: torch.Tensor      # [P, S, 2]
    mask: torch.Tensor     # [P, S] bool
    ln_idx: torch.Tensor   # [P, A] int32 rows of ``lines``
    ln_w: torch.Tensor     # [P, A]
    lines: torch.Tensor    # [T, 6] the current minimal lines (at least 1)


LINE_SHARED = (10, 11)
POINT_SHARED = (0, 1, 2, 8)


@dataclasses.dataclass(frozen=True)
class AssocTerms:
    """The association's weights (GlobalAssociatorConfig's)."""

    geometric_alpha: float = 10.0
    loss: str = "cauchy"
    loss_scale: float = 0.25
    lw_point: float = 0.1
    lw_pointline: float = 10.0
    lw_vpline: float = 1.0
    use_vps: bool = True   # the VP-line term (the JAX package drops it
    #                        when there is no VP)


def _shared(t, i, shared):
    return t[None] if i in shared else t


def line_residual(terms: AssocTerms):
    """Batched: params [T, 6] and :class:`LineAssocData` (the shared
    tables with a leading [1]) -> [T, 2S + A (+ A)]."""
    from limap_tpu_torch.optimize import residuals as res
    from limap_tpu_torch.optimize.line_ba import (robust_weight,
                                                  unpack_minimal_lines)

    def residual(params, *data):
        x = LineAssocData(*data)
        T = params.shape[0]
        line = unpack_minimal_lines(params)
        w = x.weights
        r = res.line_geometric_residual(
            line.uvec[:, None], line.wvec[:, None],
            CameraViewsBatch(x.kvec, x.qvec, x.tvec),
            Segments(x.p_start, x.p_end), terms.geometric_alpha)
        valid = (w > 0)[..., None]
        r = torch.where(valid, r, torch.zeros_like(r))
        rw = robust_weight(torch.sum(r * r, -1).detach(), terms.loss,
                           terms.loss_scale)
        r = torch.where(valid, r * torch.sqrt(w * rw + 1e-12)[..., None],
                        torch.zeros_like(r))
        out = [r.reshape(T, -1)]
        d, m = minimal_to_plucker(line.uvec, line.wvec)
        pd = InfiniteLines3d(d[:, None], m[:, None]).point_distance(
            x.points[0][x.pt_idx.long()])
        out.append(torch.where(x.pt_w > 0, pd * torch.sqrt(
            terms.lw_pointline * x.pt_w), torch.zeros_like(pd)))
        if terms.use_vps:
            vdir = x.vps[0][x.vp_idx.long()]
            cr = cross(d[:, None].expand(vdir.shape), vdir)
            sine = torch.linalg.vector_norm(cr, dim=-1) / (
                torch.linalg.vector_norm(vdir, dim=-1) + 1e-12)
            out.append(torch.where(x.vp_w > 0, sine * torch.sqrt(
                terms.lw_vpline * x.vp_w), torch.zeros_like(sine)))
        return torch.cat(out, 1)

    return residual


def point_residual(terms: AssocTerms):
    """Batched: params [P, 3] and :class:`PointAssocData` (the shared
    tables with a leading [1]) -> [P, 2S + A]."""
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines

    def residual(xyz, *data):
        x = PointAssocData(*data)
        P = xyz.shape[0]
        vb = CameraViewsBatch(x.views_k[0], x.views_q[0],
                              x.views_t[0]).select(x.img_index)
        r = (vb.project(xyz[:, None]) - x.p2d) * math.sqrt(terms.lw_point)
        r = torch.where(x.mask[..., None], r, torch.zeros_like(r))
        mline = unpack_minimal_lines(x.lines[0][x.ln_idx.long()])
        d, m = minimal_to_plucker(mline.uvec, mline.wvec)
        pd = InfiniteLines3d(d, m).point_distance(
            xyz[:, None].expand(d.shape))
        pd = torch.where(x.ln_w > 0, pd * torch.sqrt(
            terms.lw_pointline * x.ln_w), torch.zeros_like(pd))
        return torch.cat([r.reshape(P, -1), pd], 1)

    return residual


def line_aux(data: LineAssocData):
    return tuple(_shared(t, i, LINE_SHARED) for i, t in enumerate(data))


def point_aux(data: PointAssocData):
    return tuple(_shared(t, i, POINT_SHARED) for i, t in enumerate(data))


def retract_add(params, delta):
    return params + delta


def solve_lines_plain(params0, data, terms, num_iterations=10, trace=None):
    return lm.lm_solve(params0, line_residual(terms), lm.retract_quat_so2,
                       LINE_D, line_aux(data), num_iterations=num_iterations,
                       trace=trace)


def solve_points_plain(params0, data, terms, num_iterations=10, trace=None):
    return lm.lm_solve(params0, point_residual(terms), retract_add, POINT_D,
                       point_aux(data), num_iterations=num_iterations,
                       trace=trace)


def normal_equations_lines_plain(params0, data, terms):
    return lm.normal_equations(params0, line_residual(terms),
                               lm.retract_quat_so2, LINE_D, line_aux(data))


def normal_equations_points_plain(params0, data, terms):
    return lm.normal_equations(params0, point_residual(terms), retract_add,
                               POINT_D, point_aux(data))


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # params0, the 12 inputs, T, S, A, P, V, hp, loss, use_vps, n_iter,
    # params, cost0, cost, n_acc, trace, ne, stream
    lib.lm_assoc_lines_launch.argtypes = [ptr] * 13 + [i64] * 5 + [ptr] \
        + [i64] * 3 + [ptr] * 7
    lib.lm_assoc_lines_launch.restype = ctypes.c_int
    # params0, the 9 inputs, P, S, A, N, T, hp, n_iter, params, cost0,
    # cost, n_acc, trace, ne, stream
    lib.lm_assoc_points_launch.argtypes = [ptr] * 10 + [i64] * 5 + [ptr] \
        + [i64] + [ptr] * 7
    lib.lm_assoc_points_launch.restype = ctypes.c_int
    return lib


def check_lines(params0, data: LineAssocData):
    T, dev = params0.shape[0], params0.device
    S, A = data.weights.shape[1], data.pt_w.shape[1]
    P, V = data.points.shape[0], data.vps.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_tensor("params0", params0, f32, (T, LINE_P), dev)
    shapes = dict(kvec=(T, S, 4), qvec=(T, S, 4), tvec=(T, S, 3),
                  p_start=(T, S, 2), p_end=(T, S, 2), weights=(T, S),
                  pt_idx=(T, A), pt_w=(T, A), vp_idx=(T, A), vp_w=(T, A),
                  points=(P, 3), vps=(V, 3))
    for name, t in zip(LineAssocData._fields, data):
        check_tensor(name, t, i32 if name.endswith("_idx") else f32,
                     shapes[name], dev)
    if P < 1 or V < 1:
        raise ValueError("the point and VP tables need a row at least")
    return T, S, A, P, V


def check_points(params0, data: PointAssocData):
    P, dev = params0.shape[0], params0.device
    S, A = data.mask.shape[1], data.ln_w.shape[1]
    N, T = data.views_k.shape[0], data.lines.shape[0]
    check_tensor("params0", params0, torch.float32, (P, POINT_P), dev)
    shapes = dict(views_k=(N, 4), views_q=(N, 4), views_t=(N, 3),
                  img_index=(P, S), p2d=(P, S, 2), mask=(P, S),
                  ln_idx=(P, A), ln_w=(P, A), lines=(T, 6))
    types = dict(img_index=torch.int32, ln_idx=torch.int32,
                 mask=torch.bool)
    for name, t in zip(PointAssocData._fields, data):
        check_tensor(name, t, types.get(name, torch.float32), shapes[name],
                     dev)
    if T < 1:
        raise ValueError("the line table needs a row at least")
    return P, S, A, N, T


def _outputs(R, Pn, D, num_iterations, trace, ne, dev):
    out = lm.LMResult(torch.empty((R, Pn), dtype=torch.float32, device=dev),
                      torch.empty(R, dtype=torch.float32, device=dev),
                      torch.empty(R, dtype=torch.float32, device=dev),
                      torch.empty(R, dtype=torch.int32, device=dev))
    tr = torch.empty((R, num_iterations, 2 + 2 * Pn), dtype=torch.float32,
                     device=dev) if trace else None
    ne_out = torch.empty((R, D * D + D + 1), dtype=torch.float32,
                         device=dev) if ne else None
    return out, tr, ne_out


def _ptrs(out, tr, ne_out):
    return (*(t.data_ptr() for t in out),
            None if tr is None else tr.data_ptr(),
            None if ne_out is None else ne_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


def _launch_lines(params0, data, terms, num_iterations, trace, ne):
    T, S, A, P, V = check_lines(params0, data)
    dev = params0.device
    if terms.loss not in lm.LOSSES:
        raise ValueError(f"unknown loss {terms.loss}")
    s = float(terms.loss_scale)
    hp = np.asarray((terms.geometric_alpha, s, s * s) + lm.LAMBDAS
                    + (terms.lw_pointline, terms.lw_vpline), np.float32)
    out, tr, ne_out = _outputs(T, LINE_P, LINE_D, num_iterations, trace, ne,
                               dev)
    if T:
        args = [t.contiguous() for t in (params0,) + tuple(data)]
        with torch.cuda.device(dev):
            err = build().lm_assoc_lines_launch(
                *(t.data_ptr() for t in args), T, S, A, P, V, hp.ctypes.data,
                lm.LOSSES.index(terms.loss), int(terms.use_vps),
                num_iterations, *_ptrs(out, tr, ne_out))
        if err:
            raise RuntimeError(
                f"lm_assoc_lines launch failed: CUDA error {err}")
    return out, tr, ne_out


def _launch_points(params0, data, terms, num_iterations, trace, ne):
    P, S, A, N, T = check_points(params0, data)
    dev = params0.device
    hp = np.asarray((math.sqrt(terms.lw_point), terms.lw_pointline)
                    + lm.LAMBDAS, np.float32)
    out, tr, ne_out = _outputs(P, POINT_P, POINT_D, num_iterations, trace,
                               ne, dev)
    if P:
        args = [t.contiguous() for t in (params0,) + tuple(data)]
        with torch.cuda.device(dev):
            err = build().lm_assoc_points_launch(
                *(t.data_ptr() for t in args), P, S, A, N, T, hp.ctypes.data,
                num_iterations, *_ptrs(out, tr, ne_out))
        if err:
            raise RuntimeError(
                f"lm_assoc_points launch failed: CUDA error {err}")
    return out, tr, ne_out


def _solve(kernel, plain, check, launch, params0, data, terms,
           num_iterations, trace):
    check(params0, data)
    if params0.device.type == "cpu":
        rows = [] if trace else None
        res = plain(params0, data, terms, num_iterations, rows)
        if not trace:
            return res
        W = 2 + 2 * params0.shape[1]
        return res, (torch.stack(rows, 1) if rows else torch.zeros(
            (params0.shape[0], 0, W)))
    res, tr, _ = launch(params0, data, terms, num_iterations, trace, False)
    kernel.launches += 1
    return (res, tr) if trace else res


def solve_lines(params0, data: LineAssocData, terms: AssocTerms,
                num_iterations=10, trace=False):
    """Kernel L's LMResult (and with ``trace`` the per-iteration rows
    [T, n, 14]); ``solve_lines.launches`` counts its launches."""
    return _solve(_LINES, solve_lines_plain, check_lines, _launch_lines,
                  params0, data, terms, num_iterations, trace)


def solve_points(params0, data: PointAssocData, terms: AssocTerms,
                 num_iterations=10, trace=False):
    """Kernel M's LMResult (and with ``trace`` the per-iteration rows
    [P, n, 8]); ``solve_points.launches`` counts its launches."""
    return _solve(_POINTS, solve_points_plain, check_points,
                  _launch_points, params0, data, terms, num_iterations,
                  trace)


solve_lines.launches = 0
solve_points.launches = 0
# the counters stay these functions when the module's names are wrapped
_LINES, _POINTS = solve_lines, solve_points


def _normal_equations(plain, check, launch, D, params0, data, terms):
    R = check(params0, data)[0]
    if params0.device.type == "cpu":
        return plain(params0, data, terms)
    _, _, ne = launch(params0, data, terms, 0, False, True)
    return (ne[:, :D * D].reshape(R, D, D), ne[:, D * D:D * D + D],
            ne[:, -1])


def normal_equations_lines(params0, data: LineAssocData, terms: AssocTerms):
    """(J^T J [T, 4, 4], J^T r [T, 4], cost [T]) of kernel L at
    ``params0`` (the plain ``jvp``'s on the CPU)."""
    return _normal_equations(normal_equations_lines_plain, check_lines,
                             _launch_lines, LINE_D, params0, data, terms)


def normal_equations_points(params0, data: PointAssocData,
                            terms: AssocTerms):
    """(J^T J [P, 3, 3], J^T r [P, 3], cost [P]) of kernel M at
    ``params0`` (the plain ``jvp``'s on the CPU)."""
    return _normal_equations(normal_equations_points_plain, check_points,
                             _launch_points, POINT_D, params0, data, terms)
