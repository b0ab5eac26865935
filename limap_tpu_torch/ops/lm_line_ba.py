"""Kernel H: the fixed-camera line bundle adjustment, a whole LM solve in
one launch.

``solve`` takes T tracks' minimal lines ``params0 [T, 6]`` and their S
padded supports: the views' ``kvec [T, S, 4]``, ``qvec [T, S, 4]``,
``tvec [T, S, 3]``, the 2D segments ``p_start``, ``p_end [T, S, 2]``,
the weights ``[T, S]`` and the validity mask ``[T, S]``, as
``optimize/line_ba.py::solve_line_bundle_adjustment`` gathers them.  It
returns the :class:`LMResult` of ``num_iterations`` LM iterations.

CUDA tensors launch ``csrc/lm_line_ba.cu`` (one warp a track, Jets for
the Jacobian); CPU tensors take :func:`solve_plain`, the eager
``lm_solve`` with ``ba_residual``.  :func:`normal_equations` is the
check entry: J^T J, J^T r and the cost at ``params0``, from the kernel
on the card and from the plain version's ``jvp`` on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.optimize import lm

SOURCE = "lm_line_ba.cu"
D, P = 4, 6
TRACE_WIDTH = 2 + 2 * P


def _residual(cfg):
    from limap_tpu_torch.optimize.line_ba import ba_residual
    return ba_residual(cfg)


def solve_plain(params0, aux, cfg, num_iterations=20, trace=None):
    """The eager LM on ``aux`` = (kvec, qvec, tvec, p_start, p_end,
    weights, valid); ``trace`` as ``lm_solve`` takes it."""
    return lm.lm_solve(params0, _residual(cfg), lm.retract_quat_so2, D, aux,
                       num_iterations=num_iterations, trace=trace)


def normal_equations_plain(params0, aux, cfg):
    return lm.normal_equations(params0, _residual(cfg), lm.retract_quat_so2,
                               D, aux)


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # params0, kv, qv, tv, ps, pe, w, valid, T, S, hp, loss, n_iter,
    # params, cost0, cost, n_acc, trace, ne, stream
    lib.lm_line_ba_launch.argtypes = [ptr] * 8 + [i64] * 2 + [ptr] \
        + [i64] * 2 + [ptr] * 7
    lib.lm_line_ba_launch.restype = ctypes.c_int
    return lib


def _check(params0, aux):
    T, dev = params0.shape[0], params0.device
    S = aux[-1].shape[-1] if aux[-1].dim() == 2 else -1
    check_tensor("params0", params0, torch.float32, (T, P), dev)
    for name, t, dtype, tail in zip(
            ("kvec", "qvec", "tvec", "p_start", "p_end", "weights", "valid"),
            aux, (torch.float32,) * 6 + (torch.bool,),
            ((4,), (4,), (3,), (2,), (2,), (), ())):
        check_tensor(name, t, dtype, (T, S) + tail, dev)
    return T, S


def _launch(params0, aux, cfg, num_iterations, trace, ne):
    T, S = params0.shape[0], aux[-1].shape[1]
    dev = params0.device
    if cfg.loss not in lm.LOSSES:
        raise ValueError(f"unknown loss {cfg.loss}")
    s = float(cfg.loss_scale)
    hp = np.asarray((cfg.geometric_alpha, s, s * s) + lm.LAMBDAS, np.float32)
    out = lm.LMResult(torch.empty((T, P), dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.int32, device=dev))
    tr = torch.empty((T, num_iterations, TRACE_WIDTH), dtype=torch.float32,
                     device=dev) if trace else None
    ne_out = torch.empty((T, D * D + D + 1), dtype=torch.float32,
                         device=dev) if ne else None
    if T:
        args = [t.contiguous() for t in (params0,) + tuple(aux)]
        with torch.cuda.device(dev):
            err = build().lm_line_ba_launch(
                *(t.data_ptr() for t in args), T, S, hp.ctypes.data,
                lm.LOSSES.index(cfg.loss), num_iterations,
                *(t.data_ptr() for t in out),
                None if tr is None else tr.data_ptr(),
                None if ne_out is None else ne_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lm_line_ba launch failed: CUDA error {err}")
    return out, tr, ne_out


def solve(params0, kvec, qvec, tvec, p_start, p_end, weights, valid, cfg,
          num_iterations=20, trace=False):
    """The LMResult of the line BA; with ``trace`` also the per-iteration
    rows [T, num_iterations, 2 + 2P] (cost, new cost, params, new params).
    ``solve.launches`` counts the kernel's launches."""
    aux = (kvec, qvec, tvec, p_start, p_end, weights, valid)
    _check(params0, aux)
    if params0.device.type == "cpu":
        rows = [] if trace else None
        res = solve_plain(params0, aux, cfg, num_iterations, rows)
        if not trace:
            return res
        return res, (torch.stack(rows, 1) if rows else torch.zeros(
            (params0.shape[0], 0, TRACE_WIDTH)))
    res, tr, _ = _launch(params0, aux, cfg, num_iterations, trace, False)
    _COUNTER.launches += 1
    return (res, tr) if trace else res


solve.launches = 0
_COUNTER = solve


def normal_equations(params0, kvec, qvec, tvec, p_start, p_end, weights,
                     valid, cfg):
    """(J^T J [T, 4, 4], J^T r [T, 4], cost [T]) at ``params0``: the
    kernel's on the card (0 iterations), the plain ``jvp``'s on the CPU."""
    aux = (kvec, qvec, tvec, p_start, p_end, weights, valid)
    T, _ = _check(params0, aux)
    if params0.device.type == "cpu":
        return normal_equations_plain(params0, aux, cfg)
    _, _, ne = _launch(params0, aux, cfg, 0, False, True)
    return (ne[:, :D * D].reshape(T, D, D), ne[:, D * D:D * D + D],
            ne[:, -1])

