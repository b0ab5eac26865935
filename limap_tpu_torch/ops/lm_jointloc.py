"""Kernel I: the joint point+line pose solve of localization, a whole LM
solve in one launch.

``solve`` takes T pose chains ``params0 [T, 7]`` (qvec, tvec), the line
matches shared by all of them (3D ``l3s``, ``l3e [N_l, 3]``, 2D ``l2s``,
``l2e [N_l, 2]``), the point matches (``p3 [N_p, 3]``, ``p2 [N_p, 2]``),
per row the masks ``lmask [T, N_l]`` and ``pmask [T, N_p]``, the
camera's ``kvec [4]`` and a ``LineLocConfig``.  It returns the
:class:`LMResult` of ``num_iterations`` LM iterations.

CUDA tensors launch ``csrc/lm_jointloc.cu`` (one block a row, Jets for
the Jacobian), for every cost function, weight and loss; CPU tensors
take :func:`solve_plain`, the eager ``lm_solve`` with
``_jointloc_residual``.  :func:`normal_equations` is the check entry:
J^T J, J^T r and the cost at ``params0``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.optimize import lm

SOURCE = "lm_jointloc.cu"
D, P = 6, 7
TRACE_WIDTH = 2 + 2 * P


def plain_aux(l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv):
    """The plain residual's aux: the shared data with a leading [1]."""
    return (l3s[None], l3e[None], l2s[None], l2e[None], lmask, p3[None],
            p2[None], pmask, kv[None])


def _residual(cfg, data):
    from limap_tpu_torch.optimize.hybrid_localization import \
        _jointloc_residual
    return _jointloc_residual(cfg, data[0].shape[0] > 0,
                              data[5].shape[0] > 0)


def solve_plain(params0, data, cfg, num_iterations=50, trace=None):
    """The eager LM on ``data`` = (l3s, l3e, l2s, l2e, lmask, p3, p2,
    pmask, kv); ``trace`` as ``lm_solve`` takes it."""
    return lm.lm_solve(params0, _residual(cfg, data), lm.retract_pose, D,
                       plain_aux(*data), num_iterations=num_iterations,
                       trace=trace)


def normal_equations_plain(params0, data, cfg):
    return lm.normal_equations(params0, _residual(cfg, data),
                               lm.retract_pose, D, plain_aux(*data))


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, T, nl, np, hp,
    # ip, n_iter, params, cost0, cost, n_acc, trace, ne, stream
    lib.lm_jointloc_launch.argtypes = [ptr] * 9 + [i64] * 3 + [ptr] * 2 \
        + [i64] + [ptr] * 7
    lib.lm_jointloc_launch.restype = ctypes.c_int
    return lib


def _check(params0, data):
    T, dev = params0.shape[0], params0.device
    nl, npt = data[0].shape[0], data[5].shape[0]
    check_tensor("params0", params0, torch.float32, (T, P), dev)
    for name, t, dtype, shape in zip(
            ("l3s", "l3e", "l2s", "l2e", "lmask", "p3", "p2", "pmask", "kv"),
            data, (torch.float32,) * 4 + (torch.bool,)
            + (torch.float32,) * 2 + (torch.bool, torch.float32),
            ((nl, 3), (nl, 3), (nl, 2), (nl, 2), (T, nl), (npt, 3),
             (npt, 2), (T, npt), (4,))):
        check_tensor(name, t, dtype, shape, dev)


def config_args(cfg, kv):
    """The kernel's float and int parameters (hp, ip) of a config."""
    from limap_tpu_torch.optimize.hybrid_localization import (
        COST_FUNCTIONS, COST_WEIGHTS)
    if cfg.cost_function not in COST_FUNCTIONS:
        raise ValueError(f"unknown cost function {cfg.cost_function!r}")
    if cfg.cost_function_weight not in COST_WEIGHTS:
        raise ValueError(f"unknown weight {cfg.cost_function_weight!r}")
    if cfg.loss not in lm.LOSSES:
        raise ValueError(f"unknown loss {cfg.loss}")
    s = float(cfg.loss_scale)
    hp = np.concatenate([kv.detach().cpu().numpy().astype(np.float32),
                         np.asarray((cfg.alpha, s, s * s, cfg.weight_line,
                                     cfg.weight_point) + lm.LAMBDAS,
                                    np.float32)])
    ip = np.asarray([COST_FUNCTIONS.index(cfg.cost_function),
                     COST_WEIGHTS.index(cfg.cost_function_weight),
                     lm.LOSSES.index(cfg.loss)], np.int64)
    return hp, ip


def _launch(params0, data, cfg, num_iterations, trace, ne):
    T, dev = params0.shape[0], params0.device
    nl, npt = data[0].shape[0], data[5].shape[0]
    hp, ip = config_args(cfg, data[8])
    out = lm.LMResult(torch.empty((T, P), dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.int32, device=dev))
    tr = torch.empty((T, num_iterations, TRACE_WIDTH), dtype=torch.float32,
                     device=dev) if trace else None
    ne_out = torch.empty((T, D * D + D + 1), dtype=torch.float32,
                         device=dev) if ne else None
    if T:
        args = [t.contiguous() for t in (params0,) + tuple(data[:8])]
        with torch.cuda.device(dev):
            err = build().lm_jointloc_launch(
                *(t.data_ptr() for t in args), T, nl, npt, hp.ctypes.data,
                ip.ctypes.data, num_iterations,
                *(t.data_ptr() for t in out),
                None if tr is None else tr.data_ptr(),
                None if ne_out is None else ne_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lm_jointloc launch failed: CUDA error {err}")
    return out, tr, ne_out


def solve(params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv, cfg,
          num_iterations=50, trace=False):
    """The LMResult of the pose solves; with ``trace`` also the
    per-iteration rows [T, num_iterations, 2 + 2P] (cost, new cost,
    params, new params).  ``solve.launches`` counts the kernel's
    launches."""
    data = (l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv)
    _check(params0, data)
    if params0.device.type == "cpu":
        rows = [] if trace else None
        res = solve_plain(params0, data, cfg, num_iterations, rows)
        if not trace:
            return res
        return res, (torch.stack(rows, 1) if rows else torch.zeros(
            (params0.shape[0], 0, TRACE_WIDTH)))
    res, tr, _ = _launch(params0, data, cfg, num_iterations, trace, False)
    _COUNTER.launches += 1
    return (res, tr) if trace else res


solve.launches = 0
_COUNTER = solve


def normal_equations(params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv,
                     cfg):
    """(J^T J [T, 6, 6], J^T r [T, 6], cost [T]) at ``params0``: the
    kernel's on the card (0 iterations), the plain ``jvp``'s on the CPU."""
    data = (l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv)
    _check(params0, data)
    if params0.device.type == "cpu":
        return normal_equations_plain(params0, data, cfg)
    T = params0.shape[0]
    _, _, ne = _launch(params0, data, cfg, 0, False, True)
    return (ne[:, :D * D].reshape(T, D, D), ne[:, D * D:D * D + D],
            ne[:, -1])
