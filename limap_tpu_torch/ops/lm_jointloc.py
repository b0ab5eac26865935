"""Kernel I: the joint point+line pose solve of localization, a whole LM
solve in one launch.

``solve`` takes T pose chains ``params0 [T, 7]`` (qvec, tvec), the line
matches shared by all of them (3D ``l3s``, ``l3e [N_l, 3]``, 2D ``l2s``,
``l2e [N_l, 2]``), the point matches (``p3 [N_p, 3]``, ``p2 [N_p, 2]``),
per row the masks ``lmask [T, N_l]`` and ``pmask [T, N_p]``, the
camera's ``kvec [4]`` and a ``LineLocConfig``.  It returns the
:class:`LMResult` of ``num_iterations`` LM iterations.

CUDA tensors launch ``csrc/lm_jointloc.cu`` (a block a chain: its active
matches compacted once into shared memory, or their indices into a
global scratch where a chain has more than shared memory holds, then one
pass and one sum an iteration, each chain's team chosen on the card from
its active matches by :func:`chain_team`, :func:`chain_warps` on the
host), for every cost function, weight and loss; CPU tensors take
:func:`solve_plain`, the eager ``lm_solve`` with ``_jointloc_residual``.
:func:`normal_equations` is the check entry: J^T J, J^T r and the cost at
``params0``.  :func:`solve_scan` is the first design (256 threads a
chain, two passes and two block sums an iteration over every match),
kept as the yardstick; :func:`launch_parts` runs the holding variant
(the first design's team), or from a timing build of its own a variant
with a part of an iteration left out or a fixed team, counting nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.optimize import lm

SOURCE = "lm_jointloc.cu"
D, P = 6, 7
TRACE_WIDTH = 2 + 2 * P
# the parts of an iteration (the kernels' ``stages``; csrc Stage): the
# normal-equation pass and its sum, the cost pass and its sum, the solve
STAGE_NE_PASS, STAGE_NE_SUM, STAGE_COST_PASS, STAGE_COST_SUM = 1, 2, 4, 8
STAGE_SOLVE, STAGES_ALL = 16, 31
# the items' order in a team (csrc Order): match i on thread i mod S (the
# first design's), or the active matches dealt round robin
OWNER, BALANCED = 0, 1
MAX_WARPS = 8                 # the first design's 256 threads
FIRST_DESIGN_TEAM = (MAX_WARPS, OWNER)
# a chain's team (chain_team): one warp while no lane has more than
# WARP_ITEMS active matches, else 4 warps while no lane has more than
# BLOCK_ITEMS, else 8 (the team sweep of testing/loc_kernels.py on the
# H100: a block team pays its barriers and the partials' reads a sum, so
# past one warp it takes more warps at once)
WARP_ITEMS, BLOCK_ITEMS = 4, 2
SMEM_MAX = 227 * 1024         # dynamic shared memory a block can have
NS = D * (D + 1) // 2 + D + 2  # the fused sum: 28 terms and the cost


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


@functools.lru_cache(maxsize=None)
def build(parts: bool = False) -> ctypes.CDLL:
    """The kernel's library; with ``parts`` the timing build (the variants
    :func:`launch_parts` runs that leave a part out or fix a BALANCED
    team), which the path never loads."""
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE, "LM_JOINTLOC_PARTS" if parts else "")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, T, nl, np, kv,
    # hp, ip, n_iter, params, cost0, cost, n_acc, trace, ne
    common = [ptr] * 9 + [i64] * 3 + [ptr] * 3 + [i64] + [ptr] * 6
    if parts:
        # stages, warps, fixed, staged, idx, team_out, scan, stream
        lib.lm_jointloc_parts_launch.argtypes = common + [i64] * 4 + [
            ptr, ptr, i64, ptr]
        lib.lm_jointloc_parts_launch.restype = ctypes.c_int
        return lib
    # warps, staged, idx, team_out, stream
    for fn in (lib.lm_jointloc_launch, lib.lm_jointloc_hold_launch):
        fn.argtypes = common + [i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.lm_jointloc_scan_launch.argtypes = common + [ptr]
    lib.lm_jointloc_scan_launch.restype = ctypes.c_int
    return lib


def chain_team(active: int) -> int:
    """The warps of a chain of ``active`` matches (the kernel's
    team_warps): one while it holds WARP_ITEMS a lane, else 4 while they
    hold BLOCK_ITEMS a lane, else 8.  Two warps at BLOCK_ITEMS a lane
    would take what one warp takes at WARP_ITEMS, so the rule never
    picks them."""
    return 1 if active <= 32 * WARP_ITEMS else (
        4 if active <= 128 * BLOCK_ITEMS else MAX_WARPS)


def team_for(max_lines: int, max_points: int, warps=None) -> dict:
    """The block of a launch on chains of at most ``max_lines`` active
    lines and ``max_points`` active points: as wide as
    :func:`chain_team` gives the most active chain, or ``warps``; where
    a chain's compacted matches go: their data in shared memory while
    they fit, else their indices there, else their indices in a global
    scratch [T, N_l + N_p] (``matches_in``)."""
    if warps is None:
        warps = chain_team(max_lines + max_points)
    if warps not in (1, 2, 4, MAX_WARPS):
        raise ValueError(f"lm_jointloc: a team of 1, 2, 4 or 8 warps, got "
                         f"{warps}")
    fixed = 4 * (MAX_WARPS * NS + 2 * MAX_WARPS)
    need = {"shared memory": 4 * (10 * max_lines + 5 * max_points),
            "indices in shared memory": 4 * (max_lines + max_points),
            "indices in global memory": 0}
    where = next(k for k, v in need.items() if fixed + v <= SMEM_MAX)
    return {"warps": int(warps), "matches_in": where,
            "staged": where == "shared memory", "lines": int(max_lines),
            "points": int(max_points), "smem_bytes": fixed + need[where]}


def chain_warps(lmask, pmask) -> list:
    """Each chain's team (warps) as the kernel picks it from its active
    matches, within the block :func:`team_for` gives the shapes (one copy
    to the host; the kernel itself needs none)."""
    width = team_for(lmask.shape[1], pmask.shape[1])["warps"]
    most = (lmask.sum(1) + pmask.sum(1)).tolist()
    return [min(width, chain_team(m)) for m in most]


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


def config_args(cfg):
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
    hp = np.asarray((cfg.alpha, s, s * s, cfg.weight_line, cfg.weight_point)
                    + lm.LAMBDAS, np.float32)
    ip = np.asarray([COST_FUNCTIONS.index(cfg.cost_function),
                     COST_WEIGHTS.index(cfg.cost_function_weight),
                     lm.LOSSES.index(cfg.loss)], np.int64)
    return hp, ip


def _prepare(params0, data, cfg, num_iterations, trace, ne,
             stages=STAGES_ALL, warps=None, order=BALANCED, scan=False,
             chain_teams=False):
    """The outputs of one launch and the launch itself: (LMResult, trace,
    ne, team, go), ``go()`` launching into the outputs (None where T =
    0).  The path's kernel by default, each chain its own team in a block
    as wide as :func:`team_for` gives the shapes; ``order`` OWNER the
    holding variant (a team of the whole block, ``warps`` or 8); with
    ``scan`` the first design; another ``stages``, or ``warps`` in order
    BALANCED, the timing build.  With ``chain_teams``
    ``team["chain_warps"]`` [T] gets each chain's team.  Nothing comes
    to the host."""
    if order not in (OWNER, BALANCED):
        raise ValueError(f"lm_jointloc: order OWNER or BALANCED, got "
                         f"{order}")
    T, dev = params0.shape[0], params0.device
    nl, npt = data[0].shape[0], data[5].shape[0]
    out = lm.LMResult(torch.empty((T, P), dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.int32, device=dev))
    tr = torch.empty((T, num_iterations, TRACE_WIDTH), dtype=torch.float32,
                     device=dev) if trace else None
    ne_out = torch.empty((T, D * D + D + 1), dtype=torch.float32,
                         device=dev) if ne else None
    if not T:
        return out, tr, ne_out, None, None
    hp, ip = config_args(cfg)
    args = [t.contiguous() for t in (params0,) + tuple(data)]
    ptrs = [t.data_ptr() for t in args[:9]] + [T, nl, npt, args[9].data_ptr(),
                                              hp.ctypes.data, ip.ctypes.data,
                                              num_iterations]
    ptrs += [t.data_ptr() for t in out] + [
        None if tr is None else tr.data_ptr(),
        None if ne_out is None else ne_out.data_ptr()]
    timing = stages != STAGES_ALL or (warps is not None and order == BALANCED
                                      and not scan)
    if timing and order == OWNER:
        raise ValueError("lm_jointloc: the holding variant runs every part")
    lib, team, keep = build(timing), None, []
    if scan:
        if timing:
            fn = lib.lm_jointloc_parts_launch
            ptrs += [stages, 0, 0, 0, None, None, 1]
        else:
            fn = lib.lm_jointloc_scan_launch
    else:
        if order == OWNER and warps is None:
            warps = MAX_WARPS
        team = team_for(nl, npt, warps)
        idx = torch.empty(T * (nl + npt), dtype=torch.int32, device=dev) \
            if team["matches_in"] == "indices in global memory" else None
        team["chain_warps"] = torch.empty(
            T, dtype=torch.int32, device=dev) if chain_teams else None
        keep = [idx, team["chain_warps"]]
        tail = [int(team["staged"]), None if idx is None else idx.data_ptr(),
                None if team["chain_warps"] is None
                else team["chain_warps"].data_ptr()]
        if timing:
            fn = lib.lm_jointloc_parts_launch
            ptrs += [stages, team["warps"], int(warps is not None)] + tail \
                + [0]
        else:
            fn = lib.lm_jointloc_hold_launch if order == OWNER \
                else lib.lm_jointloc_launch
            ptrs += [team["warps"]] + tail

    def go():
        with torch.cuda.device(dev):
            err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lm_jointloc launch failed: CUDA error {err}")

    go.keep = (args, hp, ip, keep)  # what ptrs points into
    return out, tr, ne_out, team, go


def _launch(*a, **k):
    """:func:`_prepare`, then its launch: (LMResult, trace, ne, team)."""
    out, tr, ne_out, team, go = _prepare(*a, **k)
    if go is not None:
        go()
    return out, tr, ne_out, team


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
    res, tr, _, team = _launch(params0, data, cfg, num_iterations, trace,
                               False)
    if team is not None:
        _COUNTER.launches += 1
    return (res, tr) if trace else res


solve.launches = 0
_COUNTER = solve


def _card_only(name, params0, data):
    _check(params0, data)
    if params0.device.type != "cuda":
        raise ValueError(f"{name} is a kernel of the card")


def solve_scan(params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv, cfg,
               num_iterations=50, trace=False):
    """The first design, the yardstick, on CUDA tensors only; as
    :func:`solve` returns.  ``solve_scan.launches`` counts its
    launches."""
    data = (l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv)
    _card_only("solve_scan", params0, data)
    res, tr, _, _ = _launch(params0, data, cfg, num_iterations, trace,
                            False, scan=True)
    if params0.shape[0]:
        solve_scan.launches += 1
    return (res, tr) if trace else res


solve_scan.launches = 0


def launch_parts(params0, data, cfg, num_iterations=50, stages=STAGES_ALL,
                 warps=None, order=BALANCED, scan=False, trace=False):
    """The kernel (or with ``scan`` the first design) on CUDA tensors
    with the parts ``stages`` of an iteration and the team ``warps``,
    ``order`` (each chain's own by default; OWNER: the holding variant),
    for timing a part or holding a team to the first design; ``data`` as
    :func:`solve_plain` takes it.  Returns (LMResult, trace or None,
    team: the block's width and each chain's ``chain_warps``); counts
    nothing."""
    _card_only("launch_parts", params0, data)
    res, tr, _, team = _launch(params0, data, cfg, num_iterations, trace,
                               False, stages, warps, order, scan, True)
    return res, tr, team


def prepared(params0, data, cfg, num_iterations=50, stages=STAGES_ALL,
             warps=None, order=BALANCED, scan=False):
    """As :func:`launch_parts`, but the host work done once: returns
    (LMResult, team, go), each ``go()`` one launch into the result, for
    timing the card alone; counts nothing."""
    _card_only("prepared", params0, data)
    res, _, _, team, go = _prepare(params0, data, cfg, num_iterations,
                                   False, False, stages, warps, order, scan,
                                   True)
    return res, team, go


def normal_equations(params0, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv,
                     cfg):
    """(J^T J [T, 6, 6], J^T r [T, 6], cost [T]) at ``params0``: the
    kernel's on the card (0 iterations), the plain ``jvp``'s on the CPU."""
    data = (l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv)
    _check(params0, data)
    if params0.device.type == "cpu":
        return normal_equations_plain(params0, data, cfg)
    T = params0.shape[0]
    _, _, ne, _ = _launch(params0, data, cfg, 0, False, True)
    return (ne[:, :D * D].reshape(T, D, D), ne[:, D * D:D * D + D],
            ne[:, -1])
