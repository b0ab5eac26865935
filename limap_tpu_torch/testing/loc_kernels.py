"""Kernels I (the LO's pose solve) and B (the PnL root finder) against
their first designs on the card: the bit-for-bit holds, I's time split
and the sweeps that set I's team sizes and B's plan.

    python -m limap_tpu_torch.testing.loc_kernels [I] [B] [--inputs FILE]

builds both, holds them (or the one named) to their first designs on
the seeded cases, prints the splits and the sweeps, and exits 0 when
every hold passed.  With ``--inputs`` (saved by ``chip_smoke.py
--save-loc-inputs``) it also splits an iteration of phase 8's largest,
typical and heaviest LO solves, for the kernel and the first design,
and times B's plan against the one-level plan in turns on phase 8's
largest input of B.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def cuda_ms(fn, reps=10, warmup=True):
    """ms a call of ``fn`` by CUDA events over ``reps`` calls."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=10):
    """ms a call of ``fn`` by the host's clock, synchronized."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


# ------------------------------------------------------------ kernel I
def jointloc_bits(params0, data, cfg, n_iter=50, warps=None, order=None):
    """The kernel with the first design's team (or ``warps``, ``order``)
    against the first design: every trace row, the final params, the
    costs and the accepts bit for bit."""
    from limap_tpu_torch.ops import lm_jointloc as I
    w, o = I.FIRST_DESIGN_TEAM if warps is None else (warps, order)
    res_k, tr_k, team = I.launch_parts(params0, data, cfg, n_iter, warps=w,
                                       order=o, trace=True)
    res_s, tr_s, _ = I.launch_parts(params0, data, cfg, n_iter, scan=True,
                                    trace=True)
    ne_k = I.normal_equations(params0, *data, cfg)
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            if a.dtype == torch.float32 else torch.equal(a, b)
            for a, b in zip(tuple(res_k) + (tr_k,), tuple(res_s) + (tr_s,))]
    rows = (tr_k.view(torch.int32) != tr_s.view(torch.int32)).any(-1).any(-1)
    return {"rows": int(params0.shape[0]), "team": [w, o],
            "params": same[0], "cost0": same[1], "cost": same[2],
            "accepts": same[3], "trace": same[4],
            "rows_differing": int(rows.sum()),
            "ne_finite": bool(torch.isfinite(ne_k[0]).all()),
            "ok": all(same)}


def _stages_without(part):
    from limap_tpu_torch.ops import lm_jointloc as I
    return I.STAGES_ALL & ~part


def jointloc_split(params0, data, cfg, n_iter=50, scan=False, warps=None,
                   order=None, reps=10):
    """One iteration's parts (us), each the time saved on the card by
    leaving it out, over ``n_iter`` iterations: the normal-equation pass
    and its sum, the cost pass and its sum, and the rest (the solve, the
    retraction and the loop); the set-up (launch, compaction, the first
    pass) from a launch of no iteration; the wrapper's host work a call
    (``host_ms``: a synchronized call's wall less the card's time).  The
    kernel's one pass is both passes and its one sum both sums: left out
    alone, each half shows its share."""
    from limap_tpu_torch.ops import lm_jointloc as I
    kw = dict(scan=scan) if scan else dict(warps=warps, order=(
        I.BALANCED if order is None else order))

    def run(stages, iters):
        return cuda_ms(I.prepared(params0, data, cfg, iters, stages,
                                  **kw)[2], reps)

    full = run(I.STAGES_ALL, n_iter)
    setup = run(I.STAGES_ALL, 0)
    out = {"ms": full, "setup_ms": setup,
           "host_ms": host_ms(lambda: I.launch_parts(
               params0, data, cfg, n_iter, **kw)) - full}
    parts = {"ne_pass": I.STAGE_NE_PASS, "cost_pass": I.STAGE_COST_PASS}
    if scan:
        parts.update(ne_sum=I.STAGE_NE_SUM, cost_sum=I.STAGE_COST_SUM)
    else:
        parts.update(sum=I.STAGE_NE_SUM | I.STAGE_COST_SUM,
                     solve=I.STAGE_SOLVE)
    for name, bit in parts.items():
        out[name + "_us_an_iteration"] = 1e3 * (
            full - run(_stages_without(bit), n_iter)) / max(n_iter, 1)
    known = sum(v for k, v in out.items() if k.endswith("_an_iteration"))
    out["rest_us_an_iteration"] = 1e3 * (full - setup) / max(n_iter, 1) \
        - known
    return out


def lo_like(n_active, T=8, seed=0, device="cuda"):
    """T chains on one problem of 164 lines and 1,000 points (phase 8's
    widths), each masking ``n_active`` matches at random, a fifth of them
    lines; for the team sweep."""
    from scipy.spatial.transform import Rotation
    from limap_tpu_torch.base.camera import CameraPose
    from limap_tpu_torch.testing.localization import synthetic_problem
    rng = np.random.default_rng(seed)
    cam, pose_gt, p3, p2, l3, _, l2 = synthetic_problem(
        rng, n_points=1000, n_lines=164, outlier_ratio=0.2)
    starts = [CameraPose(R=Rotation.from_rotvec(rng.normal(size=3) * 0.03)
                         .as_matrix() @ pose_gt.R(),
                         tvec=pose_gt.tvec + rng.normal(0, 0.1, 3))
              for _ in range(T)]
    n_l = min(164, n_active // 5)
    lmask = np.zeros((T, 164), bool)
    pmask = np.zeros((T, 1000), bool)
    for k in range(T):
        lmask[k, rng.permutation(164)[:n_l]] = True
        pmask[k, rng.permutation(1000)[:min(1000, n_active - n_l)]] = True

    def f(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt,
                               device=device).contiguous()

    params0 = f(np.concatenate([np.stack([p.qvec for p in starts]),
                                np.stack([p.tvec for p in starts])], 1))
    data = (f(l3[:, 0]), f(l3[:, 1]), f(l2[:, 0]), f(l2[:, 1]),
            f(lmask, torch.bool), f(p3), f(p2), f(pmask, torch.bool),
            f(cam.kvec()))
    return params0, data


SWEEP_ACTIVE = (8, 32, 64, 128, 256, 512, 1164)


def team_sweep(cfg, n_iter=50, reps=5):
    """ms on the card of a solve of 8 chains of n active matches
    (``lo_like``) for each team of the kernel, and the first design's:
    {n: {team: ms}}."""
    from limap_tpu_torch.ops import lm_jointloc as I
    out = {}
    for n in SWEEP_ACTIVE:
        params0, data = lo_like(n)
        row = {f"{w} warps": cuda_ms(I.prepared(
            params0, data, cfg, n_iter, warps=w)[2], reps)
            for w in (1, 2, 4, 8)}
        row["first design"] = cuda_ms(I.prepared(
            params0, data, cfg, n_iter, scan=True)[2], reps)
        row["chains' warps"] = max(I.chain_warps(data[4], data[7]))
        out[n] = row
    return out


# ------------------------------------------------------------ kernel B
def trace_roots_bits(args, n_bisect=48, n_roots=4):
    """The kernel against the first design on (v1, n1, C2, C3, alphas):
    rotations and flags bit for bit."""
    from limap_tpu_torch.ops import trace_roots as B
    Rk, okk = B.launch_parts(*args, n_bisect, n_roots)
    Rs, oks = B.trace_roots_scan(*args, n_bisect, n_roots)
    diff = (Rk.view(torch.int32) != Rs.view(torch.int32)).flatten(2).any(-1)
    return {"instances": int(Rk.shape[0]), "slots": int(okk.numel()),
            "plan": B.plan(n_roots, n_bisect),
            "rotations_equal": bool(not diff.any()),
            "slots_differing": int(diff.sum()),
            "ok_equal": bool(torch.equal(okk, oks)),
            "ok": bool(not diff.any() and torch.equal(okk, oks))}


SWEEP_INSTANCES = (132, 264, 528, 1056, 1280, 2048, 4096)


def plan_sweep(n_roots=4, n_bisect=48, reps=20):
    """ms on the card of the kernel under the rounds-minimal plan (trees)
    and the one-level plan (every root one step a round, the fewest
    evaluations) for B instances of seed 0's inputs: {B: {plan: ms}}."""
    from limap_tpu_torch.ops import trace_roots as B
    from limap_tpu_torch.ops.trace_roots import alpha_grid
    from limap_tpu_torch.testing import kernel_checks
    grid = torch.as_tensor(alpha_grid(256), device="cuda")
    full = [torch.as_tensor(x, device="cuda") for x in
            kernel_checks.trace_roots_inputs(0, B=max(SWEEP_INSTANCES))]
    out = {}
    for n in SWEEP_INSTANCES:
        args = [x[:n].contiguous() for x in full] + [grid]
        out[n] = {name: cuda_ms(lambda: B.launch_parts(
            *args, n_bisect, n_roots, phases=ph), reps)
            for name, ph in (("trees", B.plan(n_roots, n_bisect)),
                             ("one level", [(1, 1, n_bisect)]))}
    return out


def lo_call(call):
    """(params0, data, cfg, n_iter) of a recorded lm_jointloc.solve call."""
    args, kwargs = call
    n_iter = args[11] if len(args) > 11 else kwargs.get("num_iterations", 50)
    return args[0], tuple(args[1:10]), args[10], n_iter


def path_splits(calls):
    """:func:`jointloc_split` of the kernel and the first design on the
    largest (rows x matches), the typical (median active work) and the
    heaviest (most active work) of the recorded LO solves."""
    def work(c):
        return c[0][0].shape[0] * int(c[0][5].sum() + c[0][8].sum())

    picks = {"largest": max(calls, key=lambda c: c[0][0].shape[0]
                            * (c[0][1].shape[0] + c[0][6].shape[0])),
             "typical": sorted(calls, key=work)[len(calls) // 2],
             "heaviest": max(calls, key=work)}
    out = {}
    for label, call in picks.items():
        params0, data, cfg, n_iter = lo_call(call)
        out[label] = {"rows": int(params0.shape[0]),
                      "active": int(data[4].sum() + data[7].sum())}
        for scan in (False, True):
            out[label]["first design" if scan else "kernel"] = \
                jointloc_split(params0, data, cfg, n_iter, scan=scan)
    return out


# B under its plan and under the one-level plan, in turns
PLAN_TURNS = ("plan", "one level", "one level", "plan")


def plan_turns(args, n_bisect, n_roots, reps=20):
    """ms a launch of B on ``args`` (v1, n1, C2, C3, alphas) under its plan
    and under the one-level plan (every root one step a round), in turns
    (PLAN_TURNS)."""
    from limap_tpu_torch.ops import trace_roots as B
    out = {"plan": [], "one level": []}
    for which in PLAN_TURNS:
        phases = None if which == "plan" else [(1, 1, n_bisect)]
        out[which].append(cuda_ms(lambda: B.launch_parts(
            *args, n_bisect, n_roots, phases), reps))
    return out


def main() -> int:
    import argparse
    from limap_tpu_torch.ops import cuda_build, lm_jointloc, trace_roots
    from limap_tpu_torch.ops.trace_roots import alpha_grid
    from limap_tpu_torch.testing import kernel_checks, lm_checks
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", choices=("I", "B"))
    ap.add_argument("--inputs", default="")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("loc_kernels: no CUDA device visible")
        return 2
    lm_jointloc.build()
    lm_jointloc.build(parts=True)
    trace_roots.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}",
              flush=True)
    ok = True
    which = opts.which or ["I", "B"]
    for corners, configs in ((False, lm_checks.JOINTLOC_CONFIGS),
                             (True, lm_checks.JOINTLOC_CORNER_CONFIGS)) \
            if "I" in which else ():
        params0, data = lm_checks.seeded_jointloc(seed=2, corners=corners)
        for c in configs:
            res = jointloc_bits(params0, data, lm_checks.loc_config(*c))
            print(f"[I] first design's team against the first design, "
                  f"{c}, corners {corners}: {json.dumps(res)}", flush=True)
            ok &= res["ok"]
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    for n in (32, 1164) if "I" in which else ():
        params0, data = lo_like(n)
        res = jointloc_bits(params0, data, cfg)
        print(f"[I] bits, {n} active: {json.dumps(res)}", flush=True)
        ok &= res["ok"]
        for scan in (True, False):
            print(f"[I] split, {n} active, "
                  f"{'first design' if scan else 'kernel'}: "
                  f"{json.dumps(jointloc_split(params0, data, cfg, scan=scan))}",
                  flush=True)
    if "I" in which:
        print(f"[I] team sweep (ms a solve of 8 chains): "
              f"{json.dumps(team_sweep(cfg))}", flush=True)
    grid = torch.as_tensor(alpha_grid(256), device="cuda")
    for seed, deg in kernel_checks.SEEDS if "B" in which else ():
        args = [torch.as_tensor(x, device="cuda") for x in
                kernel_checks.trace_roots_inputs(seed, degenerate=deg)]
        for n_roots in (4, 8):
            res = trace_roots_bits(args + [grid], 48, n_roots)
            print(f"[B] seed {seed}, {n_roots} roots: {json.dumps(res)}",
                  flush=True)
            ok &= res["ok"]
    if "B" in which:
        print(f"[B] plan sweep (ms a launch, 4 roots): "
              f"{json.dumps(plan_sweep())}", flush=True)
    if opts.inputs:
        from limap_tpu_torch.testing.lo_wall import path_inputs
        lo, b = path_inputs(opts.inputs)
        if "I" in which:
            print(f"[I] phase 8's splits: {json.dumps(path_splits(lo))}",
                  flush=True)
        if "B" in which:
            a, k = max(b, key=lambda c: c[0][0].shape[0])
            n_bisect = a[5] if len(a) > 5 else k.get("n_bisect", 48)
            n_roots = a[6] if len(a) > 6 else k.get("n_roots", 8)
            print(f"[B] phase 8's largest input ({a[0].shape[0]} instances"
                  f"), plan {json.dumps(trace_roots.plan(n_roots, n_bisect))}"
                  f" against the one-level plan, ms in turns "
                  f"{list(PLAN_TURNS)}: "
                  f"{json.dumps(plan_turns(a[:5], n_bisect, n_roots))}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
