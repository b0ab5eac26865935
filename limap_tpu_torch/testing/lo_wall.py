"""Kernels I and B as the localization path calls them: the wall of a
synchronized call (host work and card) and the card's busy time, so that
one call can time two checkouts on one card.

With ``--inputs FILE`` (saved by ``chip_smoke.py --save-loc-inputs``):
``ops/lm_jointloc.py::solve`` on every LO solve of phase 8 and
``ops/trace_roots.py::trace_roots`` on every launch of B there, each
call as the path made it: the median wall of a synchronized call over
``--reps``, summed over the calls, and the device time of the kernel
(its launches' durations under ``torch.profiler``) summed over one run
of every call.  Without it, synthetic inputs: I on 8 pose chains of
phase 8's widths (164 lines, 1,000 points, 50 iterations,
`2d_perpendicular_dist2` / none / huber), each chain masking the active
matches of one of phase 8's kinds of solve: a step-0 subset (9
matches), the median chain (42 lines and 700 points) and the most
active (164 lines and 700 points); B on 1,280 instances, 4 roots.

    python3 limap_tpu_torch/testing/lo_wall.py [--root DIR] [--reps 20]
        [--inputs FILE]

``--root`` imports ``limap_tpu_torch`` from DIR, another checkout (an
earlier commit unpacked with ``git archive``); by default the checkout
this file is in.  The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
# (active lines, active points) of a chain: phase 8's kinds of solve
CHAINS = {"subset": (3, 6), "median": (42, 700), "most": (164, 700)}


def chains(n_lines, n_points, T=8, seed=0):
    """(params0, data) of T chains on one problem of phase 8's widths,
    each masking n_lines lines and n_points points at random."""
    import numpy as np
    import torch
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
    lmask = np.zeros((T, 164), bool)
    pmask = np.zeros((T, 1000), bool)
    for k in range(T):
        lmask[k, rng.permutation(164)[:n_lines]] = True
        pmask[k, rng.permutation(1000)[:n_points]] = True

    def f(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt,
                               device="cuda").contiguous()

    params0 = f(np.concatenate([np.stack([p.qvec for p in starts]),
                                np.stack([p.tvec for p in starts])], 1))
    return params0, (f(l3[:, 0]), f(l3[:, 1]), f(l2[:, 0]), f(l2[:, 1]),
                     f(lmask, torch.bool), f(p3), f(p2),
                     f(pmask, torch.bool), f(cam.kvec()))


def timed(fn, reps):
    """(median wall ms of a synchronized call, device ms of one call
    under torch.profiler: its events' durations summed)."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if "CUDA" in str(getattr(e, "device_type", "")))
    return float(np.median(walls)), busy * 1e-3


def path_inputs(path):
    """The saved calls of phase 8 on the card: ([(args, kwargs)] of the LO
    solves, [(args, kwargs)] of B's launches); the config rebuilt from
    its dict by the imported package's class."""
    import torch
    from limap_tpu_torch.optimize.hybrid_localization import LineLocConfig
    saved = torch.load(path, weights_only=True)

    def card(x):
        if torch.is_tensor(x):
            return x.to("cuda")
        return LineLocConfig(**x) if isinstance(x, dict) else x

    return tuple([([card(x) for x in a], {n: card(v) for n, v in k.items()})
                  for a, k in saved[name]]
                 for name in ("lm_jointloc", "trace_roots"))


def path_totals(fn, calls, kernel, reps):
    """(wall ms: the median of ``reps`` synchronized calls, summed over
    ``calls``; device ms: the launches of kernels whose names hold
    ``kernel``, under torch.profiler, summed over one run of every
    call)."""
    import numpy as np
    import torch
    for a, k in calls:
        fn(*a, **k)
    torch.cuda.synchronize()
    wall = 0.0
    for a, k in calls:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*a, **k)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall += float(np.median(walls))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for a, k in calls:
            fn(*a, **k)
        torch.cuda.synchronize()
    busy = [e.time_range.elapsed_us() for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and kernel in e.name]
    return {"calls": len(calls), "launches": len(busy), "wall_ms": wall,
            "device_ms": sum(busy) * 1e-3}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--inputs", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("lo_wall: no CUDA device", flush=True)
        return 1
    from limap_tpu_torch.ops import lm_jointloc, trace_roots
    from limap_tpu_torch.ops.trace_roots import alpha_grid
    from limap_tpu_torch.testing import kernel_checks, lm_checks
    from limap_tpu_torch.testing.ba_wall import card_line

    res = {"root": root, "card": card_line(), "reps": args.reps}
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m.build(), (lm_jointloc, trace_roots)))
    if args.inputs:
        lo, b = path_inputs(args.inputs)
        res["I, phase 8"] = path_totals(lm_jointloc.solve, lo, "lm_jointloc",
                                        args.reps)
        res["B, phase 8"] = path_totals(trace_roots.trace_roots, b,
                                        "trace_roots", args.reps)
        print(json.dumps(res), flush=True)
        return 0
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    for name, (nl, npt) in CHAINS.items():
        params0, data = chains(nl, npt)
        wall, dev = timed(lambda: lm_jointloc.solve(params0, *data, cfg, 50),
                          args.reps)
        res[f"I {name}"] = {"wall_ms": wall, "device_ms": dev}
        print(f"[lo_wall] I, 8 chains of {nl} lines and {npt} points: "
              f"{json.dumps(res[f'I {name}'])}", flush=True)
    args_b = [torch.as_tensor(x, device="cuda") for x in
              kernel_checks.trace_roots_inputs(0, B=1280)]
    args_b.append(torch.as_tensor(alpha_grid(256), device="cuda"))
    wall, dev = timed(lambda: trace_roots.trace_roots(*args_b, 48, 4),
                      args.reps)
    res["B"] = {"wall_ms": wall, "device_ms": dev}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
