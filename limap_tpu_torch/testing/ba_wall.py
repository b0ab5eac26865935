"""The hybrid BA's wall on the card, dense and CG, with the device's busy
time in a CG run: whether the card or the host sets the CG solve's pace.

The BA is phase 14's on its GT-pose line map (``refine.run_map_ba``:
the façade's 100 noisy poses, 3,986 points and the line map
``line_triangulation`` builds on the GT poses), 20 steps each.  Each
solver runs ``--reps`` times in turns (dense, CG) after one warm-up; one
more CG run under ``torch.profiler`` sums the kernels' device time and
counts the host's synchronizations.  The idle share is 1 - device time /
the median CG wall.

    python3 limap_tpu_torch/testing/ba_wall.py [--root DIR] [--reps 3]

``--root`` imports ``limap_tpu_torch`` from DIR, another checkout (an
earlier commit unpacked with ``git archive``), so that one script times
two versions on one card; by default the checkout this file is in.  The
last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def device_seconds(prof):
    """(seconds of device time, device events, host synchronizations) of
    a profiled run: the durations of the device's events (kernels, copies
    and fills; one stream, so they do not overlap) summed, and the CUDA
    runtime calls that wait for the device."""
    busy, n_dev, syncs = 0.0, 0, 0
    for e in prof.events():
        if "CUDA" in str(getattr(e, "device_type", "")):
            busy += e.time_range.elapsed_us()
            n_dev += 1
        elif "Synchronize" in e.name:
            syncs += 1
    return busy * 1e-6, n_dev, syncs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ba_wall: no CUDA device", flush=True)
        return 1
    import importlib
    import pkgutil
    from concurrent.futures import ThreadPoolExecutor

    import limap_tpu_torch.ops as ops
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.testing import refine

    # every kernel library of the checkout, one nvcc a source, together
    t0 = time.perf_counter()
    mods = [importlib.import_module(f"limap_tpu_torch.ops.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__)]
    libs = [m for m in mods if callable(getattr(m, "build", None))]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda m: m.build(), libs))
    print(f"[ba_wall] {len(libs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(dir=os.path.join(root, "tmp")
                                     if os.path.isdir(os.path.join(root,
                                                                   "tmp"))
                                     else None) as workdir:
        t0 = time.perf_counter()
        scene = refine.write_refine_scene(workdir)
        direct = refine.gt_line_map(scene, os.path.join(workdir, "map"),
                                    "cuda")
        print(f"[ba_wall] {root}: scene and GT-pose line map "
              f"({len(direct)} tracks) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        refine.run_map_ba(scene, direct, "cuda", solver="cg")   # warm-up
        walls = {"dense": [], "cg": []}
        summ = {}
        for _ in range(args.reps):
            for solver in walls:
                torch.cuda.synchronize()
                _, secs, summ[solver] = refine.run_map_ba(
                    scene, direct, "cuda", solver=solver)
                walls[solver].append(secs)
        O.hybrid_apply.launches = 0
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, prof_s, _ = refine.run_map_ba(scene, direct, "cuda",
                                             solver="cg")
            torch.cuda.synchronize()
        busy, kernels, syncs = device_seconds(prof)
        p_launches = O.hybrid_apply.launches
    cg_med = float(np.median(walls["cg"]))
    res = {"root": root, "card": card_line(), "reps": args.reps,
           "dense_s": walls["dense"], "cg_s": walls["cg"],
           "cg_median_s": cg_med,
           "cg_profiled_wall_s": prof_s, "cg_device_busy_s": busy,
           "cg_idle_share": 1.0 - busy / cg_med if cg_med > 0 else None,
           "cg_device_events": kernels, "cg_host_syncs": syncs,
           "cg_p_launches": p_launches,
           "cost_last": {k: v["cost_last"] for k, v in summ.items()},
           "trans_after": {k: v["trans_after"] for k, v in summ.items()}}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
