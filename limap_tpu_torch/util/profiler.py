"""Stage timing with an optional torch profiler trace."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


class StageProfiler:
    """Wall-clock per stage.  On a CUDA ``device`` a stage ends with a
    ``torch.cuda.synchronize()``, so its time is the card's work and not
    the enqueue.  With ``trace_dir`` every stage also writes a chrome
    trace ``<trace_dir>/<name>.json``."""

    def __init__(self, trace_dir: Optional[str] = None, device=None):
        self.times: Dict[str, float] = {}
        self.trace_dir = trace_dir
        self.cuda = (device is not None
                     and torch.device(device).type == "cuda")

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = None
        if self.trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if prof is not None:
                prof.stop()
                os.makedirs(self.trace_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(self.trace_dir, f"{name}.json"))

    def report(self) -> Dict[str, float]:
        total = sum(self.times.values())
        print("[Stage timings]")
        for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]):
            print(f"  {k:<30s} {v:8.2f}s  ({100 * v / max(total, 1e-9):.0f}%)")
        print(f"  {'TOTAL':<30s} {total:8.2f}s")
        return dict(self.times)

    def dump(self, fname: str) -> None:
        with open(fname, "w") as f:
            json.dump(self.times, f, indent=2)
