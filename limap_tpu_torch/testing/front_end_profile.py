"""Where the detector's time goes on the card.

    python -m limap_tpu_torch.testing.front_end_profile [N_IMAGES]

Renders N_IMAGES views of the protocol scene (default 8), then
1. times ``tpu_lsd`` detection per image in one host thread and fanned
   out over two (host clock, device synchronized): the reason why
   ``detect_arrays_parallel`` keeps a device detector in one thread;
2. traces one image under ``torch.profiler`` and prints the device time
   by kernel name, the number of launches, and the device's idle share
   of that image's wall time.
Needs one NVIDIA GPU.  Prints one JSON line at the end.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from limap_tpu_torch.line2d.tpu_lsd import detect_segments
from limap_tpu_torch.testing import pipeline


def main(n_images: int = 8) -> int:
    if not torch.cuda.is_available():
        print("front_end_profile: no CUDA device visible")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    _, imgs, _, _ = pipeline.build_scene(n_views=n_images)
    detect_segments(imgs[0], max_segs=3000)     # warm up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for img in imgs.values():
        detect_segments(img, max_segs=3000)
    torch.cuda.synchronize()
    one_thread_ms = (time.perf_counter() - t0) / n_images * 1e3
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        list(ex.map(lambda img: detect_segments(img, max_segs=3000),
                    imgs.values()))
    torch.cuda.synchronize()
    two_threads_ms = (time.perf_counter() - t0) / n_images * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        detect_segments(imgs[0], max_segs=3000)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    for name, ms, count in kernels[:12]:
        print(f"{ms:9.3f} ms {count:6d} x  {name[:90]}")
    print(json.dumps({
        "card": card, "n_images": n_images, "image": "800x600",
        "detect_ms_per_image_one_thread": one_thread_ms,
        "detect_ms_per_image_two_threads": two_threads_ms,
        "traced_image_wall_ms": traced_ms,
        "traced_image_device_busy_ms": busy_ms,
        "traced_image_device_idle_share": 1.0 - busy_ms / traced_ms
        if busy_ms else None,
        "traced_image_launches": sum(k[2] for k in kernels)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:2])))
