"""Kernel J (``ops/vp_detect.py``) held to its plain version on seeded
inputs: ragged images, an empty image, an image of fewer lines than
hypotheses, tied counts and lines exactly on the inlier threshold, and
an image whose inlier mask does not fit in shared memory (global
scratch).
``chip_smoke.py`` (phases 2 and 11) and ``tests/test_torch_cuda.py``
share these inputs and the comparison; ``tests/test_torch_vplib.py``
runs it on the CPU.

    python -m limap_tpu_torch.testing.vp_checks

builds the kernel on one GPU and prints each comparison.

The kernel computes the hypotheses and the distances in the plain
version's order of correctly rounded fp32 operations, so the labels and
the VP counts must be equal; both refit in float64, so the VPs must
agree within ``VP_TOL``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from limap_tpu_torch.ops import vp_detect

VP_TOL = 1e-5
# fp32 operations (a multiply-add as two) counted from csrc/vp_detect.cu:
# a hypothesis (cross product 9, norm 6, division 4 with the epsilon,
# the flag), a (hypothesis, valid line) pair (line 8, norm 6, distance 6,
# test 1), a popcount and an and a mask word a hypothesis a round, and an
# accepted inlier's six fp64 moments at half the fp32 rate (24)
OPS_J = {"hypothesis": 20, "pair": 21, "word": 3, "inlier": 24}


def _pencil(rng, vp, n, noise=0.3, hw=(480, 640)):
    """Segments [n, 4] pointing at ``vp`` (homogeneous; 0 last for a
    direction) in an image of ``hw``."""
    h, w = hw
    out = []
    for _ in range(n):
        mid = rng.uniform([30, 30], [w - 30, h - 30])
        d = np.asarray(vp[:2], np.float64) if abs(vp[2]) < 1e-9 \
            else vp[:2] / vp[2] - mid
        d = d / (np.linalg.norm(d) + 1e-12)
        half = rng.uniform(25, 60)
        jitter = lambda: rng.normal(size=2) * noise
        out.append(np.concatenate([mid - d * half + jitter(),
                                   mid + d * half + jitter()]))
    return np.asarray(out).reshape(-1, 4)


def random_image(rng, n, n_vps=3, junk=0.1):
    """``n`` segments from ``n_vps`` pencils plus a share of junk."""
    n_junk = int(n * junk)
    per = (n - n_junk) // n_vps
    vps = [np.array([rng.uniform(-3000, 3000), rng.uniform(-3000, 3000), 1.0])
           for _ in range(n_vps - 1)] + [np.array([1.0, rng.uniform(-.2, .2),
                                                    0.0])]
    segs = [_pencil(rng, v, per) for v in vps]
    rest = n - per * n_vps
    segs.append(_pencil(rng, np.array([rng.normal(), rng.normal(), 0.0]),
                        rest, noise=40.0))
    return np.concatenate(segs)[rng.permutation(n)]


def on_threshold_image():
    """Horizontal segments whose start lies exactly 1 px (the threshold)
    or 1 px and a few float32 ulps off the line from their midpoint to the
    VP at infinity (1, 0, 0), which the first two lines (horizontal)
    make; the next ones are duplicates of one segment (tied counts)."""
    segs = [[100.0, 50.0, 200.0, 50.0], [120.0, 300.0, 260.0, 300.0]]
    for k in range(12):
        y = 80.0 + 20 * k
        segs.append([50.0 + 10 * k, y, 250.0 + 10 * k, y + 2.0])   # dist 1
    for k in range(6):
        y = np.float32(40.0 + 30 * k)
        ey = np.nextafter(np.nextafter(y + np.float32(2), np.float32(1e9)),
                          np.float32(1e9))
        segs.append([300.0, float(y), 500.0, float(ey)])           # > 1
    segs += [[400.0, 100.0, 600.0, 300.0]] * 6 + [[410.0, 90.0, 610.0,
                                                     290.0]] * 6
    return np.asarray(segs)


def _tensors(per_image, n_hyp, device, seed, min_length=40.0):
    from limap_tpu_torch.vplib.jlinkage import (draw_hypotheses,
                                                segment_tensors)
    gen = torch.Generator().manual_seed(seed)
    t = [segment_tensors(s, min_length, device) for s in per_image]
    n = [len(s) for s in per_image]
    ia, ib = [], []
    for k in n:
        a, b = draw_hypotheses(gen, max(k, 1), n_hyp)
        ia.append(a)
        ib.append(b)
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(n)]),
                              dtype=torch.int64, device=device)
    cat = [torch.cat([x[k] for x in t]) for k in range(4)]
    return (*cat, offsets, torch.stack(ia).to(device),
            torch.stack(ib).to(device))


def seeded_cases(device="cuda"):
    """Yields (case, inputs, max_vps, min_supports, th)."""
    rng = np.random.default_rng(0)
    ragged = [random_image(rng, n) for n in (491, 37, 950, 120, 3)]
    ragged.insert(2, np.zeros((0, 4)))
    yield ("ragged 491/37/0/950/120/3 lines, H 512",
           _tensors(ragged, 512, device, 0), 8, 10, 1.0)
    yield ("20 lines < H 512, 4 VPs", _tensors(
        [random_image(rng, 20, n_vps=2)], 512, device, 1), 4, 3, 2.0)
    yield ("on the threshold and tied counts", _tensors(
        [on_threshold_image()] * 2, 64, device, 2, min_length=10.0), 8, 3,
           1.0)
    big = [random_image(rng, 3500, n_vps=4)]
    yield ("3500 lines (mask past shared memory)",
           _tensors(big, 512, device, 3), 8, 10, 1.0)


def compare_detect(out_k, out_p):
    """Kernel (labels, vps, n_found) against plain."""
    (lk, vk, nk), (lp, vp, np_) = out_k, out_p
    res = {"lines": int(lk.numel()), "images": int(nk.numel()),
           "vps_found": int(np_.sum()),
           "labelled": int((lp >= 0).sum()),
           "labels_differ": int((lk != lp).sum()),
           "n_found_differ": int((nk != np_).sum()),
           "max_abs_err": float((vk - vp).abs().max()) if vk.numel()
           else 0.0}
    res["ok"] = (res["labels_differ"] == 0 and res["n_found_differ"] == 0
                 and res["max_abs_err"] <= VP_TOL)
    return res


def detect_work(coords, mids, starts, valid, offsets, ia, ib, max_vps,
                labels, n_found):
    """Work units of kernel J (:data:`OPS_J`) on this run's data: every
    hypothesis, every (hypothesis, valid line) pair, the mask words read
    in each round that ran (the accepted ones and the one that ended
    the image), and each accepted inlier."""
    off = offsets.tolist()
    H = ia.shape[1]
    work = {"hypothesis": 0, "pair": 0, "word": 0, "inlier": 0}
    for i in range(len(off) - 1):
        n = off[i + 1] - off[i]
        if n == 0:
            continue
        work["hypothesis"] += H
        work["pair"] += H * int(valid[off[i]:off[i + 1]].sum())
        rounds = min(int(n_found[i]) + 1, max_vps)
        work["word"] += rounds * H * ((n + 31) // 32)
    work["inlier"] = int((labels >= 0).sum())
    return work


def detect_bytes(coords, ia, n_images, max_vps):
    """Bytes kernel J must move: each input once, each output once."""
    N = coords.shape[0]
    return (N * (12 + 8 + 8 + 1) + 8 * (n_images + 1) + 8 * ia.numel()
            + N * 4 + n_images * max_vps * 12 + n_images * 4)


def check_all(device="cuda"):
    """Yields (case, result) of every seeded case on ``device``."""
    for case, inputs, max_vps, min_sup, th in seeded_cases(device):
        args = (*inputs, max_vps, min_sup, th)
        yield case, compare_detect(vp_detect.detect(*args),
                                   vp_detect.detect_plain(*args))


def main():
    from limap_tpu_torch.ops import cuda_build
    vp_detect.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}",
              flush=True)
    ok = True
    for case, res in check_all():
        print(f"vp_detect [{case}]: {json.dumps(res)}", flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
