"""Kernels R, S, T and U held to their plain versions on seeded inputs.

- R (``ops/log_sinkhorn.py``): ragged M != N, a one-row and a one-column
  problem, 0, 50 and 100 iterations; within ``SINKHORN_ATOL`` +
  ``SINKHORN_RTOL`` |Z| of plain (both fp32, other summation orders and
  exp implementations), and bit for bit from one launch to the next.
  On the card also the band design's cases (``SINKHORN_BAND_CASES``:
  the runner's and SuperGlue's sizes, rows past shared memory, couplings
  too wide for v in shared memory, M = 0, N = 0, -inf rows, columns and
  bands), and the first design held to plain on the same inputs.
- S (``ops/sample_descriptors.py``): clamp mode with 256 channels at the
  image border, outside it and on cell corners; zero mode with 128
  channels across the grid's edges; within ``SAMPLE_TOL``.
- T (``ops/sold2_lines.py``): heatmaps with drawn lines and integer
  junctions, one whose samples sit exactly on ``detect_thresh``, with
  and without suppression, local max and bilinear; flags, means and
  inlier counts equal, a flip excused only where the mean lies within
  ``FLIP_TOL`` of the threshold.
- U: integer junctions (first and last sample 0), half-pixel ones and
  segments at the image border; equal bit for bit.

``chip_smoke.py`` (phase 15a) and ``tests/test_torch_cuda.py`` share
these inputs and comparisons; on the CPU both sides are the plain
version.

    python -m limap_tpu_torch.testing.learned_checks

builds the kernels on one GPU and prints each comparison.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from limap_tpu_torch.ops import log_sinkhorn as R
from limap_tpu_torch.ops import sample_descriptors as S
from limap_tpu_torch.ops import sold2_lines as TU

SINKHORN_ATOL = 1e-4
SINKHORN_RTOL = 1e-5
SAMPLE_TOL = 1e-6
FLIP_TOL = 1e-6

SINKHORN_CASES = [(5, 7, 50, 0.5), (64, 80, 100, 1.0), (1, 33, 50, 0.5),
                  (45, 1, 100, -0.3), (257, 130, 50, 0.5),
                  (300, 511, 0, 0.5), (2048, 2048, 100, 1.0)]


def sinkhorn_scores(M, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, N)) * 3).astype(np.float32)


def check_sinkhorn(device="cuda"):
    for k, (M, N, iters, b) in enumerate(SINKHORN_CASES):
        s = torch.as_tensor(sinkhorn_scores(M, N, k), device=device)
        z1 = R.log_sinkhorn(s, b, iters)
        z2 = R.log_sinkhorn(s, b, iters)
        zp = R.log_sinkhorn_plain(s, b, iters)
        err = float((z1 - zp).abs().max())
        tol = SINKHORN_ATOL + SINKHORN_RTOL * float(zp.abs().max())
        res = {"max_abs_err": err, "tol": tol,
               "repeats": bool(torch.equal(z1, z2)),
               "finite": bool(torch.isfinite(z1).all())}
        res["ok"] = err <= tol and res["repeats"] and res["finite"]
        yield "log_sinkhorn", f"{M}x{N}x{iters}", res


# R's band design (``ops/log_sinkhorn.py::plan``): (name, M, N, iters,
# bin, rows_cap, scores).  ``rows_cap`` >= 0 leaves the rows of a band
# past it in global memory.  "inf" scores hold a row and a column of
# -inf and rows 16-31 all -inf (16 bands of their own where a band is a
# row).
SINKHORN_BAND_CASES = [
    ("the runner's largest pair", 556, 565, 50, 1.0, -1, "normal"),
    ("200 x 200", 199, 199, 50, 0.5, -1, "normal"),
    ("a small coupling", 300, 200, 30, 0.5, -1, "normal"),
    ("rows past 8 a band from global memory", 2000, 300, 20, 0.5, 8,
     "normal"),
    ("SuperGlue's coupling", 2048, 2048, 100, 1.0, -1, "normal"),
    ("4,097 x 4,097, bands past shared memory", 4096, 4096, 20, 1.0, -1,
     "normal"),
    ("40,001 columns, every row from global memory", 300, 40000, 10, 0.5,
     -1, "normal"),
    ("60,001 columns, v and every row from global memory", 40, 60000, 10,
     0.5, -1, "normal"),
    ("M = 0", 0, 40, 10, 0.5, -1, "normal"),
    ("N = 0", 40, 0, 10, 0.5, -1, "normal"),
    ("-inf rows, a column and bands", 48, 40, 30, 0.5, -1, "inf"),
    ("-inf rows, a column and bands, rows from global memory", 48, 40, 30,
     0.5, 0, "inf"),
    ("-inf rows, a column and bands, v from global memory", 48, 60000, 10,
     0.5, -1, "inf"),
]


def band_scores(M, N, seed, kind):
    s = sinkhorn_scores(M, N, seed)
    if kind == "inf":
        s[3, :] = -np.inf
        s[:, 7] = -np.inf
        s[16:32, :] = -np.inf
    return s


def compare_z(z, zp):
    """(max abs error over the entries finite in ``zp``, its tolerance,
    whether the non-finite entries are the same)."""
    fin = torch.isfinite(zp)
    same = bool(torch.equal(torch.isfinite(z), fin)) and bool(
        torch.equal(torch.nan_to_num(z[~fin]), torch.nan_to_num(zp[~fin])))
    if not fin.any():
        return 0.0, SINKHORN_ATOL, same
    err = float((z[fin] - zp[fin]).abs().max())
    return err, SINKHORN_ATOL + SINKHORN_RTOL * float(zp[fin].abs().max()), \
        same


def check_sinkhorn_bands(device="cuda"):
    """R's band design on each case against plain within the tolerance
    above, bit for bit on a repeat; the first design (the yardstick)
    against plain on the same input."""
    for k, (name, M, N, iters, b, cap, kind) in enumerate(
            SINKHORN_BAND_CASES):
        s = torch.as_tensor(band_scores(M, N, 100 + k, kind),
                            device=device)
        zp = R.log_sinkhorn_plain(s, b, iters)
        z1 = R.launch(s, b, iters, cap)
        z2 = R.launch(s, b, iters, cap)
        zs = R.log_sinkhorn_scan(s, b, iters)
        err, tol, same = compare_z(z1, zp)
        scan_err, _, scan_same = compare_z(zs, zp)
        res = {"plan": R.plan(M, N, s.device, cap),
               "max_abs_err": err, "tol": tol, "infinities_equal": same,
               "repeats": bool(torch.equal(torch.nan_to_num(z1),
                                           torch.nan_to_num(z2))),
               "scan_max_abs_err": scan_err}
        res["ok"] = (err <= tol and same and res["repeats"]
                     and scan_err <= tol and scan_same)
        yield "log_sinkhorn bands", f"{name} ({M}x{N}x{iters})", res


def _events_ms(fn, reps):
    from limap_tpu_torch.testing.hybrid_checks import device_ms
    return device_ms(fn, reps)[0]


def sinkhorn_split(scores, bin_score, iters, reps=5):
    """Kernel R's time by part on the card, on one input (ms of device
    time, ``hybrid_checks.device_ms``, the least of two rounds): the
    launch with the load and the write (no iteration), then the
    iterations' barriers, u-pass, v-partials and merge, each the
    difference of two runs with one part more
    (:func:`~limap_tpu_torch.ops.log_sinkhorn.launch_parts`)."""
    def run(it, parts):
        if parts is None:
            return _events_ms(lambda: R.launch(scores, bin_score, it), reps)
        return _events_ms(
            lambda: R.launch_parts(scores, bin_score, it, parts), reps)

    # each configuration the least of two rounds
    configs = ([(0, None)] + [(iters, p) for p in R.TIMED_PARTS]
               + [(iters, None)])
    rounds = [[run(it, p) for it, p in configs] for _ in range(2)]
    cum = [min(a, b) for a, b in zip(*rounds)]
    out = {"load_write_ms": cum[0]}
    for k, name in enumerate(("barriers", "u_pass", "v_partials", "merge")):
        out[f"{name}_ms"] = cum[k + 1] - cum[k]
    out["all_ms"] = cum[-1]
    return out


def sample_inputs(mode, seed=0):
    rng = np.random.default_rng(seed)
    if mode == "clamp":
        Hc, Wc, D = 15, 20, 256
        grid = rng.normal(size=(Hc, Wc, D)).astype(np.float32)
        border = [[0, 0], [Wc * 8 - 0.5, Hc * 8 - 0.5], [-7.0, 3.0],
                  [Wc * 8 + 20.0, 50.0], [4.0, 4.0], [12.0, 20.0]]
        pts = np.concatenate([rng.uniform(0, [Wc * 8, Hc * 8], (193, 2)),
                              border]).astype(np.float32)
        return grid, pts, 8
    Hc, Wc, D = 12, 17, 128
    grid = rng.normal(size=(Hc, Wc, D)).astype(np.float32)
    edge = [[0, 0], [-2.0, 5.0], [Hc * 4 + 1.0, 3.0], [Hc * 4 - 1, Wc * 4 - 1],
            [2.0, 2.0], [-9.0, -9.0]]
    pts = np.concatenate([rng.uniform(-3, [Hc * 4 + 3, Wc * 4 + 3], (97, 2)),
                          edge]).astype(np.float64)
    return grid, pts, 4


def check_sample(device="cuda"):
    for mode in ("clamp", "zero"):
        grid, pts, scale = sample_inputs(mode)
        g = torch.as_tensor(grid, device=device)
        p = torch.as_tensor(pts, device=device)
        out = S.sample_descriptors(g, p, mode, scale)
        plain = (S.sample_clamp_plain if mode == "clamp"
                 else S.sample_zero_plain)(g, p, scale)
        err = float((out - plain).abs().max())
        res = {"max_abs_err": err, "points": len(pts),
               "channels": grid.shape[2], "ok": err <= SAMPLE_TOL}
        yield "sample_descriptors", mode, res


def line_heatmap(H, W, n_lines, seed, value=1.0):
    """A [H, W] f64 heatmap of faint noise with ``n_lines`` bright
    segments between integer junctions, and those junctions plus a few
    strays."""
    rng = np.random.default_rng(seed)
    hm = rng.random((H, W)) ** 4 * 0.3
    junc = []
    for _ in range(n_lines):
        a = rng.integers([2, 2], [H - 2, W - 2])
        b = rng.integers([2, 2], [H - 2, W - 2])
        n = int(2 * np.abs(b - a).max()) + 2
        ts = np.linspace(0, 1, n)
        ys = np.rint(a[0] + (b[0] - a[0]) * ts).astype(int)
        xs = np.rint(a[1] + (b[1] - a[1]) * ts).astype(int)
        hm[ys, xs] = value
        junc += [a, b]
    junc += list(rng.integers([0, 0], [H, W], (4, 2)))
    return hm, np.unique(np.asarray(junc, np.float64), axis=0)


def candidate_cases():
    """(name, heatmap, junctions, params)."""
    P = TU.CandidateParams
    hm, junc = line_heatmap(96, 128, 12, 1)
    yield "lines", hm, junc, P()
    yield "lines no suppression", hm, junc, P(use_candidate_suppression=False)
    yield "lines bilinear", hm, junc, P(detect_thresh=0.2, inlier_thresh=0.5,
                                        bilinear=True)
    # every line sample exactly at the threshold: mean == 0.5, not > 0.5
    hm, junc = line_heatmap(64, 80, 6, 2, value=0.5)
    yield "ties at detect_thresh", hm, junc, P(inlier_thresh=0.0)
    hm, junc = line_heatmap(64, 80, 6, 3, value=0.5)
    yield "ties, threshold below", hm, junc, P(detect_thresh=0.4999999)


def pairs(J, device):
    si, ei = np.triu_indices(J, 1)
    return (torch.as_tensor(si, dtype=torch.int32, device=device),
            torch.as_tensor(ei, dtype=torch.int32, device=device))


def compare_candidates(out_k, out_p, thresh):
    """Equal flags, means and counts, but for flips whose means lie within
    FLIP_TOL of the threshold."""
    dk, mk, ik = (x.cpu() for x in out_k)
    dp, mp, ip = (x.cpu() for x in out_p)
    diff = (dk != dp) | (ik != ip) | ~((mk == mp) | (mk.isnan() & mp.isnan()))
    idx = torch.nonzero(diff)[:, 0]
    excused = 0
    for c in idx.tolist():
        m = [float(x) for x in (mk[c], mp[c]) if not np.isnan(float(x))]
        if m and min(abs(x - thresh) for x in m) <= FLIP_TOL:
            excused += 1
    res = {"candidates": len(dk), "detected": int(dk.sum()),
           "detected_plain": int(dp.sum()), "differ": len(idx),
           "excused": excused}
    res["ok"] = excused == len(idx)
    return res


def check_candidates(device="cuda"):
    for name, hm, junc, prm in candidate_cases():
        h = torch.as_tensor(hm, device=device)
        j = torch.as_tensor(junc, device=device)
        si, ei = pairs(len(junc), device)
        out_k = TU.sold2_candidates(h, j, si, ei, 64, prm)
        out_p = TU.candidates_plain(h, j, si, ei, 64, prm)
        yield "sold2_candidates", name, compare_candidates(
            out_k, out_p, prm.detect_thresh)


def refine_cases():
    hm, junc = line_heatmap(96, 128, 12, 4)
    rng = np.random.default_rng(5)
    k = rng.integers(0, len(junc), (24, 2))
    segs = junc[k]                                   # integer junctions
    half = segs[:6] + 0.5                            # half-pixel ones
    border = np.array([[[0, 0], [95, 127]], [[0, 64], [95, 64]],
                       [[50, 0], [50, 127]]], np.float64)
    yield "integer junctions", hm, segs
    yield "half-pixel and border", hm, np.concatenate([half, border])


def check_refine(device="cuda"):
    for name, hm, segs in refine_cases():
        h = torch.as_tensor(hm, device=device)
        s = torch.as_tensor(segs, device=device)
        out = TU.sold2_refine_junctions(s, h)
        vec = torch.as_tensor(TU.perturbation_values(9, 0.25), device=device)
        plain = TU.refine_plain(s, h, 64, vec)
        res = {"segments": len(segs), "equal": bool(torch.equal(out, plain)),
               "max_abs_err": float((out - plain).abs().max())}
        res["ok"] = res["equal"]
        yield "sold2_refine_junctions", name, res


def check_all(device="cuda"):
    yield from check_sinkhorn(device)
    if device != "cpu":
        yield from check_sinkhorn_bands(device)
    yield from check_sample(device)
    yield from check_candidates(device)
    yield from check_refine(device)


def main():
    if not torch.cuda.is_available():
        print("learned_checks: no CUDA device visible", flush=True)
        return 2
    ok = True
    for name, case, res in check_all():
        print(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}",
              flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
