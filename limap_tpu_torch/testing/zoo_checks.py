"""Kernels V, W, X and Y held to their plain versions on seeded inputs.

- V (``ops/lbd_describe.py``): segments inside the image, crossing its
  border (clipped samples), of zero length, and invalid rows; within
  ``LBD_TOL`` of plain (other summation orders).
- W (``ops/ncc_argmax.py``): random unit rows, f2 with duplicated rows
  and f1 and f2 both with duplicated rows (exact ties: the first index
  must win, for rows and for columns), D = 64 and an odd D; in either
  direction an index that differs from plain must be a near tie: both
  candidates' dots within ``NCC_TIE`` of each other in float64, and the
  scores within ``NCC_TIE``.  On the card both directions also equal the
  row-scan yardstick's bit for bit (the same fmaf chains).
- X (``ops/tplsd_decode.py``): centre maps quantized to a few levels
  (plateaus and equal scores everywhere), more and fewer peaks than
  ``max_segs``, radius 1 and 4, a map without peaks; equal bit for bit.
- Y (``ops/l2d2_patches.py``): lines inside the image, lines longer than
  its height (crops outside the warped canvas), short and axis-aligned
  lines, lines beyond the border; equal bit for bit.

``chip_smoke.py`` (phase 16a) and ``tests/test_torch_cuda.py`` share
these inputs and comparisons; on the CPU both sides are the plain
version.

    python -m limap_tpu_torch.testing.zoo_checks

builds the kernels on one GPU and prints each comparison.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from limap_tpu_torch.ops import l2d2_patches as Y
from limap_tpu_torch.ops import lbd_describe as V
from limap_tpu_torch.ops import ncc_argmax as W
from limap_tpu_torch.ops import tplsd_decode as X

LBD_TOL = 1e-5
NCC_TIE = 1e-5


def random_segments(rng, n, H, W, margin=0.0):
    lo = -margin
    return np.stack([rng.uniform(lo, W + margin, n),
                     rng.uniform(lo, H + margin, n),
                     rng.uniform(lo, W + margin, n),
                     rng.uniform(lo, H + margin, n)], 1).astype(np.float32)


def lbd_cases():
    out = []
    rng = np.random.default_rng(0)
    img = rng.random((60, 80)).astype(np.float32)
    segs = random_segments(rng, 40, 60, 80)
    out.append(("inside 60x80", img, segs, np.ones(40, bool)))
    segs = random_segments(rng, 40, 60, 80, margin=30)
    segs[0] = [10, 10, 10, 10]          # zero length
    segs[1] = [-50, 30, 150, 30]        # across the whole image
    valid = np.ones(40, bool)
    valid[[3, 7]] = False
    out.append(("border, zero length, invalid", img, segs, valid))
    img = rng.random((240, 320)).astype(np.float32)
    out.append(("240x320", img, random_segments(rng, 300, 240, 320),
                np.ones(300, bool)))
    return out


def ncc_cases():
    out = []
    rng = np.random.default_rng(1)
    for name, n1, n2, d, dup in (("300x257x64", 300, 257, 64, 0),
                                 ("duplicates 200x130x64", 200, 130, 64, 1),
                                 ("odd D 77x1000x49", 77, 1000, 49, 0),
                                 ("one column 33x1x64", 33, 1, 64, 0),
                                 ("duplicates in both 200x130x64", 200, 130,
                                  64, 2)):
        f1 = rng.normal(size=(n1, d))
        f2 = rng.normal(size=(n2, d))
        if dup:
            f2[n2 // 2:] = f2[:n2 - n2 // 2]
            f1[:20] = f2[:20]
        if dup == 2:
            f1[n1 // 2:] = f1[:n1 - n1 // 2]
        f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
        f2 /= np.linalg.norm(f2, axis=1, keepdims=True)
        out.append((name, f1.astype(np.float32), f2.astype(np.float32)))
    return out


def decode_cases():
    out = []
    rng = np.random.default_rng(2)
    for name, H, Wd, levels, max_segs, r in (
            ("8 levels, 60x80, 64 segs, r 4", 60, 80, 8, 64, 4),
            ("8 levels, 60x80, 10 segs, r 1", 60, 80, 8, 10, 1),
            ("4 levels, 61x77, 300 segs, r 4", 61, 77, 4, 300, 4),
            ("continuous, 61x77, 300 segs, r 4", 61, 77, 0, 300, 4),
            ("continuous, 600x800, 512 segs, r 4", 600, 800, 0, 512, 4),
            ("no peaks, 30x40, 16 segs, r 4", 30, 40, -1, 16, 4)):
        c = rng.random((H, Wd))
        if levels > 0:
            c = np.floor(c * levels) / levels
        elif levels < 0:
            c = np.full((H, Wd), 0.2)
        disp = rng.normal(size=(H, Wd, 4)) * 5
        out.append((name, c.astype(np.float32), disp.astype(np.float32),
                    max_segs, r))
    return out


def patch_lines(rng, H, W):
    lines = [random_segments(rng, 30, H, W).reshape(-1, 2, 2)]
    lines.append(np.array([[[5, 3], [70, 55]],         # longer than H
                           [[-20, 10], [120, 50]],     # beyond the border
                           [[30, 30], [32, 31]],       # short: new_h = 5
                           [[10, 20], [70, 20]],       # horizontal
                           [[40, 2], [40, 57]],        # vertical
                           [[0, 0], [79, 59]]], np.float32))
    return np.concatenate(lines)


def patch_cases():
    rng = np.random.default_rng(3)
    out = []
    for name, H, Wd in (("60x80", 60, 80), ("61x47", 61, 47)):
        img = rng.random((H, Wd)).astype(np.float32)
        out.append((name, img, patch_lines(rng, H, Wd)))
    return out


def check_lbd(device="cuda"):
    for name, img, segs, valid in lbd_cases():
        args = [torch.as_tensor(a, device=device) for a in (img, segs, valid)]
        k = V.lbd_describe(*args)
        p = V.lbd_describe_plain(*args)
        err = float((k - p).abs().max())
        yield "lbd_describe", name, {"ok": err <= LBD_TOL,
                                     "max_abs_err": err}


def ncc_witness(f1, f2, ik, sk, ip, sp):
    """Rows whose index differs, and of them those that are not a near
    tie (float64 dots of both columns within NCC_TIE, scores too)."""
    ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
    rows = np.nonzero(ik != ip)[0]
    a = np.asarray(f1, np.float64)
    b = np.asarray(f2, np.float64)
    bad = [int(i) for i in rows
           if abs(a[i] @ b[ik[i]] - a[i] @ b[ip[i]]) > NCC_TIE]
    serr = float((sk.cpu() - sp.cpu()).abs().max()) if len(ik) else 0.0
    return rows, bad, serr


def first_indices(a, b, n):
    """The first argmax over b's rows of a[k] . b for k < n (numpy)."""
    return np.array([int(np.argmax(b @ v)) for v in a[:n]])


def check_ncc(device="cuda"):
    for name, f1, f2 in ncc_cases():
        t1, t2 = (torch.as_tensor(a, device=device) for a in (f1, f2))
        k12, ks12, k21, ks21 = W.ncc_argmax_both(t1, t2)
        p12, ps12, p21, ps21 = W.ncc_argmax_both_plain(t1, t2)
        rows, bad, serr = ncc_witness(f1, f2, k12, ks12, p12, ps12)
        cols, badc, serrc = ncc_witness(f2, f1, k21, ks21, p21, ps21)
        res = {"ok": not bad and not badc and max(serr, serrc) <= NCC_TIE,
               "rows_differ": len(rows), "cols_differ": len(cols),
               "not_near_tie": (bad + badc)[:5], "score_max_abs_err": serr,
               "col_score_max_abs_err": serrc}
        if name.startswith("duplicates"):
            # an exact copy scores equal dots: the first index must win
            res["first_index"] = bool(np.array_equal(
                k12[:20].cpu().numpy(), first_indices(f1, f2, 20)))
            res["first_col_index"] = bool(np.array_equal(
                k21[:20].cpu().numpy(), first_indices(f2, f1, 20)))
            res["ok"] &= res["first_index"] and res["first_col_index"]
        if t1.is_cuda:
            # the same fmaf chains as the row scan's, in both directions
            r12, rs12 = W.ncc_argmax_rowscan(t1, t2)
            r21, rs21 = W.ncc_argmax_rowscan(t2, t1)
            res["rowscan_equal"] = bool(
                torch.equal(k12, r12) and torch.equal(ks12, rs12)
                and torch.equal(k21, r21) and torch.equal(ks21, rs21))
            res["ok"] &= res["rowscan_equal"]
        yield "ncc_argmax", name, res


def check_decode(device="cuda"):
    for name, c, d, max_segs, r in decode_cases():
        tc, td = (torch.as_tensor(a, device=device) for a in (c, d))
        sk, nk = X.tplsd_decode(tc, td, max_segs, 0.25, r)
        sp, np_ = X.tplsd_decode_plain(tc, td, max_segs, 0.25, r)
        equal = torch.equal(sk, sp) and int(nk) == int(np_)
        yield "tplsd_decode", name, {"ok": equal, "count": int(np_),
                                     "bit_equal": equal}


def check_patches(device="cuda"):
    for name, img, lines in patch_cases():
        minv, boxes = Y.line_boxes(lines, img.shape)
        args = [torch.as_tensor(a, device=device) for a in (img, minv, boxes)]
        k = Y.l2d2_patches(*args)
        p = Y.l2d2_patches_plain(*args)
        equal = torch.equal(k, p)
        yield "l2d2_patches", name, {
            "ok": equal, "bit_equal": equal, "lines": len(lines),
            "outside_canvas": int(((boxes[:, 0] < 0) | (boxes[:, 1] < 0))
                                  .sum()),
            "max_abs_err": float((k - p).abs().max())}


def check_all(device="cuda"):
    yield from check_lbd(device)
    yield from check_ncc(device)
    yield from check_decode(device)
    yield from check_patches(device)


def main():
    ok = True
    for name, case, res in check_all("cuda"):
        print(f"{name} {case}: {json.dumps(res)}", flush=True)
        ok &= bool(res["ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
