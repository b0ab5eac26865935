"""Kernels T and U: SOLD2's line segment detection.

``sold2_candidates`` (T) decides, for every candidate pair of junctions,
whether it is a line: the reference's suppression of long candidates
through a third junction, the heatmap sampled at ``S`` points along it
(the max over a disc of offsets within a length-dependent radius, or
bilinear), and the mean and inlier-share test.  It returns per candidate
(detected bool, mean f64 (NaN where suppressed), samples above the
threshold int32 (-1 where suppressed)).

``sold2_refine_junctions`` (U) moves both endpoints of each detected
segment on a 4-D grid of perturbations and keeps the first one whose
``S`` bilinear samples of the float64 heatmap have the highest mean.

CUDA tensors launch ``csrc/sold2_lines.cu``; CPU tensors take
:func:`candidates_plain` / :func:`refine_plain`.  Both follow the
reference's float64 numpy and float32 sampler operation for operation,
with numpy's pairwise sums (:func:`pairwise_sum`), so they agree with it
and with each other bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "sold2_lines.cu"
MAX_SAMPLES = 128
CAND_CHUNK = 4096       # candidates a step of the plain version
REFINE_CHUNK = 8        # segments a step of the plain refinement

# operations counted from csrc/sold2_lines.cu: a suppression test (float64:
# 2 differences, norm 3 + root, dot 3, 2 divisions, clip 2, acos, sin,
# product, 3 compares; acos and sin counted as 10 each), a local-max
# offset (float32: 2 adds, 2 differences, norm 3 + root, 2 clips of 2,
# compare, product, max), a bilinear sample (float64: floor and ceil 4,
# 4 weights, 8 products, 3 sums) and a sample point (float64: 2 products
# and a sum a coordinate, 2 clips)
OPS_SUPPRESS = 36
OPS_OFFSET = 16
OPS_BILINEAR = 19
OPS_POINT = 10


@dataclass(frozen=True)
class CandidateParams:
    """The detector's settings that T reads."""
    detect_thresh: float = 0.5
    inlier_thresh: float = 0.99
    lambda_radius: float = 2.0
    patch_radius: float = 3.0
    nms_dist_tolerance: float = 3.0
    use_candidate_suppression: bool = True
    bilinear: bool = False


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise summation over the last axis (float32 or
    float64, n <= 128): a plain loop below 8; else eight accumulators over
    the first n - n % 8 values, combined ((0+1)+(2+3))+((4+5)+(6+7)),
    then the rest in order."""
    n = x.shape[-1]
    if n > MAX_SAMPLES:
        raise ValueError(f"pairwise_sum takes at most {MAX_SAMPLES} values")
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    body = n - n % 8
    r = x[..., :8]
    for i in range(8, body, 8):
        r = r + x[..., i:i + 8]
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
        ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for i in range(body, n):
        res = res + x[..., i]
    return res


def sample_positions(S: int, device) -> tuple:
    """(t, 1 - t) [S] f64 as np.linspace(0, 1, S) gives them."""
    t = np.linspace(0, 1, S)
    return (torch.as_tensor(t, device=device),
            torch.as_tensor(1 - t, device=device))


def patch_offsets(radius: float) -> np.ndarray:
    """[P, 2] f32 (dh, dw) integer offsets within ``radius``, in the
    reference's order."""
    r = int(radius)
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    circle = (oy ** 2 + ox ** 2) <= radius ** 2
    return np.stack([oy[circle], ox[circle]], axis=1).astype(np.float32)


def bilinear_plain(hm: torch.Tensor, ch: torch.Tensor,
                   cw: torch.Tensor) -> torch.Tensor:
    """The reference's ``_bilinear`` (corners weighted by ceil - x and
    x - floor) in float64."""
    W = hm.shape[1]
    hf, hc = torch.floor(ch), torch.ceil(ch)
    wf, wc = torch.floor(cw), torch.ceil(cw)
    flat = hm.reshape(-1)

    def at(h, w):
        return flat[h.to(torch.int64) * W + w.to(torch.int64)]

    return (at(hf, wf) * (hc - ch) * (wc - cw)
            + at(hf, wc) * (hc - ch) * (cw - wf)
            + at(hc, wf) * (ch - hf) * (wc - cw)
            + at(hc, wc) * (ch - hf) * (cw - wf))


def _norm2(dh, dw):
    return torch.sqrt(dh * dh + dw * dw)


def suppressed_plain(junc: torch.Tensor, si: torch.Tensor, ei: torch.Tensor,
                     tol: float) -> torch.Tensor:
    """The reference's ``_suppressed``: a candidate with a third junction
    within ``tol`` of it (and projecting onto it) is suppressed."""
    start, end = junc[si], junc[ei]
    d = end - start
    len_eps = _norm2(d[:, 0], d[:, 1])[:, None] + 1e-12
    dh, dw = d[:, 0:1] / len_eps, d[:, 1:2] / len_eps
    vh = junc[None, :, 0] - start[:, 0:1]
    vw = junc[None, :, 1] - start[:, 1:2]
    cn = _norm2(vh, vw)
    dot = vh * dh + vw * dw
    proj = dot / len_eps
    cosang = dot / torch.where(cn > 0, cn, torch.ones_like(cn))
    perp = cn * torch.sin(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    on = (perp <= tol) & (proj >= 0) & (proj <= 1)
    rows = torch.arange(len(si), device=junc.device)
    count = on.sum(1) - on[rows, si].to(torch.int64) \
        - on[rows, ei].to(torch.int64)
    return count > 0


def _sample_points(start, end, t, omt, H, W):
    ch = torch.clamp(start[:, 0:1] * t + end[:, 0:1] * omt, 0, H - 1)
    cw = torch.clamp(start[:, 1:2] * t + end[:, 1:2] * omt, 0, W - 1)
    return ch, cw


def _dist_thresh(start, end, prm: CandidateParams, diag: float):
    """A candidate's local-max radius [C] f32 from its length."""
    seg_len = _norm2(start[:, 0] - end[:, 0], start[:, 1] - end[:, 1])
    return (0.5 * math.sqrt(2.0)
            + prm.lambda_radius * (seg_len / diag)).to(torch.float32)


def _disc_texels(H: int, W: int, ch: torch.Tensor, cw: torch.Tensor,
                 dist_thresh: torch.Tensor, offsets: torch.Tensor):
    """The flat texel index of each disc offset around each sample
    [..., P] and whether it lies within the sample's radius, in
    float32."""
    rh, rw = torch.round(ch), torch.round(cw)      # half to even
    ph = rh[..., None] + offsets[:, 0]
    pw = rw[..., None] + offsets[:, 1]
    d = _norm2(ch[..., None] - ph, cw[..., None] - pw)
    mask = d < dist_thresh[..., None]
    py = torch.clamp(ph, 0, H - 1).to(torch.int64)
    px = torch.clamp(pw, 0, W - 1).to(torch.int64)
    return py * W + px, mask


def local_max_plain(hm32: torch.Tensor, ch: torch.Tensor, cw: torch.Tensor,
                    dist_thresh: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """The reference's ``_local_max_sample`` in float32: ch, cw [C, S],
    dist_thresh [C, S], offsets [P, 2] -> [C, S]."""
    idx, mask = _disc_texels(*hm32.shape, ch, cw, dist_thresh, offsets)
    return (hm32.reshape(-1)[idx] * mask).amax(-1)


def candidates_plain(hm64: torch.Tensor, junc: torch.Tensor,
                     si: torch.Tensor, ei: torch.Tensor, S: int,
                     prm: CandidateParams, chunk: int = CAND_CHUNK):
    """T's plain version: (detected bool [C], mean f64 [C], inliers int32
    [C]) on the CPU tensors of :func:`sold2_candidates`."""
    H, W = hm64.shape
    dev = hm64.device
    C = len(si)
    detected = torch.zeros(C, dtype=torch.bool, device=dev)
    mean = torch.full((C,), float("nan"), dtype=torch.float64, device=dev)
    inliers = torch.full((C,), -1, dtype=torch.int32, device=dev)
    t, omt = sample_positions(S, dev)
    offsets = torch.as_tensor(patch_offsets(prm.patch_radius),
                              device=dev)
    hm32 = hm64.to(torch.float32)
    diag = math.sqrt(H * H + W * W)
    th32 = torch.tensor(prm.detect_thresh, dtype=torch.float32)
    for c0 in range(0, C, chunk):
        s_, e_ = si[c0:c0 + chunk].long(), ei[c0:c0 + chunk].long()
        live = torch.ones(len(s_), dtype=torch.bool, device=dev)
        if prm.use_candidate_suppression:
            live = ~suppressed_plain(junc, s_, e_, prm.nms_dist_tolerance)
        idx = torch.nonzero(live)[:, 0]
        if len(idx) == 0:
            continue
        start, end = junc[s_[idx]], junc[e_[idx]]
        ch, cw = _sample_points(start, end, t, omt, H, W)
        if prm.bilinear:
            feat = bilinear_plain(hm64, ch, cw)
            m = pairwise_sum(feat) / S
            above = (feat > prm.detect_thresh).sum(-1)
            det = m > prm.detect_thresh
        else:
            dth = _dist_thresh(start, end, prm, diag)
            feat = local_max_plain(hm32, ch.to(torch.float32),
                                   cw.to(torch.float32),
                                   dth[:, None].expand(-1, S), offsets)
            m32 = pairwise_sum(feat) / S
            above = (feat > th32).sum(-1)
            det = m32 > th32
            m = m32.to(torch.float64)
        if prm.inlier_thresh > 0:
            det = det & (above.to(torch.float64) / S >= prm.inlier_thresh)
        rows = c0 + idx
        detected[rows] = det
        mean[rows] = m
        inliers[rows] = above.to(torch.int32)
    return detected, mean, inliers


def perturbation_values(num_perturbs: int, interval: float) -> np.ndarray:
    """The reference's 1-D grid of endpoint moves (9 of 0.25 px)."""
    side = (num_perturbs - 1) // 2
    return np.arange(-interval * side, interval * (side + 1), interval)


def refine_plain(segs: torch.Tensor, hm64: torch.Tensor, S: int,
                 vec: torch.Tensor, chunk: int = REFINE_CHUNK
                 ) -> torch.Tensor:
    """U's plain version: segments [G, 2, 2] f64 (h, w) -> the best
    perturbation of each (first index on ties), clipped."""
    H, W = hm64.shape
    dev = segs.device
    g = torch.stack(torch.meshgrid(vec, vec, vec, vec, indexing="ij"),
                    -1).reshape(-1, 2, 2)
    t, omt = sample_positions(S, dev)
    out = torch.empty_like(segs)
    for i0 in range(0, len(segs), chunk):
        seg = segs[i0:i0 + chunk, None] + g[None]      # [c, K^4, 2, 2]
        seg[..., 0] = torch.clamp(seg[..., 0], 0, H - 1)
        seg[..., 1] = torch.clamp(seg[..., 1], 0, W - 1)
        ch = torch.clamp(seg[..., 0, 0, None] * t + seg[..., 1, 0, None]
                         * omt, 0, H - 1)
        cw = torch.clamp(seg[..., 0, 1, None] * t + seg[..., 1, 1, None]
                         * omt, 0, W - 1)
        score = pairwise_sum(bilinear_plain(hm64, ch, cw)) / S
        best = torch.argmax(score, dim=1)       # the first maximum
        out[i0:i0 + chunk] = seg[torch.arange(len(seg), device=dev), best]
    return out


def candidate_texels(hm64: torch.Tensor, junc: torch.Tensor,
                     si: torch.Tensor, ei: torch.Tensor, live: torch.Tensor,
                     S: int, prm: CandidateParams,
                     chunk: int = CAND_CHUNK) -> torch.Tensor:
    """[H, W] bool: the heatmap texels that the ``live`` candidates'
    samples read, the disc offsets within each sample's radius or the
    bilinear corners."""
    H, W = hm64.shape
    t, omt = sample_positions(S, hm64.device)
    offsets = torch.as_tensor(patch_offsets(prm.patch_radius),
                              device=hm64.device)
    diag = math.sqrt(H * H + W * W)
    seen = torch.zeros(H * W, dtype=torch.bool, device=hm64.device)
    idx = torch.nonzero(live)[:, 0]
    for c0 in range(0, len(idx), chunk):
        rows = idx[c0:c0 + chunk]
        start, end = junc[si[rows].long()], junc[ei[rows].long()]
        ch, cw = _sample_points(start, end, t, omt, H, W)
        if prm.bilinear:
            h = torch.stack([torch.floor(ch), torch.ceil(ch)], -1)
            w = torch.stack([torch.floor(cw), torch.ceil(cw)], -1)
            flat = h[..., :, None] * W + w[..., None, :]
            seen[flat.reshape(-1).to(torch.int64)] = True
            continue
        dth = _dist_thresh(start, end, prm, diag)[:, None].expand(-1, S)
        flat, mask = _disc_texels(H, W, ch.to(torch.float32),
                                  cw.to(torch.float32), dth, offsets)
        seen[flat[mask]] = True
    return seen.reshape(H, W)


def candidates_work(C: int, C_live: int, J: int, S: int, P: int,
                    bilinear: bool, suppress: bool = True, texels: int = 0):
    """(operations, bytes) T needs on this input: the suppression tests
    of every candidate, then each live candidate's samples; the bytes are
    the junctions, the pairs, the outputs and the ``texels`` distinct
    heatmap texels the samples read (:func:`candidate_texels`), each once
    (float32 for the local max, float64 bilinear)."""
    ops = (C * J * OPS_SUPPRESS if suppress else 0) + C_live * S * (
        OPS_POINT + (2 * OPS_BILINEAR if bilinear else P * OPS_OFFSET))
    return ops, J * 16 + C * (8 + 1 + 8 + 4) + texels * (8 if bilinear
                                                           else 4)


def refine_work(G: int, K: int, S: int, H: int, W: int):
    """(operations, bytes) of U: G segments x K^4 perturbations x S
    bilinear samples (float64, counted as two fp32 operations each), the
    heatmap read once, the segments read and written."""
    ops = G * K ** 4 * S * 2 * (OPS_BILINEAR + OPS_POINT)
    return ops, H * W * 8 + G * 64


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr = ctypes.c_void_p
    lib.sold2_candidates_launch.argtypes = [ptr, ptr, ptr, ptr]
    lib.sold2_candidates_launch.restype = ctypes.c_int
    lib.sold2_refine_launch.argtypes = [ptr, ptr, ptr]
    lib.sold2_refine_launch.restype = ctypes.c_int
    return lib


def _ptrs(*ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: {ndim}-D {dtype} on {device} expected, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def sold2_candidates(hm64: torch.Tensor, junc: torch.Tensor,
                     si: torch.Tensor, ei: torch.Tensor, S: int = 64,
                     prm: CandidateParams = CandidateParams()):
    """T on the heatmap [H, W] f64, junctions [J, 2] f64 (h, w) and the
    candidate pairs si, ei [C] int32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (``sold2_candidates.launches``)."""
    dev = hm64.device
    _check("heatmap", hm64, torch.float64, 2, dev)
    _check("junctions", junc, torch.float64, 2, dev)
    _check("si", si, torch.int32, 1, dev)
    _check("ei", ei, torch.int32, 1, dev)
    if junc.shape[1] != 2 or si.shape != ei.shape:
        raise ValueError("junctions [J, 2] and pairs of one length expected")
    if not 0 < S <= MAX_SAMPLES:
        raise ValueError(f"1 to {MAX_SAMPLES} samples, got {S}")
    if dev.type == "cpu":
        return candidates_plain(hm64, junc, si, ei, S, prm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    H, W = hm64.shape
    C = len(si)
    hm64 = hm64.contiguous()
    hm32 = hm64.to(torch.float32)
    t, omt = sample_positions(S, dev)
    offsets = torch.as_tensor(patch_offsets(prm.patch_radius),
                              device=dev)
    detected = torch.empty(C, dtype=torch.uint8, device=dev)
    mean = torch.empty(C, dtype=torch.float64, device=dev)
    inliers = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return detected.bool(), mean, inliers
    junc, si, ei = junc.contiguous(), si.contiguous(), ei.contiguous()
    n = np.array([C, junc.shape[0], H, W, S, offsets.shape[0],
                  int(prm.bilinear), int(prm.use_candidate_suppression)],
                 np.int32)
    f = np.array([prm.nms_dist_tolerance, prm.lambda_radius,
                  math.sqrt(H * H + W * W), 0.5 * math.sqrt(2.0),
                  prm.detect_thresh, prm.inlier_thresh], np.float64)
    ptrs = _ptrs(hm32, hm64, junc, si, ei, t, omt, offsets, detected, mean,
                 inliers)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.sold2_candidates_launch(
            ctypes.cast(ptrs, ctypes.c_void_p),
            n.ctypes.data_as(ctypes.c_void_p),
            f.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sold2_candidates launch failed: CUDA error "
                           f"{err}")
    sold2_candidates.launches += 1
    return detected.bool(), mean, inliers


sold2_candidates.launches = 0


def sold2_refine_junctions(segs: torch.Tensor, hm64: torch.Tensor,
                           S: int = 64, num_perturbs: int = 9,
                           interval: float = 0.25) -> torch.Tensor:
    """U on segments [G, 2, 2] f64 (h, w) and the heatmap [H, W] f64.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``sold2_refine_junctions.launches``)."""
    dev = hm64.device
    _check("heatmap", hm64, torch.float64, 2, dev)
    _check("segments", segs, torch.float64, 3, dev)
    if tuple(segs.shape[1:]) != (2, 2):
        raise ValueError(f"segments [G, 2, 2] expected, got "
                         f"{tuple(segs.shape)}")
    if not 0 < S <= MAX_SAMPLES:
        raise ValueError(f"1 to {MAX_SAMPLES} samples, got {S}")
    vec = torch.as_tensor(perturbation_values(num_perturbs, interval),
                          device=dev)
    if dev.type == "cpu":
        return refine_plain(segs, hm64, S, vec)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    H, W = hm64.shape
    G = segs.shape[0]
    out = torch.empty_like(segs)
    if G == 0:
        return out
    segs, hm64 = segs.contiguous(), hm64.contiguous()
    t, omt = sample_positions(S, dev)
    n = np.array([G, H, W, S, len(vec)], np.int32)
    ptrs = _ptrs(segs, hm64, t, omt, vec, out)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.sold2_refine_launch(
            ctypes.cast(ptrs, ctypes.c_void_p),
            n.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sold2_refine_junctions launch failed: CUDA "
                           f"error {err}")
    sold2_refine_junctions.launches += 1
    return out


sold2_refine_junctions.launches = 0
