"""SOLD2 post-processing: junctions from the network's logits (softmax,
pixel shuffle, grid NMS) and the line segment detector.

The junction conversion, the NMS and the heatmap contrast normalization
are host numpy, as in the reference.  The detector's device work runs on
two hand kernels (``ops/sold2_lines.py``): T decides every candidate
junction pair (suppression, local-max sampling, mean and inlier test)
and U refines each detected segment's endpoints on a 4-D grid of
perturbations in float64.  Coordinates are (h, w); the detector wrapper
converts to (x, y) segments.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.ops.sold2_lines import (CandidateParams,
                                             sold2_candidates,
                                             sold2_refine_junctions)


# --------------------------------------------------------- junction NMS
def nms_fast(in_corners: np.ndarray, H: int, W: int,
             dist_thresh: int):
    """Grid NMS from SuperPoint.  in_corners is 3 x N [x, y, conf]."""
    grid = np.zeros((H, W), int)
    inds = np.zeros((H, W), int)
    inds1 = np.argsort(-in_corners[2, :])
    corners = in_corners[:, inds1]
    rcorners = corners[:2, :].round().astype(int)
    if rcorners.shape[1] == 0:
        return np.zeros((3, 0), int), np.zeros(0, int)
    if rcorners.shape[1] == 1:
        out = np.vstack((rcorners, in_corners[2])).reshape(3, 1)
        return out, np.zeros(1, int)
    grid[rcorners[1], rcorners[0]] = 1
    inds[rcorners[1], rcorners[0]] = np.arange(rcorners.shape[1])
    pad = int(dist_thresh)
    grid = np.pad(grid, pad, mode="constant")
    for i, rc in enumerate(rcorners.T):
        pt = (rc[0] + pad, rc[1] + pad)
        if grid[pt[1], pt[0]] == 1:
            grid[pt[1] - pad:pt[1] + pad + 1,
                 pt[0] - pad:pt[0] + pad + 1] = 0
            grid[pt[1], pt[0]] = -1
    keepy, keepx = np.where(grid == -1)
    keepy, keepx = keepy - pad, keepx - pad
    inds_keep = inds[keepy, keepx]
    out = corners[:, inds_keep]
    inds2 = np.argsort(-out[-1, :])
    out = out[:, inds2]
    return out, inds1[inds_keep[inds2]]


def super_nms(prob_pred: np.ndarray, dist_thresh: int,
              prob_thresh: float = 0.01, top_k: int = 0) -> np.ndarray:
    """NMS over a [H, W] junction probability map -> sparse score map."""
    H, W = prob_pred.shape
    ys, xs = np.where(prob_pred >= prob_thresh)
    if len(ys) == 0:
        return np.zeros((H, W))
    in_points = np.stack([xs, ys, prob_pred[ys, xs]], axis=0)
    keep_points_, _ = nms_fast(in_points, H, W, dist_thresh)
    keep_points = np.round(np.flip(keep_points_[:2, :], axis=0).T)
    keep_score = keep_points_[-1, :].T
    if top_k > 0:
        k = min(keep_points.shape[0], top_k)
        keep_points = keep_points[:k]
        keep_score = keep_score[:k]
    out = np.zeros((H, W))
    out[keep_points[:, 0].astype(int), keep_points[:, 1].astype(int)] = \
        keep_score
    return out


def junctions_from_predictions(logits_nhwc: np.ndarray, grid_size: int = 8,
                               detect_thresh: float = 1 / 65,
                               topk: int = 300) -> np.ndarray:
    """65-channel junction logits [1, Hc, Wc, 65] -> NMS'd junction
    coordinates [N, 2] (h, w), float64 on the host."""
    logits = np.asarray(logits_nhwc, np.float64)[0]
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    prob = e / e.sum(axis=-1, keepdims=True)
    prob = prob[..., :-1]  # drop dustbin
    Hc, Wc, _ = prob.shape
    # pixel shuffle: channel c = (i * grid + j)
    full = prob.reshape(Hc, Wc, grid_size, grid_size) \
        .transpose(0, 2, 1, 3).reshape(Hc * grid_size, Wc * grid_size)
    nms_map = super_nms(full, grid_size, detect_thresh, topk)
    ys, xs = np.where(nms_map > 0)
    return np.stack([ys, xs], axis=1).astype(np.float64)


def heatmap_from_logits(logits_nhwc: np.ndarray) -> np.ndarray:
    """2-channel heatmap logits [1, H, W, 2] -> [H, W] line probability
    (float64, host)."""
    x = np.asarray(logits_nhwc, np.float64)[0]
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    p = e / e.sum(axis=-1, keepdims=True)
    return p[..., 1]


# ------------------------------------------------------- line detection
def refine_heatmap(heatmap: np.ndarray, ratio: float = 0.2,
                   valid_thresh: float = 1e-2) -> np.ndarray:
    """Global contrast normalization."""
    vals = np.sort(heatmap[heatmap > valid_thresh])[::-1]
    if len(vals) == 0:
        return heatmap
    top = max(1, math.ceil(len(vals) * ratio))
    return np.clip(heatmap / np.mean(vals[:top]), 0.0, 1.0)


def refine_heatmap_local(heatmap: np.ndarray, num_blocks: int = 5,
                         overlap_ratio: float = 0.5, ratio: float = 0.2,
                         valid_thresh: float = 2e-3) -> np.ndarray:
    """Blockwise contrast normalization over overlapping blocks."""
    H, W = heatmap.shape
    inc = 1 - overlap_ratio
    h_block = round(H / (1 + (num_blocks - 1) * inc))
    w_block = round(W / (1 + (num_blocks - 1) * inc))
    count = np.zeros_like(heatmap)
    out = np.zeros_like(heatmap)
    for hi in range(num_blocks):
        for wi in range(num_blocks):
            h0 = round(hi * h_block * inc)
            w0 = round(wi * w_block * inc)
            h1 = h0 + h_block if hi < num_blocks - 1 else H
            w1 = w0 + w_block if wi < num_blocks - 1 else W
            sub = heatmap[h0:h1, w0:w1]
            if sub.max() > valid_thresh:
                sub = refine_heatmap(sub, ratio, valid_thresh)
            out[h0:h1, w0:w1] += sub
            count[h0:h1, w0:w1] += 1
    return np.clip(out / count, 0.0, 1.0)


def _bilinear(heatmap, ch, cw):
    """The reference's bilinear sample (corners weighted by ceil - x and
    x - floor: 0 at an integer coordinate), numpy float64."""
    hf = np.floor(ch).astype(int)
    hc = np.ceil(ch).astype(int)
    wf = np.floor(cw).astype(int)
    wc = np.ceil(cw).astype(int)
    return (heatmap[hf, wf] * (hc - ch) * (wc - cw)
            + heatmap[hf, wc] * (hc - ch) * (cw - wf)
            + heatmap[hc, wf] * (ch - hf) * (wc - cw)
            + heatmap[hc, wc] * (ch - hf) * (cw - wf))


class LineSegmentDetector:
    """Segments from junctions and a line heatmap, on ``device`` (None
    means cuda): candidates on kernel T, junction refinement on U."""

    def __init__(self, detect_thresh: float = 0.5, num_samples: int = 64,
                 sampling_method: str = "local_max",
                 inlier_thresh: float = 0.99,
                 max_local_patch_radius: float = 3.0,
                 lambda_radius: float = 2.0,
                 use_candidate_suppression: bool = True,
                 nms_dist_tolerance: float = 3.0,
                 use_heatmap_refinement: bool = True,
                 heatmap_refine_cfg: Optional[dict] = None,
                 use_junction_refinement: bool = True,
                 junction_refine_cfg: Optional[dict] = None, device=None):
        if sampling_method not in ("local_max", "bilinear"):
            raise ValueError(f"unknown sampling method {sampling_method!r}")
        self.device = resolve_device(device)
        self.detect_thresh = detect_thresh
        self.num_samples = num_samples
        self.sampling_method = sampling_method
        self.inlier_thresh = inlier_thresh
        self.patch_radius = max_local_patch_radius
        self.lambda_radius = lambda_radius
        self.use_candidate_suppression = use_candidate_suppression
        self.nms_dist_tolerance = nms_dist_tolerance
        self.use_heatmap_refinement = use_heatmap_refinement
        self.heatmap_refine_cfg = heatmap_refine_cfg or {
            "mode": "local", "ratio": 0.2, "valid_thresh": 0.001,
            "num_blocks": 20, "overlap_ratio": 0.5}
        self.use_junction_refinement = use_junction_refinement
        self.junction_refine_cfg = junction_refine_cfg or {
            "num_perturbs": 9, "perturb_interval": 0.25}

    def candidate_params(self) -> CandidateParams:
        return CandidateParams(
            detect_thresh=self.detect_thresh,
            inlier_thresh=self.inlier_thresh,
            lambda_radius=self.lambda_radius,
            patch_radius=self.patch_radius,
            nms_dist_tolerance=self.nms_dist_tolerance,
            use_candidate_suppression=self.use_candidate_suppression,
            bilinear=self.sampling_method == "bilinear")

    def refined_heatmap(self, heatmap: np.ndarray) -> np.ndarray:
        if not self.use_heatmap_refinement:
            return heatmap
        cfg = self.heatmap_refine_cfg
        if cfg["mode"] == "global":
            return refine_heatmap(heatmap, cfg["ratio"], cfg["valid_thresh"])
        return refine_heatmap_local(heatmap, cfg["num_blocks"],
                                    cfg["overlap_ratio"], cfg["ratio"],
                                    cfg["valid_thresh"])

    # ------------------------------------------------------------------
    def detect(self, junctions: np.ndarray,
               heatmap: np.ndarray) -> np.ndarray:
        """-> segments [S, 2, 2] in (h, w)."""
        junctions = np.asarray(junctions, np.float64)
        heatmap = np.asarray(heatmap, np.float64)
        H, W = heatmap.shape
        J = len(junctions)
        if J < 2:
            return np.zeros((0, 2, 2))
        heatmap = self.refined_heatmap(heatmap)
        si, ei = np.triu_indices(J, 1)
        hm = torch.as_tensor(heatmap, device=self.device)
        junc = torch.as_tensor(junctions, device=self.device)
        as_i32 = lambda a: torch.as_tensor(a.astype(np.int32),
                                           device=self.device)
        detected, _, _ = sold2_candidates(hm, junc, as_i32(si), as_i32(ei),
                                          self.num_samples,
                                          self.candidate_params())
        keep = detected.cpu().numpy()
        if not keep.any():
            return np.zeros((0, 2, 2))
        segments = np.stack([junctions[si[keep]], junctions[ei[keep]]],
                            axis=1)
        if self.use_junction_refinement:
            segments = self._refine_junctions(segments, heatmap, H, W, hm)
        return segments

    def _refine_junctions(self, segments, heatmap, H, W, hm=None):
        """Each segment's endpoints moved to the best of the 4-D grid of
        perturbations (kernel U), then the reference's deduplication (its
        rows in np.unique's order)."""
        cfg = self.junction_refine_cfg
        if hm is None:
            hm = torch.as_tensor(np.asarray(heatmap, np.float64),
                                 device=self.device)
        refined = sold2_refine_junctions(
            torch.as_tensor(np.asarray(segments, np.float64),
                            device=self.device), hm, self.num_samples,
            cfg["num_perturbs"], cfg["perturb_interval"]).cpu().numpy()
        return np.unique(refined.reshape(len(refined), 4),
                         axis=0).reshape(-1, 2, 2)
