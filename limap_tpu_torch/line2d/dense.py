"""Dense-warp line matching (the reference's RoMa-based matcher family).

The line matching itself (points along each source line pushed through
a dense warp, their distance to each target line's infinite line, gated
by overlap and certainty, symmetrized, one-to-one or one-to-many) runs
in float64 torch ops on the device, as the reference's numpy.  The warp
is pluggable:

- :class:`CorrelationFlowMatcher`, weight-free: mean-free unit 8 x 8
  patches on a stride-8 grid, each matched to its best correlation in
  the other image, both directions from one pass over the correlations
  (kernel W, ``ops/ncc_argmax.py``), the certainty that correlation,
  both upsampled to full resolution by ``util/cv2_ops``'s INTER_LINEAR
  resize;
- :class:`RoMaLineMatcher`, which needs the external ``romatch`` package
  and its checkpoint, and raises as the reference does without them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.ops.ncc_argmax import ncc_argmax_both
from limap_tpu_torch.util import cv2_ops


class BaseDenseLineMatcherOptions(NamedTuple):
    n_samples: int = 21
    segment_percentage_th: float = 0.2
    pixel_th: float = 10.0
    one_to_many: bool = False


class BaseDenseMatcher:
    """A dense warp in normalized coordinates ([-1, 1])."""

    def to_normalized_coordinates(self, coords, h, w):
        return torch.stack([2 / w * coords[..., 0] - 1,
                            2 / h * coords[..., 1] - 1], dim=-1)

    def to_unnormalized_coordinates(self, coords, h, w):
        return torch.stack([(coords[..., 0] + 1) * w / 2,
                            (coords[..., 1] + 1) * h / 2], dim=-1)

    def get_sample_thresh(self) -> float:
        raise NotImplementedError

    def get_warping_symmetric(self, img1, img2):
        raise NotImplementedError


class CorrelationFlowMatcher(BaseDenseMatcher):
    """Weight-free dense warp: stride-8 8x8 mean-free NCC patches, global
    correlation, certainty = the correlation peak."""

    def __init__(self, stride: int = 8, sample_thresh: float = 0.3,
                 device=None):
        self.stride = stride
        self.sample_thresh = sample_thresh
        self.device = resolve_device(device)

    def get_sample_thresh(self):
        return self.sample_thresh

    def _features(self, img: np.ndarray):
        s = self.stride
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape
        Hc, Wc = H // s, W // s
        t = torch.as_tensor(np.ascontiguousarray(img[:Hc * s, :Wc * s]),
                            device=self.device)
        patches = t.reshape(Hc, s, Wc, s).permute(0, 2, 1, 3).reshape(
            Hc * Wc, s * s)
        patches = patches - patches.mean(dim=1, keepdim=True)
        norm = torch.linalg.vector_norm(patches, dim=1, keepdim=True) + 1e-6
        return (patches / norm).contiguous(), (Hc, Wc), (H, W)

    def _one_direction(self, idx, score, ga, gb, shape_a, shape_b):
        """The warp and certainty of image a from each of its cells' best
        cell ``idx`` of image b and that correlation ``score``."""
        Ha, Wa = shape_a
        Hc, Wc = ga
        Wc2 = gb[1]
        ty = (torch.div(idx, Wc2, rounding_mode="floor").to(torch.float64)
              + 0.5) * self.stride
        tx = ((idx % Wc2).to(torch.float64) + 0.5) * self.stride
        Hb, Wb = shape_b
        warp_c = torch.stack([2 * tx / Wb - 1, 2 * ty / Hb - 1],
                             dim=-1).reshape(Hc, Wc, 2).to(torch.float32)
        cert_c = score.reshape(Hc, Wc)
        warp = cv2_ops.resize(warp_c, (Wa, Ha), cv2_ops.INTER_LINEAR)
        cert = cv2_ops.resize(cert_c, (Wa, Ha), cv2_ops.INTER_LINEAR)
        return warp, cert

    def get_warping_symmetric(self, img1, img2):
        f1, g1, s1 = self._features(img1)
        f2, g2, s2 = self._features(img2)
        idx12, s12, idx21, s21 = ncc_argmax_both(f1, f2)     # kernel W
        warp12, cert12 = self._one_direction(idx12, s12, g1, g2, s1, s2)
        warp21, cert21 = self._one_direction(idx21, s21, g2, g1, s2, s1)
        return warp12, cert12, warp21, cert21


@register_extractor("dense_naive")
class DenseNaiveExtractor(BaseDetector):
    """Stores the raw image and the lines."""

    def get_module_name(self):
        return "dense_naive"

    def extract(self, camview, segs) -> dict:
        return self.extract_array(camview.read_image(set_gray=True), segs)

    def extract_array(self, img, segs) -> dict:
        img = np.asarray(img)
        segs = np.asarray(segs)
        lines = segs[:, :4].reshape(-1, 2, 2) if len(segs) else \
            np.zeros((0, 2, 2))
        return {"image": img, "lines": lines.astype(np.float32),
                "image_shape": np.asarray(img.shape[:2])}


def _sample_warp(warp: torch.Tensor, cert: torch.Tensor, pts: torch.Tensor):
    """Bilinear sample (float64) of the dense warp [H, W, 2] and
    certainty [H, W] at pixel points [P, 2], clipped to [0, size -
    1.001]."""
    H, W = cert.shape
    x = torch.clamp(pts[:, 0], 0, W - 1.001)
    y = torch.clamp(pts[:, 1], 0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    wp = warp.to(torch.float64)
    w = (wp[y0, x0] * (1 - fy) * (1 - fx) + wp[y0, x0 + 1] * (1 - fy) * fx
         + wp[y0 + 1, x0] * fy * (1 - fx) + wp[y0 + 1, x0 + 1] * fy * fx)
    cp = cert.to(torch.float64)
    fx, fy = fx[:, 0], fy[:, 0]
    c = (cp[y0, x0] * (1 - fy) * (1 - fx) + cp[y0, x0 + 1] * (1 - fy) * fx
         + cp[y0 + 1, x0] * fy * (1 - fx) + cp[y0 + 1, x0 + 1] * fy * fx)
    return w, c


class BaseDenseLineMatcher(BaseMatcher):
    def __init__(self, extractor, dense_matcher: BaseDenseMatcher,
                 dense_options: BaseDenseLineMatcherOptions =
                 BaseDenseLineMatcherOptions(),
                 options: Optional[dict] = None):
        super().__init__(extractor, options)
        assert extractor.get_module_name() == "dense_naive"
        assert dense_options.n_samples >= 2
        self.dense_options = dense_options
        self.dense_matcher = dense_matcher
        self.device = resolve_device((options or {}).get("device"))

    def get_module_name(self):
        return "dense_base"

    def _lines(self, descinfo):
        return torch.as_tensor(np.asarray(descinfo["lines"], np.float64),
                               device=self.device)

    def _distance_one_direction(self, descinfo1, descinfo2, warp, cert):
        opt = self.dense_options
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        segs1 = self._lines(descinfo1)
        n1 = len(segs1)
        t = torch.as_tensor(np.linspace(0, 1, opt.n_samples), **f64)[
            None, :, None]
        coords_1 = (t * segs1[:, None, 0] + (1 - t) * segs1[:, None, 1]) \
            .reshape(-1, 2)
        h2, w2 = (int(v) for v in descinfo2["image_shape"])
        warped_n, cert_s = _sample_warp(warp, cert, coords_1)
        coords_to_2 = self.dense_matcher.to_unnormalized_coordinates(
            warped_n, h2, w2)
        cert_s = cert_s.reshape(n1, opt.n_samples)
        segs2 = self._lines(descinfo2)
        n2 = len(segs2)
        starts2, ends2 = segs2[:, 0], segs2[:, 1]
        dirs = ends2 - starts2
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
                       + 1e-12)
        s_proj = (starts2 * dirs).sum(1)
        e_proj = (ends2 * dirs).sum(1)
        one = torch.ones(n2, 1, **f64)
        l2h = torch.linalg.cross(torch.cat([starts2, one], 1),
                                 torch.cat([ends2, one], 1))
        l2h = l2h / (torch.linalg.vector_norm(l2h[:, :2], dim=1,
                                              keepdim=True) + 1e-12)
        ch = torch.cat([coords_to_2, torch.ones(len(coords_to_2), 1, **f64)],
                       1)
        coords_proj = coords_to_2 @ dirs.T
        dists = torch.abs(ch @ l2h.T)
        has_overlap = (coords_proj > s_proj) & (coords_proj < e_proj)
        dists = dists.reshape(n1, opt.n_samples, n2).permute(0, 2, 1)
        has_overlap = has_overlap.reshape(n1, opt.n_samples, n2) \
            .permute(0, 2, 1)
        good = cert_s > self.dense_matcher.get_sample_thresh()
        w = (good[:, None, :] & has_overlap).to(torch.float64)
        wsum = w.sum(2)
        overlap = wsum / opt.n_samples
        w = w / torch.where(wsum > 0, wsum, torch.ones_like(wsum))[..., None]
        weighted = (dists * w).sum(2)
        weighted = torch.where(overlap < opt.segment_percentage_th,
                               torch.full_like(weighted, 10000.0), weighted)
        return weighted, overlap

    def _symmetric_dists(self, descinfo1, descinfo2):
        opt = self.dense_options
        w12, c12, w21, c21 = self.dense_matcher.get_warping_symmetric(
            descinfo1["image"], descinfo2["image"])
        d12, o12 = self._distance_one_direction(descinfo1, descinfo2,
                                                w12, c12)
        d21, o21 = self._distance_one_direction(descinfo2, descinfo1,
                                                w21, c21)
        dists = torch.where(o12 > o21.T, d12, d21.T)
        overlap = torch.minimum(o12, o21.T)
        big = torch.full_like(dists, 10000.0)
        dists = torch.where(overlap < opt.segment_percentage_th, big, dists)
        dists = torch.where(torch.maximum(d12, d21.T) > opt.pixel_th, big,
                            dists)
        return dists

    def match_pair(self, descinfo1, descinfo2):
        opt = self.dense_options
        if len(descinfo1["lines"]) == 0 or len(descinfo2["lines"]) == 0:
            return np.zeros((0, 2), int)
        dists = self._symmetric_dists(descinfo1, descinfo2)
        best = dists <= opt.pixel_th
        if self.topk == 0 and not opt.one_to_many:
            best = best & (dists == dists.min(dim=-1, keepdim=True).values)
        return torch.nonzero(best).cpu().numpy()


@register_matcher("dense_ncc")
class NCCDenseLineMatcher(BaseDenseLineMatcher):
    """Self-contained dense line matcher (no learned weights)."""

    def __init__(self, extractor, options: Optional[dict] = None):
        options = options or {}
        dopt = BaseDenseLineMatcherOptions(
            n_samples=options.get("n_samples", 21),
            segment_percentage_th=options.get("segment_percentage_th", 0.2),
            pixel_th=options.get("pixel_th", 10.0),
            one_to_many=options.get("one_to_many", False))
        super().__init__(extractor, CorrelationFlowMatcher(
            device=options.get("device")), dopt, options)

    def get_module_name(self):
        return "dense_ncc"


@register_matcher("dense_roma")
class RoMaLineMatcher(BaseDenseLineMatcher):
    """The RoMa dense warp backend; needs the external ``romatch``
    package and its checkpoint."""

    def __init__(self, extractor, options: Optional[dict] = None):
        try:
            import romatch  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "the RoMa backend needs the external 'romatch' package; "
                "use the self-contained 'dense_ncc' matcher instead"
            ) from exc
        raise NotImplementedError(
            "romatch integration requires its checkpoint; "
            "wire RoMaDenseMatcher here when weights are available")

    def get_module_name(self):
        return "dense_roma"
