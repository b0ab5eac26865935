"""SOLD2 detector, extractor and matcher.

The network (``nets.py``) runs on the device on the image padded to the
8-px grid; junctions and the heatmap come back to the host for the
reference's NMS and contrast normalization; the line detector runs on
kernels T and U and the line descriptors are sampled on kernel S (zero
padding).  The published ``sold2_wireframe.tar`` loads through
``weight_path`` (a file, or a directory holding
``line2d/SOLD2/pretrained_models/sold2_wireframe.tar``); nothing is
downloaded.  Without weights the engine takes :func:`nets.init_params`
of its seed, the same weights the reference draws for that seed.

Where this module departs from the reference on purpose: the line
descriptors are sampled at the descriptor grid's own stride (4), where
the reference's engine passes the junction grid size (8) and so samples
every line at half its coordinates; the Wunsch matcher takes its top-k
candidates by a stable sort.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_detector,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.line2d.sold2 import nets
from limap_tpu_torch.line2d.sold2.detection import (LineSegmentDetector,
                                                    heatmap_from_logits,
                                                    junctions_from_predictions)
from limap_tpu_torch.ops.sample_descriptors import sample_descriptors

_DEFAULT_DETECTOR_CFG = {  # config/export_line_features.yaml
    "grid_size": 8,
    "junc_detect_thresh": 1 / 65,
    "max_num_junctions": 300,
    "detect_thresh": 0.5,
    "num_samples": 64,
    "inlier_thresh": 0.99,
    "use_candidate_suppression": True,
    "nms_dist_tolerance": 3.0,
    "use_heatmap_refinement": True,
    "use_junction_refinement": True,
}
DESC_GRID = 4     # the descriptor map's stride in pixels


def _bresenham(p0, p1):
    """Integer raster of a segment (the reference's skimage.draw.line)."""
    y0, x0 = int(p0[0]), int(p0[1])
    y1, x1 = int(p1[0]), int(p1[1])
    n = max(abs(y1 - y0), abs(x1 - x0)) + 1
    ys = np.round(np.linspace(y0, y1, n)).astype(int)
    xs = np.round(np.linspace(x0, x1, n)).astype(int)
    return ys, xs


class SOLD2Engine:
    """The network and post-processing state shared by the detector and
    the extractor, on ``device`` (None means cuda)."""

    def __init__(self, weight_path: Optional[str] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.grid_size = _DEFAULT_DETECTOR_CFG["grid_size"]
        self.junc_detect_thresh = _DEFAULT_DETECTOR_CFG["junc_detect_thresh"]
        self.max_num_junctions = _DEFAULT_DETECTOR_CFG["max_num_junctions"]
        params = None
        if weight_path is not None:
            ckpt = weight_path
            if os.path.isdir(weight_path):
                ckpt = os.path.join(weight_path, "line2d", "SOLD2",
                                    "pretrained_models",
                                    "sold2_wireframe.tar")
            params = self._load_checkpoint(ckpt)
        if params is None:
            params = nets.init_params(seed)
        self.net = nets.build_net(params, self.device)
        cfg = _DEFAULT_DETECTOR_CFG
        self.line_detector = LineSegmentDetector(
            detect_thresh=cfg["detect_thresh"],
            num_samples=cfg["num_samples"],
            inlier_thresh=cfg["inlier_thresh"],
            use_candidate_suppression=cfg["use_candidate_suppression"],
            nms_dist_tolerance=cfg["nms_dist_tolerance"],
            use_heatmap_refinement=cfg["use_heatmap_refinement"],
            use_junction_refinement=cfg["use_junction_refinement"],
            device=self.device)
        self.matcher = WunschLineMatcher(device=self.device)

    @staticmethod
    def _load_checkpoint(path):
        if not os.path.isfile(path):
            return None
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return nets.load_torch_state_dict(ckpt.get("model_state_dict",
                                                   ckpt))

    def _forward(self, img_gray):
        """The network's NHWC maps on the device, the input padded to the
        8-px grid; and the image's (H, W)."""
        img = np.asarray(img_gray, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape
        Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
        buf = torch.zeros((1, Hp, Wp, 1), dtype=torch.float32,
                          device=self.device)
        buf[0, :H, :W, 0] = torch.as_tensor(img, device=self.device)
        return nets.sold2_forward(self.net, buf), (H, W)

    def forward(self, img_gray):
        """img [H, W] uint8/float -> (dict of numpy NHWC maps, the
        heatmap cropped back to the image; (H, W))."""
        out, (H, W) = self._forward(img_gray)
        return {"junctions": out["junctions"].cpu().numpy(),
                "heatmap": out["heatmap"][:, :H, :W].cpu().numpy(),
                "descriptors": out["descriptors"].cpu().numpy()}, (H, W)

    def detect(self, img_gray):
        """-> (segs [N, 5] x1 y1 x2 y2 saliency, descriptor grid [1, H/4,
        W/4, 128], heatmap [H, W], descinfo [desc, valid])."""
        if img_gray.shape[0] < 80 or img_gray.shape[1] < 80:
            return (np.zeros((0, 5)), None, None, [])
        out, (H, W) = self._forward(img_gray)
        junctions = junctions_from_predictions(
            out["junctions"].cpu().numpy(), self.grid_size,
            self.junc_detect_thresh, self.max_num_junctions)
        heatmap = heatmap_from_logits(
            out["heatmap"][:, :H, :W].cpu().numpy())
        segs_hw = self.line_detector.detect(junctions, heatmap)  # [S,2,2]
        descinfo = self.matcher.compute_descriptors(
            segs_hw, out["descriptors"], DESC_GRID)
        segs = np.flip(segs_hw, axis=2).reshape(len(segs_hw), 4)
        saliency = np.empty(len(segs_hw))
        for i, s in enumerate(np.round(segs_hw).astype(int)):
            ys, xs = _bresenham(
                np.clip(s[0], 0, [H - 1, W - 1]),
                np.clip(s[1], 0, [H - 1, W - 1]))
            saliency[i] = heatmap[ys, xs].sum()
        return (np.hstack([segs, saliency[:, None]]),
                out["descriptors"].cpu().numpy(), heatmap, descinfo)

    def compute_descinfo(self, segs_xy: np.ndarray, desc_grid):
        segs_hw = np.flip(np.asarray(segs_xy[:, :4], np.float64)
                          .reshape(-1, 2, 2), axis=2)
        return self.matcher.compute_descriptors(segs_hw, desc_grid,
                                                DESC_GRID)


class WunschLineMatcher:
    """Needleman-Wunsch line matching over descriptors sampled along the
    segments, on ``device`` (None means cuda)."""

    def __init__(self, cross_check=True, num_samples=5, min_dist_pts=8,
                 top_k_candidates=10, gap=0.1, device=None):
        self.device = resolve_device(device)
        self.cross_check = cross_check
        self.num_samples = num_samples
        self.min_dist_pts = min_dist_pts
        self.top_k_candidates = top_k_candidates
        self.gap = gap

    # ---------------------------------------------------------- sampling
    def sample_line_points(self, segs_hw):
        """Regular samples with a minimum spacing; short lines padded
        (host)."""
        n = len(segs_hw)
        S = self.num_samples
        lengths = np.linalg.norm(segs_hw[:, 0] - segs_hw[:, 1], axis=1)
        counts = np.clip(lengths // self.min_dist_pts, 2, S).astype(int)
        pts = np.zeros((n, S, 2))
        valid = np.zeros((n, S), bool)
        for c in range(2, S + 1):
            m = counts == c
            if not m.any():
                continue
            tc = np.linspace(0, 1, c)[None, :, None]
            p = segs_hw[m, None, 0] * (1 - tc) + segs_hw[m, None, 1] * tc
            pts[np.nonzero(m)[0][:, None], np.arange(c)[None, :]] = p
            valid[m, :c] = True
        return pts, valid

    def compute_descriptors(self, segs_hw, desc_grid_nhwc,
                            grid_size=DESC_GRID):
        """-> [desc [D, n*S] f32 L2-normalized, valid [n, S]]; the grid
        [1, Hd, Wd, D] (a tensor stays on its device) is sampled on kernel
        S with grid_sample's zero padding."""
        if len(segs_hw) == 0:
            return []
        pts, valid = self.sample_line_points(np.asarray(segs_hw,
                                                        np.float64))
        grid = desc_grid_nhwc if isinstance(desc_grid_nhwc, torch.Tensor) \
            else torch.as_tensor(np.asarray(desc_grid_nhwc, np.float32),
                                 device=self.device)
        d = sample_descriptors(
            grid[0].contiguous(), torch.as_tensor(
                pts.reshape(-1, 2), device=grid.device), "zero", grid_size)
        return [d.T.cpu().numpy(), valid]

    # ---------------------------------------------------------- matching
    def _score_matrix(self, descinfo1, descinfo2) -> torch.Tensor:
        desc1, valid1 = descinfo1
        desc2, valid2 = descinfo2
        n1, n2 = valid1.shape[0], valid2.shape[0]
        S = self.num_samples
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        scores = t(np.asarray(desc1, np.float32)).T @ t(
            np.asarray(desc2, np.float32))
        v1, v2 = t(np.asarray(valid1).reshape(-1)), t(
            np.asarray(valid2).reshape(-1))
        scores[~v1] = -1
        scores[:, ~v2] = -1
        return scores.reshape(n1, S, n2, S).permute(0, 2, 1, 3)

    @staticmethod
    def _line_scores(scores: torch.Tensor) -> torch.Tensor:
        """The mean over valid samples of each sample's best match, both
        ways, averaged (the division in float64, as numpy promotes)."""
        s1 = scores.amax(3)
        v1 = s1 != -1
        s1 = (s1 * v1).sum(2).double() / torch.clamp(v1.sum(2), min=1)
        s2 = scores.amax(2)
        v2 = s2 != -1
        s2 = (s2 * v2).sum(2).double() / torch.clamp(v2.sum(2), min=1)
        return (s1 + s2) / 2

    def needleman_wunsch(self, scores: torch.Tensor) -> torch.Tensor:
        """Batched NW dynamic program with zero-cost gaps, a torch op a
        cell over the batch ([b, n, m] -> [b]); the grid in float64 as
        the reference's."""
        b, n, m = scores.shape
        nw = (scores - self.gap).double()
        rows = [torch.zeros(b, m + 1, dtype=torch.float64,
                            device=scores.device)]
        for i in range(n):
            prev, cur = rows[-1], [rows[-1].new_zeros(b)]
            for j in range(m):
                cur.append(torch.maximum(torch.maximum(cur[j], prev[:, j + 1]),
                                         prev[:, j] + nw[:, i, j]))
            rows.append(torch.stack(cur, 1))
        return rows[-1][:, -1]

    def _match_one_way(self, scores: torch.Tensor) -> torch.Tensor:
        n1 = scores.shape[0]
        k = min(self.top_k_candidates, scores.shape[1])
        line_scores = self._line_scores(scores)
        topk = torch.argsort(line_scores, dim=1, stable=True)[:, -k:]
        top_scores = scores[torch.arange(n1, device=scores.device)[:, None],
                            topk]                       # [n1, k, S, S]
        top_scores = torch.cat([top_scores, top_scores.flip(-1)], dim=1)
        _, top2k, n, m = top_scores.shape
        nw = self.needleman_wunsch(top_scores.reshape(-1, n, m))
        best = torch.argmax(nw.reshape(n1, top2k), dim=1) % (top2k // 2)
        return topk[torch.arange(n1, device=scores.device), best]

    def compute_matches(self, descinfo1, descinfo2) -> np.ndarray:
        scores = self._score_matrix(descinfo1, descinfo2)
        matches = self._match_one_way(scores)
        if self.cross_check:
            matches2 = self._match_one_way(scores.permute(1, 0, 3, 2))
            mutual = matches2[matches] == torch.arange(
                len(matches), device=matches.device)
            matches = torch.where(mutual, matches,
                                  torch.full_like(matches, -1))
        return matches.cpu().numpy()

    def compute_matches_topk(self, descinfo1, descinfo2,
                             topk=10) -> np.ndarray:
        scores = self._score_matrix(descinfo1, descinfo2)
        line_scores = self._line_scores(scores)
        k = min(topk, scores.shape[1])
        return torch.argsort(line_scores, dim=1,
                             stable=True)[:, -k:].cpu().numpy()


def _descinfo_dict(descinfo):
    if len(descinfo) == 0:
        return {"desc": np.zeros((128, 0), np.float32),
                "valid": np.zeros((0, 5), bool)}
    return {"desc": descinfo[0], "valid": descinfo[1]}


# ---------------------------------------------------------------- plugins
@register_detector("sold2")
@register_extractor("sold2")
class SOLD2Detector(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.engine = SOLD2Engine(weight_path=self.weight_path,
                                  seed=options.get("seed", 0),
                                  device=options.get("device"))

    def get_module_name(self):
        return "sold2"

    def detect(self, camview):
        img = camview.read_image(set_gray=self.set_gray)
        segs, _, _, _ = self.engine.detect(img)
        return segs

    def extract(self, camview, segs):
        img = camview.read_image(set_gray=self.set_gray)
        out, _ = self.engine._forward(img)
        return _descinfo_dict(self.engine.compute_descinfo(
            np.asarray(segs), out["descriptors"]))

    def detect_and_extract(self, camview):
        img = camview.read_image(set_gray=self.set_gray)
        segs, _, _, descinfo = self.engine.detect(img)
        return segs, _descinfo_dict(descinfo)


SOLD2Extractor = SOLD2Detector


@register_matcher("sold2")
class SOLD2Matcher(BaseMatcher):
    def __init__(self, extractor, options: Optional[dict] = None):
        super().__init__(extractor, options)
        if extractor.get_module_name() != "sold2":
            raise ValueError("the sold2 matcher needs sold2 descriptors")
        self.matcher = WunschLineMatcher(
            device=(options or {}).get("device"))

    def get_module_name(self):
        return "sold2"

    def match_pair(self, descinfo1, descinfo2):
        d1 = [descinfo1["desc"], descinfo1["valid"]]
        d2 = [descinfo2["desc"], descinfo2["valid"]]
        if d1[1].shape[0] == 0 or d2[1].shape[0] == 0:
            return np.zeros((0, 2), int)
        if self.topk == 0:
            matches = self.matcher.compute_matches(d1, d2)
            ids1 = np.nonzero(matches != -1)[0]
            return np.stack([ids1, matches[ids1]], axis=1)
        topk_lines = self.matcher.compute_matches_topk(d1, d2, self.topk)
        n1, k = topk_lines.shape
        out = [np.stack([np.arange(n1), topk_lines[:, i]], axis=1)
               for i in range(k)]
        return np.concatenate(out, axis=0)
