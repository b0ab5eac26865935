"""LBD, the Line Band Descriptor, on every line of an image at once.

The descriptor of each line at each level of a Gaussian pyramid is
kernel V (``ops/lbd_describe.py``); the pyramid's blur and nearest
resize are ``util/cv2_ops``'s, as the reference takes them from OpenCV.
Matching is the mutual nearest neighbour (or the top k) over the best
distance among all pairs of pyramid levels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.ops.lbd_describe import (DIM, M_BANDS,  # noqa: F401
                                              lbd_describe)
from limap_tpu_torch.util import cv2_ops

MATCH_CHUNK = 64  # rows of the [N1, N2, S, S] distance a chunk


@register_extractor("lbd")
class LBDExtractor(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        self.n_levels = options.get("n_levels", 3)
        self.level_scale = options.get("level_scale", float(np.sqrt(2)))

    def get_module_name(self):
        return "lbd"

    def extract(self, camview, segs) -> dict:
        return self.extract_array(camview.read_image(set_gray=True), segs)

    def extract_array(self, img: np.ndarray, segs) -> dict:
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        segs = np.asarray(segs, np.float32)
        N = len(segs)
        if N == 0:
            return {"line_descriptors": np.zeros(
                (0, self.n_levels, DIM), np.float32)}
        dev = self.device
        octave = torch.as_tensor(img, device=dev)
        lines = torch.as_tensor(np.ascontiguousarray(segs[:, :4]),
                                device=dev)
        valid = torch.ones(N, dtype=torch.bool, device=dev)
        scale = 1.0
        pre_sigma2, cur_sigma2 = 0.0, 1.0
        descs = []
        for _ in range(self.n_levels):
            inc = float(np.sqrt(cur_sigma2 - pre_sigma2))
            blurred = cv2_ops.gaussian_blur(octave, inc, border="replicate")
            # the segments scaled in float32, as the reference's buffer
            descs.append(lbd_describe(blurred, lines * np.float32(scale),
                                      valid))
            new_size = (int(blurred.shape[1] / self.level_scale),
                        int(blurred.shape[0] / self.level_scale))
            octave = cv2_ops.resize(blurred, new_size, cv2_ops.INTER_NEAREST)
            scale /= self.level_scale
            pre_sigma2, cur_sigma2 = cur_sigma2, cur_sigma2 * 2
        return {"line_descriptors": torch.stack(descs, 1).cpu().numpy()}


def min_scale_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1, N2]: the least L2 distance between a descriptor of line i
    and one of line j over every pair of levels ([N, S, D] each), by the
    difference form, in chunks of MATCH_CHUNK rows."""
    out = []
    for a in range(0, d1.shape[0], MATCH_CHUNK):
        diff = d1[a:a + MATCH_CHUNK, None, :, None, :] \
            - d2[None, :, None, :, :]
        dist = torch.sqrt((diff * diff).sum(-1))
        out.append(dist.flatten(2).amin(2))
    return torch.cat(out)


@register_matcher("lbd")
class LBDMatcher(BaseMatcher):
    """Mutual NN over the best cross-scale descriptor distance."""

    def __init__(self, extractor, options: Optional[dict] = None):
        super().__init__(extractor, options)
        assert extractor.get_module_name() == "lbd"
        self.device = resolve_device((options or {}).get("device"))

    def get_module_name(self):
        return "lbd"

    def match_pair(self, descinfo1, descinfo2):
        d1 = torch.as_tensor(np.asarray(descinfo1["line_descriptors"],
                                        np.float32), device=self.device)
        d2 = torch.as_tensor(np.asarray(descinfo2["line_descriptors"],
                                        np.float32), device=self.device)
        if len(d1) == 0 or len(d2) == 0:
            return np.zeros((0, 2), int)
        dist = min_scale_distance(d1, d2)
        return nn_matches(dist, self.topk, smaller_is_better=True)


def nn_matches(score: torch.Tensor, topk: int,
               smaller_is_better: bool) -> np.ndarray:
    """Mutual nearest neighbours (topk 0) or each row's topk best as
    [M, 2] pairs (rows of the k-th choice after those of the (k-1)-th),
    the first index on ties."""
    key = score if smaller_is_better else -score
    n1 = key.shape[0]
    if topk == 0:
        b1 = torch.argmin(key, dim=1)
        b2 = torch.argmin(key, dim=0)
        ids1 = torch.nonzero(b2[b1] == torch.arange(n1, device=key.device),
                             as_tuple=True)[0]
        return torch.stack([ids1, b1[ids1]], 1).cpu().numpy()
    k = min(topk, key.shape[1])
    order = torch.sort(key, dim=1, stable=True).indices[:, :k].cpu().numpy()
    rows = np.arange(n1)
    return np.concatenate([np.stack([rows, order[:, i]], axis=1)
                           for i in range(k)], axis=0)
