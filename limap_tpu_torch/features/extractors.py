"""Dense feature extractors.

``GradientFeatureExtractor`` needs no weights: intensity, gradient
magnitude and four oriented gradients, the features of the cross-view
consistency term of line refinement.  The learned S2DNet extractor
belongs to the learned front-end zoo (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch import resolve_device


class GradientFeatureExtractor:
    """Dense [H, W, 6] features: intensity + |grad| + 4 oriented grads."""

    channels = 6

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def extract(self, image: np.ndarray) -> torch.Tensor:
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.5:
            img = img / 255.0
        x = torch.as_tensor(img, device=self.device)
        p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                    mode="replicate")[0, 0]
        gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
        gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
        mag = torch.sqrt(gx * gx + gy * gy)
        d45 = (gx + gy) * 0.7071
        d135 = (gx - gy) * 0.7071
        return torch.stack([x, mag, gx, gy, d45, d135], dim=-1)


def get_extractor(method: str = "gradient", weight_path=None, device=None):
    if method == "gradient":
        return GradientFeatureExtractor(device=device)
    if method == "s2dnet":
        raise NotImplementedError(
            "the S2DNet extractor is a learned network; it comes with the "
            "learned front-end zoo (ROADMAP queue 1 item 14)")
    raise NotImplementedError(method)
