"""Dense feature extractors.

``GradientFeatureExtractor`` needs no weights: intensity, gradient
magnitude and four oriented gradients, the features of the cross-view
consistency term of line refinement.  ``S2DNetExtractor`` is the
learned hypercolumn extractor: a VGG-16 prefix (conv0_* to conv2_*) and
three 1x1 adaptations to 128 channels, the coarser two upsampled
bilinearly (half-pixel centres, as ``jax.image.resize``) and summed,
then L2-normalized.  Its parameters are named as the reference's Flax
module (``convert.s2dnet_state_dict`` carries them across); without
weights it takes a seeded He-normal init of its own.
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


S2DNET_BLOCKS = [(64, 2), (128, 2), (256, 3)]


class S2DNetBackbone(torch.nn.Module):
    """VGG-16 prefix + adaptation layers (the S2DNet layout)."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for bi, (c, reps) in enumerate(S2DNET_BLOCKS):
            for ri in range(reps):
                self.add_module(f"conv{bi}_{ri}",
                                torch.nn.Conv2d(c_in, c, 3, padding=1))
                c_in = c
            self.add_module(f"adap{bi}", torch.nn.Conv2d(c, 128, 1))

    def forward(self, x: torch.Tensor):
        """[B, 1, H, W] -> the three adapted maps [B, 128, H / 2^i, W /
        2^i]."""
        out = []
        for bi, (_, reps) in enumerate(S2DNET_BLOCKS):
            for ri in range(reps):
                x = torch.relu(getattr(self, f"conv{bi}_{ri}")(x))
            out.append(getattr(self, f"adap{bi}")(x))
            if bi < len(S2DNET_BLOCKS) - 1:
                x = torch.nn.functional.max_pool2d(x, 2, 2)
        return out


def s2dnet_random_state_dict(seed: int = 0) -> dict:
    """He-normal kernels and zero biases from a numpy generator."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in S2DNetBackbone().state_dict().items():
        if k.endswith("bias"):
            sd[k] = torch.zeros(v.shape)
        else:
            fan_in = int(np.prod(v.shape[1:]))
            sd[k] = torch.as_tensor(rng.normal(
                0, (2.0 / fan_in) ** 0.5, tuple(v.shape)).astype(np.float32))
    return sd


class S2DNetExtractor:
    """Dense [H4, W4, 128] unit hypercolumns of the image cropped to a
    multiple of 4."""

    channels = 128

    def __init__(self, weight_path=None, device=None, state_dict=None):
        self.device = resolve_device(device)
        self.net = S2DNetBackbone()
        if state_dict is None and weight_path:
            state_dict = torch.load(weight_path, map_location="cpu",
                                    weights_only=False)
        self.net.load_state_dict(state_dict if state_dict is not None
                                 else s2dnet_random_state_dict())
        self.net = self.net.to(self.device).eval()
        self.weight_path = weight_path

    def extract(self, image: np.ndarray) -> torch.Tensor:
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape
        H4, W4 = (H // 4) * 4, (W // 4) * 4
        x = torch.as_tensor(np.ascontiguousarray(img[:H4, :W4]),
                            device=self.device)[None, None]
        with torch.no_grad():
            feats = self.net(x)
            out = feats[0]
            for f in feats[1:]:
                out = out + torch.nn.functional.interpolate(
                    f, size=(H4, W4), mode="bilinear", align_corners=False)
        out = out[0].permute(1, 2, 0)
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-8)


def get_extractor(method: str = "gradient", weight_path=None, device=None):
    if method == "gradient":
        return GradientFeatureExtractor(device=device)
    if method == "s2dnet":
        return S2DNetExtractor(weight_path, device=device)
    raise NotImplementedError(method)
