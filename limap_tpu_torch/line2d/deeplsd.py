"""DeepLSD-style learned line detector: a VGG16-UNet predicts a
distance field and a line-angle field, and segments are grouped from
those fields by the device extractor of ``tpu_lsd``.

The network (grayscale input; VGG16 conv1-conv3 at 64/128/256 channels;
a nearest-upsample decoder with skips back to 64 channels; a distance
head with a ReLU and an angle head with sigmoid x pi) is an
``nn.Module`` whose state dict has the names and layouts of the
reference's spec, so a checkpoint (``line2d/DeepLSD/deeplsd_md.tar``
under a weights directory) loads directly.  The fields become a
(magnitude exp(-df / r), angle, df < threshold) triple for
:func:`tpu_lsd.detect_from_fields`.  Without weights the network takes
the reference's seeded random init, draw for draw.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import BaseDetector, register_detector
from limap_tpu_torch.line2d.sold2.nets import resize_nearest_torch
from limap_tpu_torch.line2d.spec_net import (SpecNet, he_normal_state_dict,
                                             max_pool2, read_checkpoint,
                                             relu, to_nchw, to_nhwc)
from limap_tpu_torch.line2d.tpu_lsd import detect_from_fields

DF_RADIUS = 5.0  # the distance field's normalization radius


def _spec():
    spec = []

    def add_conv(name, o, i, k):
        spec.append((name + ".weight", (o, i, k, k)))
        spec.append((name + ".bias", (o,)))

    add_conv("backbone.block1.0", 64, 1, 3)
    add_conv("backbone.block1.2", 64, 64, 3)
    add_conv("backbone.block2.0", 128, 64, 3)
    add_conv("backbone.block2.1", 128, 128, 3)
    add_conv("backbone.block3.0", 256, 128, 3)
    add_conv("backbone.block3.1", 256, 256, 3)
    add_conv("backbone.block3.2", 256, 256, 3)
    add_conv("backbone.deblock2.0", 128, 256 + 128, 3)
    add_conv("backbone.deblock1.0", 64, 128 + 64, 3)
    add_conv("df_head.0", 64, 64, 3)
    add_conv("df_head.2", 1, 64, 1)
    add_conv("angle_head.0", 64, 64, 3)
    add_conv("angle_head.2", 1, 64, 1)
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded random weights (torch layout)."""
    return he_normal_state_dict(_spec(), seed)


class DeepLSDNet(SpecNet):
    """VGG16-UNet with the distance-field and angle-field heads."""

    def __init__(self):
        super().__init__(_spec())

    def vgg_unet(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, H, W] -> [B, 64, H, W] features."""
        c = self.conv
        b1 = relu(c("backbone.block1.2", relu(c("backbone.block1.0", x))))
        b2 = relu(c("backbone.block2.1",
                    relu(c("backbone.block2.0", max_pool2(b1)))))
        b3 = relu(c("backbone.block3.2", relu(c(
            "backbone.block3.1", relu(c("backbone.block3.0",
                                        max_pool2(b2)))))))
        u2 = to_nchw(resize_nearest_torch(to_nhwc(b3), b2.shape[2],
                                          b2.shape[3]))
        f2 = relu(c("backbone.deblock2.0", torch.cat([u2, b2], 1)))
        u1 = to_nchw(resize_nearest_torch(to_nhwc(f2), b1.shape[2],
                                          b1.shape[3]))
        return relu(c("backbone.deblock1.0", torch.cat([u1, b1], 1)))

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image [B, H, W, 1] in [0, 1] -> {"df": [B, H, W], "angle":
        [B, H, W]} (the angle is the line direction mod pi)."""
        feat = self.vgg_unet(to_nchw(image))
        c = self.conv
        df = relu(c("df_head.2", relu(c("df_head.0", feat)), padding="valid"))
        ang = c("angle_head.2", relu(c("angle_head.0", feat)),
                padding="valid")
        return {"df": df[:, 0], "angle": torch.sigmoid(ang[:, 0]) * np.pi}


def deeplsd_forward(net: DeepLSDNet, image: torch.Tensor):
    with torch.no_grad():
        return net(image)


def load_torch_state_dict(sd, key_map: Optional[Dict[str, str]] = None
                          ) -> DeepLSDNet:
    """A :class:`DeepLSDNet` holding ``sd`` (strict: every spec key with
    its shape, or a ValueError listing the differences)."""
    return DeepLSDNet().load_spec_state_dict(sd, "DeepLSD", key_map)


def extract_from_fields(df: torch.Tensor, angle: torch.Tensor,
                        n_bins: int = 8, max_segs: int = 2048,
                        cc_rounds: int = 24, min_size: int = 8,
                        df_thresh: float = 1.5, max_width: float = 3.0,
                        min_density: float = 0.3):
    """Distance and angle fields [H, W] -> (segs [max_segs, 5], count)
    through the shared orientation-bucket extractor."""
    mag = torch.exp(-df / DF_RADIUS)
    on = df < df_thresh
    return detect_from_fields(mag, angle, on, n_bins, max_segs, cc_rounds,
                              min_size, max_width, min_density)


@register_detector("deeplsd")
class DeepLSDDetector(BaseDetector):
    """detect() -> [N, 5] x1 y1 x2 y2 score (= length)."""

    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        sd = read_checkpoint(self.weight_path, "line2d", "DeepLSD",
                             "deeplsd_md.tar")
        self.net = load_torch_state_dict(
            sd if sd is not None else init_params(options.get("seed", 0)))
        self.net = self.net.to(self.device).eval()
        self.df_thresh = options.get("df_thresh", 1.5)

    def get_module_name(self):
        return "deeplsd"

    def fields(self, img: np.ndarray):
        """(df, angle) [H, W] on the device of a grayscale image."""
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape
        Hp, Wp = -(-H // 4) * 4, -(-W // 4) * 4
        buf = np.zeros((1, Hp, Wp, 1), np.float32)
        buf[0, :H, :W, 0] = img
        out = deeplsd_forward(self.net, torch.as_tensor(buf,
                                                        device=self.device))
        return out["df"][0, :H, :W], out["angle"][0, :H, :W]

    def detect(self, camview) -> np.ndarray:
        return self.detect_array(camview.read_image(set_gray=True))

    def detect_array(self, img: np.ndarray) -> np.ndarray:
        df, ang = self.fields(img)
        return segments_from_fields(df, ang, self.df_thresh)


def segments_from_fields(df, ang, df_thresh: float = 1.5) -> np.ndarray:
    """[N, 5] segments scored by their length, as the detector returns."""
    segs, count = extract_from_fields(df, ang, df_thresh=df_thresh)
    segs = segs.cpu().numpy()[:int(count)]
    lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1)
    return np.concatenate([segs[:, :4], lengths[:, None]], axis=1)
