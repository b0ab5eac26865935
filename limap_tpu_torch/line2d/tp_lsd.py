"""TP-LSD-style detector: the tri-points line representation.

A shared encoder at 1/4 resolution feeds a centre head (a sigmoid after
a bilinear upsample) and a displacement head (two vectors from the
line's centre to its endpoints).  Detection is the centre NMS and the
displacement readout of kernel X (``ops/tplsd_decode.py``).  The
checkpoint loader is keyed to this module's own spec (``key_map``
adapts another layout), as the reference's; :func:`preprocess_tplsd` is
the published input normalization (an HSV value channel flattened by a
blurred quarter-resolution copy), here on ``util/cv2_ops``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import BaseDetector, register_detector
from limap_tpu_torch.line2d.spec_net import (SpecNet, he_normal_state_dict,
                                             max_pool2, read_checkpoint,
                                             relu, to_nchw)
from limap_tpu_torch.ops import tplsd_decode as X
from limap_tpu_torch.util import cv2_ops


def _spec():
    spec = []

    def add(name, o, i, k):
        spec.append((name + ".weight", (o, i, k, k)))
        spec.append((name + ".bias", (o,)))

    add("backbone.conv1a", 64, 1, 3)
    add("backbone.conv1b", 64, 64, 3)
    add("backbone.conv2a", 128, 64, 3)
    add("backbone.conv2b", 128, 128, 3)
    add("backbone.conv3a", 256, 128, 3)
    add("backbone.conv3b", 256, 256, 3)
    add("center_head.conv0", 128, 256, 3)
    add("center_head.conv1", 1, 128, 1)
    add("disp_head.conv0", 128, 256, 3)
    add("disp_head.conv1", 4, 128, 1)
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    return he_normal_state_dict(_spec(), seed)


class TPLSDNet(SpecNet):
    def __init__(self):
        super().__init__(_spec())

    def forward(self, image: torch.Tensor):
        """image [B, H, W, 1] -> centre probability [B, H, W],
        displacements [B, H, W, 4] (dx1, dy1, dx2, dy2 at full
        resolution)."""
        c = self.conv
        x = relu(c("backbone.conv1a", to_nchw(image)))
        x = max_pool2(relu(c("backbone.conv1b", x)))
        x = relu(c("backbone.conv2a", x))
        x = max_pool2(relu(c("backbone.conv2b", x)))
        x = relu(c("backbone.conv3a", x))
        feat = relu(c("backbone.conv3b", x))
        cen = c("center_head.conv1", relu(c("center_head.conv0", feat)),
                padding="valid")
        d = c("disp_head.conv1", relu(c("disp_head.conv0", feat)),
              padding="valid")
        size = (cen.shape[2] * 4, cen.shape[3] * 4)
        center = torch.sigmoid(F.interpolate(
            cen, size=size, mode="bilinear", align_corners=False))[:, 0]
        disp = F.interpolate(d, size=size, mode="bilinear",
                             align_corners=False) * 4.0
        return center, disp.permute(0, 2, 3, 1).contiguous()


def tplsd_forward(net: TPLSDNet, image: torch.Tensor):
    with torch.no_grad():
        return net(image)


def load_torch_state_dict(sd, key_map: Optional[Dict[str, str]] = None
                          ) -> TPLSDNet:
    return TPLSDNet().load_spec_state_dict(sd, "TP-LSD", key_map)


def tplsd_decode(center: torch.Tensor, disp: torch.Tensor, max_segs: int,
                 score_thresh: float = 0.25, nms_radius: int = 4):
    """Centre NMS + displacement readout -> (segs [max_segs, 5], count)
    on kernel X."""
    return X.tplsd_decode(center.contiguous(), disp.contiguous(), max_segs,
                          score_thresh, nms_radius)


def preprocess_tplsd(img: np.ndarray, device="cpu") -> np.ndarray:
    """The published TP-LSD input normalization: flatten the HSV value
    channel by subtracting a blurred quarter-resolution copy, re-centre
    at 127.5.  img [H, W, 3] RGB uint8 -> [H, W, 3] float32 in [0, 1] in
    BGR order."""
    t = torch.as_tensor(np.ascontiguousarray(img), device=device)
    hsv = cv2_ops.rgb_to_hsv(t)
    v0 = hsv[..., 2]
    H, W = v0.shape
    v = cv2_ops.resize(v0, None, cv2_ops.INTER_LINEAR, fx=0.25, fy=0.25)
    v = cv2_ops.gaussian_blur(v, 3, border="reflect101")
    v = cv2_ops.resize(v, (W, H), cv2_ops.INTER_LINEAR)
    v = cv2_ops.gaussian_blur(v, 3, border="reflect101")
    v1 = v0.to(torch.float32) - v.to(torch.float32) + 127.5
    hsv = hsv.clone()
    hsv[..., 2] = torch.clamp(v1, 0, 255).to(torch.uint8)
    bgr = cv2_ops.hsv_to_bgr(hsv)
    return (bgr.to(torch.float32) / 255.0).cpu().numpy()


@register_detector("tp_lsd")
class TPLSDDetector(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        sd = read_checkpoint(self.weight_path, "line2d", "TP_LSD",
                             "tp_lsd.pth")
        if sd is None:
            self.net = load_torch_state_dict(
                init_params(options.get("seed", 0)))
        else:
            self.net = load_torch_state_dict(sd, options.get("key_map"))
        self.net = self.net.to(self.device).eval()
        self.max_segs = options.get("max_segs", 512)
        self.score_thresh = options.get("score_thresh", 0.25)

    def get_module_name(self):
        return "tp_lsd"

    def detect(self, camview) -> np.ndarray:
        return self.detect_array(camview.read_image(set_gray=False))

    def maps(self, img: np.ndarray):
        """(centre [H, W], displacements [H, W, 4]) on the device."""
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
            img = preprocess_tplsd(img, self.device).mean(-1)
        else:
            img = np.asarray(img, np.float32)
            if img.ndim == 3:
                img = img.mean(-1)
            if img.max() > 1.5:
                img = img / 255.0
        H, W = img.shape
        Hp, Wp = -(-H // 4) * 4, -(-W // 4) * 4
        buf = np.zeros((1, Hp, Wp, 1), np.float32)
        buf[0, :H, :W, 0] = img
        center, disp = tplsd_forward(self.net, torch.as_tensor(
            buf, device=self.device))
        return center[0, :H, :W], disp[0, :H, :W]

    def detect_array(self, img: np.ndarray) -> np.ndarray:
        center, disp = self.maps(img)
        segs, count = tplsd_decode(center, disp, self.max_segs,
                                   self.score_thresh)
        return segs.cpu().numpy()[:int(count)]
