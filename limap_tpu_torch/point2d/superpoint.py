"""SuperPoint keypoints and descriptors, and the classical Harris-patch
extractor (no checkpoint needed).

``SuperPointNet`` is the magicleap architecture (a VGG-style encoder of
64-64-128-128 channels, a 65-channel detector head and a 256-channel
descriptor head L2-normalized over channels) as an ``nn.Module`` whose
``state_dict`` has the published ``superpoint_v1.pth`` names and
layouts, so that checkpoint loads as it stands.  Keypoint descriptors are
sampled on kernel S (``ops/sample_descriptors.py``, clamp mode).

Without a checkpoint the network takes seeded random weights from
:func:`random_state_dict` (numpy's generator: He-normal kernels, zero
biases).  The reference initializes from Flax's ``PRNGKey(0)``, whose
bits this package cannot reproduce; the parity tests carry the
reference's parameters across with ``convert.superpoint_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from limap_tpu_torch import resolve_device
from limap_tpu_torch.ops.sample_descriptors import (
    sample_descriptors as _sample_descriptors)

# (name, in channels, out channels, kernel) of the published layers
LAYERS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
          ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
          ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
          ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
          ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
          ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


class SuperPointNet(nn.Module):
    """The conv layout of the magicleap SuperPoint.  ``forward`` takes
    [B, 1, H, W] in [0, 1] (H, W multiples of 8) and returns the detector
    logits [B, 65, H/8, W/8] and the descriptors [B, 256, H/8, W/8]."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k in LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, x):
        for i, block in enumerate(("conv1", "conv2", "conv3", "conv4")):
            x = F.relu(getattr(self, block + "a")(x))
            x = F.relu(getattr(self, block + "b")(x))
            if i < 3:
                x = F.max_pool2d(x, 2, 2)
        semi = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                       + 1e-8)
        return semi, desc


def random_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the published layout."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, cin, cout, k in LAYERS:
        w = rng.normal(0, (2.0 / (cin * k * k)) ** 0.5, (cout, cin, k, k))
        sd[f"{name}.weight"] = torch.as_tensor(w.astype(np.float32))
        sd[f"{name}.bias"] = torch.zeros(cout)
    return sd


def load_torch_weights(net: SuperPointNet, pth_path: str) -> SuperPointNet:
    """Load a ``superpoint_v1.pth`` state dict (the published layout)
    into ``net``; every key must be there."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    net.load_state_dict(sd)
    return net


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep the pixels of [B, H, W] that equal the max of their
    (2r+1)^2 window (padded with -inf); the rest become 0."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(scores[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def sample_descriptors(desc_map: torch.Tensor, keypoints: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Bilinear descriptors of ``desc_map`` [Hc, Wc, D] at pixel
    keypoints [N, 2] (x, y), L2-normalized (kernel S, clamp mode)."""
    return _sample_descriptors(desc_map.contiguous(),
                               keypoints.to(torch.float32), "clamp", stride)


def _gray01(image) -> np.ndarray:
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img.mean(-1)
    if img.max() > 1.5:
        img = img / 255.0
    return img


class SuperPoint:
    """Detect and describe with SuperPoint on ``device`` (None means
    cuda): ``weight_path`` names a ``superpoint_v1.pth``; without one the
    weights are :func:`random_state_dict`'s."""

    def __init__(self, weight_path: Optional[str] = None,
                 nms_radius: int = 4, keypoint_threshold: float = 0.005,
                 max_keypoints: int = 2048, device=None):
        self.device = resolve_device(device)
        self.net = SuperPointNet()
        if weight_path:
            load_torch_weights(self.net, weight_path)
        else:
            self.net.load_state_dict(random_state_dict())
        self.net = self.net.to(self.device).eval()
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.max_keypoints = max_keypoints

    def _forward(self, image):
        """(full-resolution score map [H8, W8], descriptor grid [Hc, Wc,
        256]) on the device, the image cropped to a multiple of 8."""
        img = _gray01(image)
        H, W = img.shape
        H8, W8 = (H // 8) * 8, (W // 8) * 8
        x = torch.as_tensor(np.ascontiguousarray(img[:H8, :W8]),
                            device=self.device)[None, None]
        with torch.no_grad():
            semi, desc = self.net(x)
        # cell softmax, dustbin dropped, cells unfolded to pixels
        prob = torch.softmax(semi[0], dim=0)[:64].permute(1, 2, 0)
        Hc, Wc = prob.shape[:2]
        heat = prob.reshape(Hc, Wc, 8, 8).permute(0, 2, 1, 3).reshape(
            Hc * 8, Wc * 8)
        return heat, desc[0].permute(1, 2, 0).contiguous()

    def __call__(self, image) -> Dict[str, np.ndarray]:
        heat, desc = self._forward(image)
        heat_np = simple_nms(heat[None], self.nms_radius)[0].cpu().numpy()
        ys, xs = np.nonzero(heat_np > self.keypoint_threshold)
        scores = heat_np[ys, xs]
        order = np.argsort(-scores, kind="stable")[:self.max_keypoints]
        kps = np.stack([xs[order], ys[order]], axis=1).astype(np.float32)
        d = sample_descriptors(desc, torch.as_tensor(kps, device=self.device))
        return {"keypoints": kps, "scores": scores[order],
                "descriptors": d.cpu().numpy()}

    def dense(self, image) -> Dict[str, np.ndarray]:
        """The full-resolution score map (cell softmax, dustbin dropped,
        unfolded) and the L2-normalized descriptor grid [Hc, Wc, 256] at
        1/8 resolution."""
        heat, desc = self._forward(image)
        return {"dense_score": heat.cpu().numpy(),
                "dense_descriptor": desc.cpu().numpy()}


class HarrisPatchExtractor:
    """Up to ``max_keypoints`` corners an image, each described by its
    ``block`` x ``block`` patch resized to 8 x 8, mean-free and
    L2-normalized (64 floats).  OpenCV is imported inside the call."""

    def __init__(self, max_keypoints: int = 2048, block: int = 9):
        self.max_keypoints = max_keypoints
        self.block = block

    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        import cv2
        img = np.asarray(image)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img32 = img.astype(np.float32)
        corners = cv2.goodFeaturesToTrack(
            img32, self.max_keypoints, 0.01, 5)
        if corners is None:
            return {"keypoints": np.zeros((0, 2), np.float32),
                    "scores": np.zeros(0),
                    "descriptors": np.zeros((0, 64))}
        kps = corners.reshape(-1, 2)
        half = self.block // 2
        pad = np.pad(img32, half, mode="edge")
        descs = []
        for x, y in kps:
            xi, yi = int(round(x)), int(round(y))
            patch = pad[yi:yi + self.block, xi:xi + self.block]
            v = cv2.resize(patch, (8, 8)).reshape(-1)
            v = v - v.mean()
            descs.append(v / (np.linalg.norm(v) + 1e-8))
        return {"keypoints": kps.astype(np.float32),
                "scores": np.ones(len(kps)),
                "descriptors": np.stack(descs)}
