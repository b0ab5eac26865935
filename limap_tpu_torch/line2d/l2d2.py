"""L2D2 line descriptor (a patch CNN) and its mutual-NN matcher.

The network (an L2Net variant: input instance normalization, seven
convolutions with affine-free batch norm, a final (12, 8) convolution
collapsing a 48 x 32 patch to a 128-d unit vector) is a :class:`SpecNet`
keyed like the published checkpoint
(``line2d/L2D2/checkpoint_line_descriptor.th`` under a weights
directory).  The patches are kernel Y's (``ops/l2d2_patches.py``): the
reference's line-aligned crop of a warped image, resized to 48 x 32,
computed only where the resize reads.  Without weights the network takes
the reference's seeded orthogonal init.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.line2d.lbd import nn_matches
from limap_tpu_torch.line2d.spec_net import SpecNet, read_checkpoint
from limap_tpu_torch.ops.l2d2_patches import l2d2_patches, line_boxes

BN_EPS = 1e-5
PATCH_MEAN = 0.492967568115862
PATCH_STD = 0.272086182765434

# (conv index in ``features``, out, in, (kh, kw), stride, padding); the
# affine-free batch norm follows each conv at index + 1
_CONVS = [
    (0, 32, 1, (3, 3), 1, (1, 1)),
    (3, 32, 32, (3, 3), 1, (1, 1)),
    (6, 64, 32, (4, 3), 2, (1, 1)),
    (9, 64, 64, (3, 3), 1, (1, 1)),
    (12, 128, 64, (4, 3), 2, (1, 1)),
    (15, 128, 128, (3, 3), 1, (1, 1)),
    (19, 128, 128, (12, 8), 1, (0, 0)),
]


def _spec():
    spec = []
    for (i, o, c, (kh, kw), _, _) in _CONVS:
        spec.append((f"features.{i}.weight", (o, c, kh, kw)))
        spec.append((f"features.{i + 1}.running_mean", (o,)))
        spec.append((f"features.{i + 1}.running_var", (o,)))
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded orthogonal init, draw for draw."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in _spec():
        if key.endswith(".running_mean"):
            v = np.zeros(shape, np.float32)
        elif key.endswith(".running_var"):
            v = np.ones(shape, np.float32)
        else:
            flat = rng.normal(size=(shape[0], int(np.prod(shape[1:]))))
            if flat.shape[0] <= flat.shape[1]:
                q = np.linalg.qr(flat.T)[0].T
            else:
                q = np.linalg.qr(flat)[0]
            v = (0.6 * q.reshape(shape)).astype(np.float32)
        sd[key] = torch.as_tensor(v)
    return sd


class L2D2Net(SpecNet):
    def __init__(self):
        super().__init__(_spec())

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """patches [B, 48, 32, 1] (mean/std normalized) -> [B, 128] unit
        descriptors."""
        x = patches.permute(0, 3, 1, 2)
        flat = x.reshape(x.shape[0], -1)
        mp = flat.mean(dim=1)[:, None, None, None]
        sp = flat.std(dim=1, correction=1)[:, None, None, None] + 1e-7
        x = (x - mp) / sp
        for (i, _, _, _, stride, pad) in _CONVS:
            x = F.conv2d(x, self.p(f"features.{i}.weight"), None, stride,
                         pad)
            mean = self.p(f"features.{i + 1}.running_mean")[:, None, None]
            var = self.p(f"features.{i + 1}.running_var")[:, None, None]
            x = (x - mean) * torch.rsqrt(var + BN_EPS)
            if i != 19:
                x = torch.clamp_min(x, 0.0)
        d = x.reshape(x.shape[0], -1)
        return d / torch.sqrt((d * d).sum(1, keepdim=True) + 1e-10)


def l2d2_forward(net: L2D2Net, patches: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return net(patches)


def load_torch_state_dict(sd) -> L2D2Net:
    return L2D2Net().load_spec_state_dict(sd, "L2D2")


def get_patches(img: torch.Tensor, lines: np.ndarray) -> torch.Tensor:
    """[N, 48, 32] patches of lines [N, 2, 2] (x, y) on kernel Y."""
    minv, boxes = line_boxes(lines, tuple(img.shape))
    return l2d2_patches(img, torch.as_tensor(minv, device=img.device),
                        torch.as_tensor(boxes, device=img.device))


@register_extractor("l2d2")
class L2D2Extractor(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        sd = read_checkpoint(self.weight_path, "line2d", "L2D2",
                             "checkpoint_line_descriptor.th")
        self.net = load_torch_state_dict(
            sd if sd is not None else init_params(options.get("seed", 0)))
        self.net = self.net.to(self.device).eval()

    def get_module_name(self):
        return "l2d2"

    def extract(self, camview, segs) -> dict:
        return self.extract_array(camview.read_image(set_gray=True), segs)

    def extract_array(self, img: np.ndarray, segs) -> dict:
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        segs = np.asarray(segs)
        if len(segs) == 0:
            return {"line_descriptors": np.zeros((0, 128), np.float32)}
        t = torch.as_tensor(img, device=self.device)
        patches = get_patches(t, segs[:, :4].reshape(-1, 2, 2))
        patches = (patches - PATCH_MEAN) / PATCH_STD
        desc = l2d2_forward(self.net, patches[..., None])
        return {"line_descriptors": desc.cpu().numpy()}


@register_matcher("l2d2")
class L2D2Matcher(BaseMatcher):
    def __init__(self, extractor, options: Optional[dict] = None):
        super().__init__(extractor, options)
        assert extractor.get_module_name() == "l2d2"
        self.device = resolve_device((options or {}).get("device"))

    def get_module_name(self):
        return "l2d2"

    def match_pair(self, descinfo1, descinfo2):
        d1 = torch.as_tensor(np.asarray(descinfo1["line_descriptors"],
                                        np.float32), device=self.device)
        d2 = torch.as_tensor(np.asarray(descinfo2["line_descriptors"],
                                        np.float32), device=self.device)
        if len(d1) == 0 or len(d2) == 0:
            return np.zeros((0, 2), int)
        return nn_matches(d1 @ d2.T, self.topk, smaller_is_better=False)
