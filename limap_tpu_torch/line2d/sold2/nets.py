"""SOLD2's network ("lcnn_simple": a stacked-hourglass backbone, then the
junction, heatmap and descriptor decoders) as an ``nn.Module``.

The module tree mirrors the published model, so its ``state_dict`` has
the names and layouts of ``sold2_wireframe.tar``'s ``model_state_dict``
and loads it directly.  Batch norm runs in inference form, written as
the reference writes it (x * inv + (bias - mean * inv), inv = weight /
sqrt(var + eps)).  The architecture is the reference's one shipped
config: depth 4, 2 stacks, 1 block, 5 classes, grid size 8.

Layout: the public functions take and return channels-last (NHWC)
tensors, as the reference; the module computes channels-first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
DEPTH, NUM_STACKS, NUM_BLOCKS = 4, 2, 1
HEAD_SIZES = (2, 1, 2)


# ------------------------------------------------------------ primitives
def bn(mod: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference batch norm in the reference's form."""
    inv = mod.weight * torch.rsqrt(mod.running_var + BN_EPS)
    shift = mod.bias - mod.running_mean * inv
    return x * inv[:, None, None] + shift[:, None, None]


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """torch's F.interpolate(mode="nearest") source index floor(i * in /
    out), with the product in float32 as the reference computes it."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor(i * np.float32(n_in / n_out)).to(torch.int64)


def resize_nearest_torch(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] by nearest neighbour (index
    floor(i * in / out))."""
    _, H, W, _ = x.shape
    return x[:, nearest_index(H, out_h, x.device)][
        :, :, nearest_index(W, out_w, x.device)]


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """nn.PixelShuffle (channel index c r r + i r + j) in NHWC."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW counterpart of :func:`resize_nearest_torch`."""
    return x[:, :, nearest_index(x.shape[2], h, x.device)][
        :, :, :, nearest_index(x.shape[3], w, x.device)]


# ------------------------------------------------------------- modules
class Bottleneck2D(nn.Module):
    """Pre-activation bottleneck, expansion 2."""

    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes)
        self.conv1 = nn.Conv2d(inplanes, planes, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.bn3 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 2, 1)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 2, 1))
        else:
            self.downsample = None

    def forward(self, x):
        out = self.conv1(F.relu(bn(self.bn1, x)))
        out = self.conv2(F.relu(bn(self.bn2, out)))
        out = self.conv3(F.relu(bn(self.bn3, out)))
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


def _blocks(n, inplanes=256, planes=128, first_downsample=False):
    return nn.Sequential(*[
        Bottleneck2D(inplanes if i == 0 else planes * 2, planes,
                     downsample=(i == 0 and first_downsample))
        for i in range(n)])


class Hourglass(nn.Module):
    """Recursive hourglass; its upsampling is nearest neighbour."""

    def __init__(self, depth: int, num_blocks: int):
        super().__init__()
        self.depth = depth
        self.hg = nn.ModuleList([
            nn.ModuleList([_blocks(num_blocks)
                           for _ in range(4 if i == 0 else 3)])
            for i in range(depth)])

    def _fwd(self, n, y):
        up1 = self.hg[n - 1][0](y)
        low1 = self.hg[n - 1][1](F.max_pool2d(y, 2, 2))
        low2 = self._fwd(n - 1, low1) if n > 1 else self.hg[0][3](low1)
        low3 = self.hg[n - 1][2](low2)
        return up1 + _upsample_nearest(low3, up1.shape[2], up1.shape[3])

    def forward(self, x):
        return self._fwd(self.depth, x)


class MultitaskHead(nn.Module):
    def __init__(self, inplanes: int = 256):
        super().__init__()
        self.heads = nn.ModuleList([
            nn.Sequential(nn.Conv2d(inplanes, inplanes // 4, 3, padding=1),
                          nn.ReLU(inplace=False),
                          nn.Conv2d(inplanes // 4, oc, 1))
            for oc in HEAD_SIZES])

    def forward(self, x):
        return torch.cat([h(x) for h in self.heads], dim=1)


class HourglassNet(nn.Module):
    """The backbone's net; ``forward`` returns the last stack's 256-ch
    features at 1/4 resolution."""

    def __init__(self, depth=DEPTH, num_stacks=NUM_STACKS,
                 num_blocks=NUM_BLOCKS):
        super().__init__()
        self.num_stacks = num_stacks
        self.conv1 = nn.Conv2d(1, 64, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = _blocks(1, 64, 64, first_downsample=True)
        self.layer2 = _blocks(1, 128, 128, first_downsample=True)
        self.layer3 = _blocks(1, 256, 128)
        self.hg = nn.ModuleList([Hourglass(depth, num_blocks)
                                 for _ in range(num_stacks)])
        self.res = nn.ModuleList([_blocks(num_blocks)
                                  for _ in range(num_stacks)])
        self.fc = nn.ModuleList([
            nn.Sequential(nn.Conv2d(256, 256, 1), nn.BatchNorm2d(256),
                          nn.ReLU(inplace=False))
            for _ in range(num_stacks)])
        self.score = nn.ModuleList([MultitaskHead()
                                    for _ in range(num_stacks)])
        self.fc_ = nn.ModuleList([nn.Conv2d(256, 256, 1)
                                  for _ in range(num_stacks - 1)])
        self.score_ = nn.ModuleList([nn.Conv2d(sum(HEAD_SIZES), 256, 1)
                                     for _ in range(num_stacks - 1)])

    def forward(self, x):
        x = F.relu(bn(self.bn1, self.conv1(x)))
        x = self.layer1(x)
        x = F.max_pool2d(x, 2, 2)
        x = self.layer3(self.layer2(x))
        y = x
        for i in range(self.num_stacks):
            y = self.res[i](self.hg[i](x))
            y = F.relu(bn(self.fc[i][1], self.fc[i][0](y)))
            if i < self.num_stacks - 1:
                score = self.score[i](y)
                x = x + self.fc_[i](y) + self.score_[i](score)
        return y


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = HourglassNet()


class JunctionDecoder(nn.Module):
    """A strided 3x3 conv (padding 1 on both sides), then 65 channels at
    1/8 resolution."""

    def __init__(self):
        super().__init__()
        self.convPa = nn.Conv2d(256, 256, 3, stride=2, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)

    def forward(self, feat):
        return self.convPb(F.relu(self.convPa(feat)))


class HeatmapDecoder(nn.Module):
    """Pixel-shuffle decoder, two upsamplings, 2 channels at full
    resolution."""

    def __init__(self):
        super().__init__()
        self.conv_block_lst = nn.ModuleList([
            nn.Sequential(nn.Conv2d(256, 256, 3, padding=1),
                          nn.BatchNorm2d(256), nn.ReLU(inplace=False)),
            nn.Sequential(nn.Conv2d(64, 64, 3, padding=1),
                          nn.BatchNorm2d(64), nn.ReLU(inplace=False)),
            nn.Conv2d(16, 2, 1)])

    def forward(self, feat):
        y = feat
        for blk in self.conv_block_lst[:2]:
            y = F.pixel_shuffle(F.relu(bn(blk[1], blk[0](y))), 2)
        return self.conv_block_lst[2](y)


class DescriptorDecoder(nn.Module):
    """128-d descriptor grid at 1/4 resolution."""

    def __init__(self):
        super().__init__()
        self.convPa = nn.Conv2d(256, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 128, 1)

    def forward(self, feat):
        return self.convPb(F.relu(self.convPa(feat)))


class SOLD2Net(nn.Module):
    """The whole network; ``forward`` takes [B, 1, H, W] in [0, 1] (H, W
    multiples of 8) and returns NCHW maps."""

    def __init__(self):
        super().__init__()
        self.backbone_net = Backbone()
        self.junction_decoder = JunctionDecoder()
        self.heatmap_decoder = HeatmapDecoder()
        self.descriptor_decoder = DescriptorDecoder()

    def forward(self, x):
        feat = self.backbone_net.net(x)
        return {"junctions": self.junction_decoder(feat),
                "heatmap": self.heatmap_decoder(feat),
                "descriptors": self.descriptor_decoder(feat)}


def sold2_forward(net: SOLD2Net, image: torch.Tensor) -> Dict[str,
                                                              torch.Tensor]:
    """The full forward pass.  image: [B, H, W, 1] grayscale in [0, 1]
    (H, W multiples of 8).  Returns NHWC maps: junctions [B, H/8, W/8,
    65], heatmap [B, H, W, 2], descriptors [B, H/4, W/4, 128]."""
    with torch.no_grad():
        out = net(image.permute(0, 3, 1, 2))
    return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


# ------------------------------------------------------------- weights
def _spec():
    """(torch key, shape) of the full lcnn_simple state dict (conv
    shapes OIHW)."""
    spec = []

    def add_conv(name, o, i, k, bias=True):
        spec.append((name + ".weight", (o, i, k, k)))
        if bias:
            spec.append((name + ".bias", (o,)))

    def add_bn(name, c):
        for suffix in (".weight", ".bias", ".running_mean", ".running_var"):
            spec.append((name + suffix, (c,)))

    def add_bottleneck(prefix, inplanes, planes, downsample):
        add_bn(prefix + ".bn1", inplanes)
        add_conv(prefix + ".conv1", planes, inplanes, 1)
        add_bn(prefix + ".bn2", planes)
        add_conv(prefix + ".conv2", planes, planes, 3)
        add_bn(prefix + ".bn3", planes)
        add_conv(prefix + ".conv3", planes * 2, planes, 1)
        if downsample:
            add_conv(prefix + ".downsample.0", planes * 2, inplanes, 1)

    pre = "backbone_net.net"
    add_conv(pre + ".conv1", 64, 1, 7)
    add_bn(pre + ".bn1", 64)
    add_bottleneck(pre + ".layer1.0", 64, 64, True)
    add_bottleneck(pre + ".layer2.0", 128, 128, True)
    add_bottleneck(pre + ".layer3.0", 256, 128, False)
    for s in range(NUM_STACKS):
        for i in range(DEPTH):
            for j in range(4 if i == 0 else 3):
                add_bottleneck(f"{pre}.hg.{s}.hg.{i}.{j}.0", 256, 128,
                               False)
        add_bottleneck(f"{pre}.res.{s}.0", 256, 128, False)
        add_conv(f"{pre}.fc.{s}.0", 256, 256, 1)
        add_bn(f"{pre}.fc.{s}.1", 256)
        for h, oc in enumerate(HEAD_SIZES):
            add_conv(f"{pre}.score.{s}.heads.{h}.0", 64, 256, 3)
            add_conv(f"{pre}.score.{s}.heads.{h}.2", oc, 64, 1)
        if s < NUM_STACKS - 1:
            add_conv(f"{pre}.fc_.{s}", 256, 256, 1)
            add_conv(f"{pre}.score_.{s}", 256, 5, 1)
    add_conv("junction_decoder.convPa", 256, 256, 3)
    add_conv("junction_decoder.convPb", 65, 256, 1)
    add_conv("heatmap_decoder.conv_block_lst.0.0", 256, 256, 3)
    add_bn("heatmap_decoder.conv_block_lst.0.1", 256)
    add_conv("heatmap_decoder.conv_block_lst.1.0", 64, 64, 3)
    add_bn("heatmap_decoder.conv_block_lst.1.1", 64)
    add_conv("heatmap_decoder.conv_block_lst.2", 2, 16, 1)
    add_conv("descriptor_decoder.convPa", 256, 256, 3)
    add_conv("descriptor_decoder.convPb", 128, 256, 1)
    return spec


def load_torch_state_dict(sd) -> Dict[str, torch.Tensor]:
    """The checkpoint's entries of :func:`_spec` (``sold2_wireframe.tar``
    stores them under ``model_state_dict``) as float32 tensors, each
    checked for presence and shape; other entries are left out."""
    params = {}
    for key, shape in _spec():
        if key not in sd:
            raise KeyError(f"missing checkpoint entry {key} "
                           f"(expected shape {shape})")
        v = sd[key]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(v.shape)} != {shape}")
        params[key] = v.to(torch.float32)
    return params


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random parameters in the checkpoint's layout, the reference's
    draws (numpy's generator: He-normal kernels, small conv biases,
    identity batch norms), so both packages' engines of one seed hold
    the same weights."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in _spec():
        if key.endswith(".running_var"):
            v = np.ones(shape, np.float32)
        elif key.endswith((".running_mean", ".bias")):
            v = np.zeros(shape, np.float32)
            if key.endswith(".bias") and "bn" not in key:
                v = rng.normal(0, 0.01, shape).astype(np.float32)
        elif key.endswith(".weight") and len(shape) == 1:
            v = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            v = rng.normal(0, (2.0 / fan_in) ** 0.5, shape).astype(
                np.float32)
        params[key] = torch.as_tensor(v)
    return params


def build_net(params: Dict[str, torch.Tensor], device) -> SOLD2Net:
    """A :class:`SOLD2Net` in eval mode on ``device`` holding
    ``params`` (every key of :func:`_spec`)."""
    net = SOLD2Net()
    missing, unexpected = net.load_state_dict(params, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"SOLD2 parameters: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    return net.to(device).eval()
