"""HAWPv3 wireframe detector: the published stacked-hourglass backbone
and multitask head, the HAFM line decoding and junction decoding, on the
device.

The network follows ``hawp/fsl/backbones/stacked_hg.py`` with the
reference's ``hawpv3.yaml`` (2 stacks, depth 4, 64 input planes, 128
features, 1 block, heads [[3], [1], [1], [2], [2]], gray input); its
state dict has the published names, so ``hawpv3_wireframe.pth`` loads
(the LOI verifier's keys are ignored, as the reference ignores them).
The stem convolution (7x7, stride 2) pads 3 on each side as upstream
does; the reference package pads (2, 3) (SAME), so on the same weights
its maps are shifted by a pixel (ROADMAP.md section 3).

Detection: the holistic attraction field gives three candidate segments
a pixel, the junctions come from a 3x3 NMS of the junction map (top 300,
offset-refined), both endpoints of a candidate snap to their nearest
junctions (in chunks of candidates, float32 norms, the first junction on
ties), and a candidate is kept when both snap within 10 px to distinct
junctions; one segment a junction pair, in the order of the pair's id
(lo * J + hi), scored by the product of the junction scores.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import BaseDetector, register_detector
from limap_tpu_torch.line2d.spec_net import (SpecNet, read_checkpoint, relu,
                                             to_nchw, to_nhwc)

DEPTH = 4
INPLANES = 64
NUM_FEATS = 128
NUM_BLOCKS = 1
NUM_STACKS = 2
HEAD_SIZE = [[3], [1], [1], [2], [2]]   # md, dis, res, jloc, joff
NUM_CLASSES = sum(sum(HEAD_SIZE, []))   # 9
CH = NUM_FEATS * 2                      # Bottleneck2D.expansion = 2
STEM_PAD = 3                            # upstream's nn.Conv2d(padding=3)
SNAP_CHUNK = 16384                      # candidates a chunk of the snap


def _bottleneck_spec(prefix: str, inplanes: int, planes: int,
                     downsample: bool) -> List[Tuple[str, tuple]]:
    out = []

    def bn(name, c):
        for suf in ("weight", "bias", "running_mean", "running_var"):
            out.append((f"{prefix}.{name}.{suf}", (c,)))

    def cv(name, o, i, k):
        out.append((f"{prefix}.{name}.weight", (o, i, k, k)))
        out.append((f"{prefix}.{name}.bias", (o,)))

    bn("bn1", inplanes)
    cv("conv1", planes, inplanes, 1)
    bn("bn2", planes)
    cv("conv2", planes, planes, 3)
    bn("bn3", planes)
    cv("conv3", planes * 2, planes, 1)
    if downsample:
        cv("downsample.0", planes * 2, inplanes, 1)
    return out


def key_spec() -> List[Tuple[str, tuple]]:
    """Every (state dict key, torch shape) of the network."""
    spec = []

    def cv(name, o, i, k):
        spec.append((f"{name}.weight", (o, i, k, k)))
        spec.append((f"{name}.bias", (o,)))

    def bn(name, c):
        for suf in ("weight", "bias", "running_mean", "running_var"):
            spec.append((f"{name}.{suf}", (c,)))

    P = "backbone"
    cv(f"{P}.conv1", INPLANES, 1, 7)
    bn(f"{P}.bn1", INPLANES)
    spec += _bottleneck_spec(f"{P}.layer1.0", 64, 64, True)
    spec += _bottleneck_spec(f"{P}.layer2.0", 128, 128, True)
    spec += _bottleneck_spec(f"{P}.layer3.0", 256, 128, False)
    for s in range(NUM_STACKS):
        for d in range(DEPTH):
            for j in range(4 if d == 0 else 3):
                for b in range(NUM_BLOCKS):
                    spec += _bottleneck_spec(f"{P}.hg.{s}.hg.{d}.{j}.{b}",
                                             CH, NUM_FEATS, False)
        for b in range(NUM_BLOCKS):
            spec += _bottleneck_spec(f"{P}.res.{s}.{b}", CH, NUM_FEATS,
                                     False)
        cv(f"{P}.fc.{s}.0", CH, CH, 1)
        bn(f"{P}.fc.{s}.1", CH)
        for m, out_ch in enumerate(sum(HEAD_SIZE, [])):
            cv(f"{P}.score.{s}.heads.{m}.0", CH // 4, CH, 3)
            cv(f"{P}.score.{s}.heads.{m}.2", out_ch, CH // 4, 1)
        if s < NUM_STACKS - 1:
            cv(f"{P}.fc_.{s}", CH, CH, 1)
            cv(f"{P}.score_.{s}", CH, NUM_CLASSES, 1)
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded random weights, draw for draw (batch-norm
    scales and variances 1, shifts, means and biases 0)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in key_spec():
        if key.endswith(".running_var") or (key.endswith(".weight")
                                            and len(shape) == 1):
            v = np.ones(shape, np.float32)
        elif len(shape) == 1:
            v = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0, (2.0 / fan_in) ** 0.5, shape).astype(
                np.float32)
        sd[key] = torch.as_tensor(v)
    return sd


class HAWPv3Net(SpecNet):
    def __init__(self):
        super().__init__(key_spec())

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        g, b = self.p(f"{name}.weight"), self.p(f"{name}.bias")
        m, v = self.p(f"{name}.running_mean"), self.p(f"{name}.running_var")
        return ((x - m[:, None, None]) * torch.rsqrt(v + 1e-5)[:, None, None]
                * g[:, None, None] + b[:, None, None])

    def bottleneck(self, prefix: str, x: torch.Tensor,
                   downsample: bool) -> torch.Tensor:
        out = relu(self.bn(f"{prefix}.bn1", x))
        out = self.conv(f"{prefix}.conv1", out, padding="valid")
        out = relu(self.bn(f"{prefix}.bn2", out))
        out = self.conv(f"{prefix}.conv2", out)
        out = relu(self.bn(f"{prefix}.bn3", out))
        out = self.conv(f"{prefix}.conv3", out, padding="valid")
        res = self.conv(f"{prefix}.downsample.0", x, padding="valid") \
            if downsample else x
        return out + res

    def hourglass(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        def blocks(d, j, y):
            for b in range(NUM_BLOCKS):
                y = self.bottleneck(f"{prefix}.hg.{d}.{j}.{b}", y, False)
            return y

        def rec(n, y):
            up1 = blocks(n - 1, 0, y)
            low1 = blocks(n - 1, 1, F.max_pool2d(y, 2, 2))
            low2 = rec(n - 1, low1) if n > 1 else blocks(0, 3, low1)
            low3 = blocks(n - 1, 2, low2)
            return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

        return rec(DEPTH, x)

    def scores(self, image: torch.Tensor) -> torch.Tensor:
        """image [B, H, W, 1] (H, W multiples of 64) -> the last stack's
        scores [B, h, w, 9] at 1/4 resolution, before the heads'
        sigmoids and softmax."""
        P = "backbone"
        x = self.conv(f"{P}.conv1", to_nchw(image), stride=2,
                      padding=STEM_PAD)
        x = relu(self.bn(f"{P}.bn1", x))
        x = self.bottleneck(f"{P}.layer1.0", x, True)
        x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(f"{P}.layer2.0", x, True)
        x = self.bottleneck(f"{P}.layer3.0", x, False)
        score = None
        for s in range(NUM_STACKS):
            y = self.hourglass(f"{P}.hg.{s}", x)
            for b in range(NUM_BLOCKS):
                y = self.bottleneck(f"{P}.res.{s}.{b}", y, False)
            y = relu(self.bn(f"{P}.fc.{s}.1", self.conv(
                f"{P}.fc.{s}.0", y, padding="valid")))
            outs = [self.conv(f"{P}.score.{s}.heads.{m}.2", relu(self.conv(
                f"{P}.score.{s}.heads.{m}.0", y)), padding="valid")
                for m in range(len(sum(HEAD_SIZE, [])))]
            score = torch.cat(outs, 1)
            if s < NUM_STACKS - 1:
                x = x + self.conv(f"{P}.fc_.{s}", y, padding="valid") \
                    + self.conv(f"{P}.score_.{s}", score, padding="valid")
        return to_nhwc(score)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image [B, H, W, 1] -> maps at 1/4 resolution, channels last:
        md [B,h,w,3], dis, res, jloc (a probability) [B,h,w,1], joff
        [B,h,w,2] (offsets in [-0.5, 0.5])."""
        return heads(self.scores(image))


def heads(score: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The maps of the scores [..., 9]: the heads' sigmoids and softmax."""
    return {"md": torch.sigmoid(score[..., 0:3]),
            "dis": torch.sigmoid(score[..., 3:4]),
            "res": torch.sigmoid(score[..., 4:5]),
            "jloc": torch.softmax(score[..., 5:7], dim=-1)[..., 1:2],
            "joff": torch.sigmoid(score[..., 7:9]) - 0.5}


def hawp_forward(net: HAWPv3Net, image: torch.Tensor):
    with torch.no_grad():
        return net(image)


def load_torch_state_dict(sd, key_map: Optional[Dict[str, str]] = None,
                          verbose: bool = False) -> HAWPv3Net:
    return HAWPv3Net().load_spec_state_dict(
        sd, "published HAWPv3 stacked-hourglass", key_map, verbose)


# ----------------------------------------------------------- decoding
def hafm_decoding(md: torch.Tensor, dis: torch.Tensor, res: torch.Tensor,
                  scale: float = 5.0,
                  residual_ts=(-1.0, 0.0, 1.0)) -> torch.Tensor:
    """The holistic attraction field [h, w, C] -> candidate segments
    [len(ts), h * w, 4] in 1/4-resolution pixels (float32)."""
    h, w = md.shape[:2]
    dev = md.device
    y0 = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w)
    x0 = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w)
    pi = np.float32(np.pi)
    md_ = (md[..., 0] - 0.5) * pi * 2
    st_ = md[..., 1] * pi / 2
    ed_ = -md[..., 2] * pi / 2
    cs, ss = torch.cos(md_), torch.sin(md_)
    y_st, y_ed = torch.tan(st_), torch.tan(ed_)
    out = []
    for t in residual_ts:
        d = torch.clamp(dis[..., 0] + t * res[..., 0], 0, 1) * scale
        out.append(torch.stack([
            (cs - ss * y_st) * d + x0, (ss + cs * y_st) * d + y0,
            (cs - ss * y_ed) * d + x0, (ss + cs * y_ed) * d + y0],
            dim=-1).reshape(-1, 4))
    return torch.stack(out)


def decode_junctions(jloc: torch.Tensor, joff: torch.Tensor,
                     topk: int = 300, th: float = 0.008):
    """3x3 NMS (a max-pool padded with -inf, which equals scipy's
    maximum_filter in reflect mode) + the top-k by score (a stable sort:
    the first pixel in row-major order among equal scores) + the offset
    refinement -> (points [J, 2] f32, scores [J] f32)."""
    prob = jloc[..., 0]
    pooled = F.max_pool2d(prob[None, None], 3, 1, 1)[0, 0]
    keep = (pooled == prob) & (prob > th)
    ys, xs = torch.nonzero(keep, as_tuple=True)
    scores = prob[ys, xs]
    order = torch.sort(-scores, stable=True).indices[:topk]
    ys, xs, scores = ys[order], xs[order], scores[order]
    off = joff[ys, xs].to(torch.float64)
    pts = torch.stack([xs.to(torch.float64) + off[:, 0] + 0.5,
                       ys.to(torch.float64) + off[:, 1] + 0.5], 1)
    return pts.to(torch.float32), scores


def _nearest(points: torch.Tensor, juncs: torch.Tensor):
    """(distance, index) of each point's nearest junction, float32 norms,
    the first index on ties, in chunks of SNAP_CHUNK points."""
    dist, idx = [], []
    for a in range(0, points.shape[0], SNAP_CHUNK):
        diff = points[a:a + SNAP_CHUNK, None] - juncs[None]
        d = torch.sqrt((diff * diff).sum(-1))
        m, i = torch.min(d, dim=1)
        dist.append(m)
        idx.append(i)
    return torch.cat(dist), torch.cat(idx)


def match_lines_to_junctions(lines: torch.Tensor, juncs: torch.Tensor,
                             jscore: torch.Tensor,
                             dist_th: float = 10.0) -> torch.Tensor:
    """Snap both endpoints of every candidate [N, 4] to the nearest
    junction; keep distinct-endpoint snaps within ``dist_th``, one a
    junction pair in the order of the pair's id -> [M, 5]."""
    dev = lines.device
    if not len(juncs) or not len(lines):
        return torch.zeros((0, 5), dtype=torch.float32, device=dev)
    d1, j1 = _nearest(lines[:, 0:2], juncs)
    d2, j2 = _nearest(lines[:, 2:4], juncs)
    ok = (d1 < dist_th) & (d2 < dist_th) & (j1 != j2)
    j1, j2 = j1[ok], j2[ok]
    if not len(j1):
        return torch.zeros((0, 5), dtype=torch.float32, device=dev)
    lo, hi = torch.minimum(j1, j2), torch.maximum(j1, j2)
    pair = lo * len(juncs) + hi
    uniq, inverse = torch.unique(pair, sorted=True, return_inverse=True)
    first = torch.full((len(uniq),), len(pair), dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, inverse, torch.arange(len(pair), device=dev), reduce="amin")
    lo, hi = lo[first], hi[first]
    segs = torch.cat([juncs[lo], juncs[hi]], dim=1)
    return torch.cat([segs, (jscore[lo] * jscore[hi])[:, None]], dim=1)


@register_detector("hawpv3")
class HAWPv3Detector(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        self.detect_thresh = options.get("detect_thresh", 0.008)
        sd = read_checkpoint(self.weight_path, "line2d", "HAWPv3",
                             "weights", "hawpv3_wireframe.pth")
        if sd is None:
            import warnings
            warnings.warn(
                "hawpv3 running with RANDOM weights (no weight_path); "
                "detections will be meaningless — pass the published "
                "hawpv3_wireframe.pth", stacklevel=2)
            self.net = load_torch_state_dict(
                init_params(options.get("seed", 0)))
        else:
            self.net = load_torch_state_dict(sd, options.get("key_map"),
                                             verbose=True)
        self.net = self.net.to(self.device).eval()

    def get_module_name(self):
        return "hawpv3"

    def detect(self, camview) -> np.ndarray:
        return self.detect_array(camview.read_image(set_gray=True))

    def image_tensor(self, img: np.ndarray) -> torch.Tensor:
        """The network's input [1, Hp, Wp, 1] of an image: gray in [0, 1],
        zero-padded to multiples of 64."""
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape
        Hp, Wp = -(-H // 64) * 64, -(-W // 64) * 64
        buf = np.zeros((1, Hp, Wp, 1), np.float32)
        buf[0, :H, :W, 0] = img
        return torch.as_tensor(buf, device=self.device)

    def maps(self, img: np.ndarray) -> Dict[str, torch.Tensor]:
        """The maps of :meth:`HAWPv3Net.forward` at 1/4 resolution, the
        batch dimension dropped."""
        out = hawp_forward(self.net, self.image_tensor(img))
        return {k: v[0] for k, v in out.items()}

    def detect_array(self, img: np.ndarray) -> np.ndarray:
        H, W = np.asarray(img).shape[:2]
        return decode(self.maps(img), H, W, self.detect_thresh)


def decode(maps: Dict[str, torch.Tensor], H: int, W: int,
           detect_thresh: float = 0.008) -> np.ndarray:
    """Segments [N, 5] in pixels from the 1/4-resolution maps."""
    cand = hafm_decoding(maps["md"], maps["dis"], maps["res"]).reshape(-1, 4)
    juncs, jscore = decode_junctions(maps["jloc"], maps["joff"],
                                     th=detect_thresh)
    segs = match_lines_to_junctions(cand, juncs, jscore)
    segs = torch.cat([segs[:, :4] * 4.0, segs[:, 4:]], dim=1)
    keep = ((segs[:, 0] < W) & (segs[:, 2] < W)
            & (segs[:, 1] < H) & (segs[:, 3] < H))
    return segs[keep].cpu().numpy()
