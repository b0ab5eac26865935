"""LineTR: the Line Transformer descriptor and its matcher.

The host tokenizer splits each line into sublines of at most
``max_tokens`` tokens ``token_distance`` apart and builds the keyline <-
subline averaging matrix (numpy, as the reference); each token takes
the SuperPoint descriptor sampled from the dense grid (bilinear,
align_corners=True, in float64 torch ops: kernel S's clamp mode is
another function) and the score map's value.  The Line Descriptive
Network (MLP positional encoders, a CLS token, one transformer block over
the tokens) and the Line Signature Network (7 SuperGlue-style
self-attention layers over the sublines, a final projection) run as
torch ops on the device over a state dict keyed like the published
``LineTR_weight.pth``.  Matching lifts the subline distance matrix to
keylines through the averaging matrices (float64) and keeps mutual
nearest neighbours under a threshold.  The attention stays plain torch
(ROADMAP.md, later hand kernels).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.line2d.spec_net import SpecNet, read_checkpoint
from limap_tpu_torch.util import cv2_ops

D = 256
N_HEADS = 4
D_INNER = 1024
MLP_LAYERS = [32, 64, 128, 256]
N_SIG_LAYERS = 7
LN_EPS = 1e-6
BN_EPS = 1e-5


def mlp_spec(prefix, channels):
    """Conv1d (kernel 1) layers with batch norm + ReLU between them."""
    spec = []
    idx = 0
    n = len(channels)
    for i in range(1, n):
        spec.append((f"{prefix}.{idx}.weight",
                     (channels[i], channels[i - 1], 1)))
        spec.append((f"{prefix}.{idx}.bias", (channels[i],)))
        idx += 1
        if i < n - 1:
            for suf in ("weight", "bias", "running_mean", "running_var"):
                spec.append((f"{prefix}.{idx}.{suf}", (channels[i],)))
            idx += 2
    return spec


def _spec():
    spec = []
    spec += mlp_spec("klenc.line_position_enc.encoder",
                     [5] + MLP_LAYERS + [D])
    spec += mlp_spec("klenc.word_position_enc.encoder",
                     [3] + MLP_LAYERS + [D])
    p = "klenc.desc_layers.0"
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        spec.append((f"{p}.slf_attn.{name}.weight", (D, D)))
        spec.append((f"{p}.slf_attn.{name}.bias", (D,)))
    spec.append((f"{p}.slf_attn.layer_norm.weight", (D,)))
    spec.append((f"{p}.slf_attn.layer_norm.bias", (D,)))
    spec.append((f"{p}.pos_ffn.w_1.weight", (D_INNER, D)))
    spec.append((f"{p}.pos_ffn.w_1.bias", (D_INNER,)))
    spec.append((f"{p}.pos_ffn.w_2.weight", (D, D_INNER)))
    spec.append((f"{p}.pos_ffn.w_2.bias", (D,)))
    spec.append((f"{p}.pos_ffn.layer_norm.weight", (D,)))
    spec.append((f"{p}.pos_ffn.layer_norm.bias", (D,)))
    spec.append(("klenc.cls_token", (1, 1, 1, D)))
    for i in range(N_SIG_LAYERS):
        p = f"selfattn.layers.{i}"
        spec.append((f"{p}.attn.merge.weight", (D, D, 1)))
        spec.append((f"{p}.attn.merge.bias", (D,)))
        for j in range(3):
            spec.append((f"{p}.attn.proj.{j}.weight", (D, D, 1)))
            spec.append((f"{p}.attn.proj.{j}.bias", (D,)))
        spec += mlp_spec(f"{p}.mlp", [2 * D, 2 * D, D])
    spec.append(("final_proj.weight", (D, D, 1)))
    spec.append(("final_proj.bias", (D,)))
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded init, draw for draw: kernels N(0, 1 /
    fan_in), scales and variances 1, shifts, means and biases 0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in _spec():
        if key.endswith(".running_var"):
            v = np.ones(shape, np.float32)
        elif key.endswith((".bias", ".running_mean")):
            v = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            v = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0, (1.0 / fan_in) ** 0.5, shape).astype(
                np.float32)
        sd[key] = torch.as_tensor(v)
    return sd


class AttentionNet(SpecNet):
    """The pieces LineTR and GlueStick share: Conv1d MLPs with batch
    norm and SuperGlue's multi-head conv attention."""

    def mlp(self, prefix, x, channels):
        """x [..., C_in, N] -> [..., C_out, N]."""
        idx = 0
        n = len(channels)
        for i in range(1, n):
            x = self.conv1d(f"{prefix}.{idx}", x)
            idx += 1
            if i < n - 1:
                g = self.p(f"{prefix}.{idx}.weight")[:, None]
                beta = self.p(f"{prefix}.{idx}.bias")[:, None]
                mean = self.p(f"{prefix}.{idx}.running_mean")[:, None]
                var = self.p(f"{prefix}.{idx}.running_var")[:, None]
                x = (x - mean) * torch.rsqrt(var + BN_EPS)
                x = torch.clamp_min(x * g + beta, 0.0)
                idx += 2
        return x

    def conv_attention(self, prefix, x, source, mask=None):
        """SuperGlue's attention message over [D, N] nodes: q from x,
        k and v from source, channel d * heads + h of head h."""
        dim = D // N_HEADS
        q = self.conv1d(f"{prefix}.proj.0", x).reshape(dim, N_HEADS, -1)
        k = self.conv1d(f"{prefix}.proj.1", source).reshape(dim, N_HEADS,
                                                             -1)
        v = self.conv1d(f"{prefix}.proj.2", source).reshape(dim, N_HEADS,
                                                             -1)
        scores = torch.einsum("dhn,dhm->hnm", q, k) / dim ** 0.5
        if mask is not None:
            scores = torch.where(mask[None], scores,
                                 torch.full_like(scores, -1e9))
        prob = torch.softmax(scores, dim=-1)
        msg = torch.einsum("hnm,dhm->dhn", prob, v).reshape(D, -1)
        return self.conv1d(f"{prefix}.merge", msg)


def _layer_norm(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


class LineTRNet(AttentionNet):
    def __init__(self):
        super().__init__(_spec())

    def _lin(self, name, v):
        return torch.matmul(v, self.p(f"{name}.weight").T) \
            + self.p(f"{name}.bias")

    def word_attention(self, prefix, x, mask):
        """Multi-head attention over the token axis: x [S, W1, D], mask
        [S, W1, 1] (1 keeps a query row; a padded token's row is blanked
        over every key, as the reference's mask broadcasts)."""
        S, W1, _ = x.shape
        dim = D // N_HEADS

        def heads(name):
            return self._lin(f"{prefix}.{name}", x).reshape(
                S, W1, N_HEADS, dim).transpose(1, 2)

        q, k, v = heads("w_qs"), heads("w_ks"), heads("w_vs")
        attn = torch.matmul(q / math.sqrt(dim), k.transpose(-1, -2))
        attn = torch.where(mask[:, None] == 0, torch.full_like(attn, -1e9),
                           attn)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(S, W1, D)
        out = self._lin(f"{prefix}.fc", out) + x
        return _layer_norm(out, self.p(f"{prefix}.layer_norm.weight"),
                           self.p(f"{prefix}.layer_norm.bias"))

    def feed_forward(self, prefix, x):
        h = torch.nn.functional.gelu(self._lin(f"{prefix}.w_1", x))
        h = self._lin(f"{prefix}.w_2", h) + x
        return _layer_norm(h, self.p(f"{prefix}.layer_norm.weight"),
                           self.p(f"{prefix}.layer_norm.bias"))

    def forward(self, sublines, resp, angle, pnt, desc, score, mask):
        """Subline-major inputs: sublines [S, 2, 2] (normalized), resp
        [S, 1], angle [S, 2], pnt [S, W, 2] (normalized), desc [S, W,
        256], score [S, W, 1], mask [S, W+1, 1] -> [S, 256] unit subline
        descriptors."""
        mid = 0.5 * (sublines[:, 0] + sublines[:, 1])
        lin_in = torch.cat([mid, resp, angle], dim=-1).T
        klines_pos = self.mlp("klenc.line_position_enc.encoder", lin_in,
                              [5] + MLP_LAYERS + [D])
        word_in = torch.cat([pnt, score], dim=-1).transpose(1, 2)
        word_pos = self.mlp("klenc.word_position_enc.encoder", word_in,
                            [3] + MLP_LAYERS + [D])
        x = desc + word_pos.transpose(1, 2)
        cls = self.p("klenc.cls_token")[0, 0].expand(x.shape[0], 1, D)
        x = torch.cat([cls, x], dim=1)
        x = self.word_attention("klenc.desc_layers.0.slf_attn", x, mask)
        x = self.feed_forward("klenc.desc_layers.0.pos_ffn", x)
        sentence = klines_pos + x[:, 0, :].T
        for i in range(N_SIG_LAYERS):
            pre = f"selfattn.layers.{i}"
            msg = self.conv_attention(f"{pre}.attn", sentence, sentence)
            sentence = sentence + self.mlp(
                f"{pre}.mlp", torch.cat([sentence, msg], dim=0),
                [2 * D, 2 * D, D])
        out = self.conv1d("final_proj", sentence)
        out = out / torch.sqrt((out * out).sum(0, keepdim=True) + 1e-24)
        return out.T


def linetr_forward(net: LineTRNet, *inputs) -> torch.Tensor:
    with torch.no_grad():
        return net(*inputs)


def load_torch_state_dict(sd) -> LineTRNet:
    return LineTRNet().load_spec_state_dict(sd, "LineTR")


# ------------------------------------------------------------ tokenizer
def get_angles(lines):
    """(cos 2a, sin 2a) of each line."""
    if len(lines) == 0:
        return np.zeros((0, 2))
    sp, ep = lines[:, 0], lines[:, 1]
    ang = np.arctan2(ep[:, 0] - sp[:, 0], ep[:, 1] - sp[:, 1])
    ang = np.where(ang < 0, ang + np.pi, ang)
    return np.stack([np.cos(2 * ang), np.sin(2 * ang)], axis=-1)


def _point_on_line(line, dist_px):
    sp, ep = line
    vec = ep - sp
    if vec[0] != 0:
        m = vec[1] / vec[0]
        x = np.sqrt(dist_px ** 2 / (1 + m ** 2))
        y = m * x
    else:
        x = 0.0
        y = dist_px if ep[1] - sp[1] > 0 else -dist_px
    return np.asarray((x, y)) + sp


def tokenize(klines: np.ndarray, token_distance: float, max_tokens: int,
             image_shape):
    """Sublines, token positions, masks, responses, angles and the
    keyline <- subline averaging matrix (the reference's tokenizer)."""
    height, width = image_shape
    lengths = np.linalg.norm(klines[:, 0] - klines[:, 1], axis=-1)
    angles = get_angles(klines)
    slines, tokens_all, masks_all, resp_all, ang_all = [], [], [], [], []
    n_slines_per_kline = []
    for i, (kline, klength) in enumerate(zip(klines, lengths)):
        tokens = []
        num_tokens = max(int(math.ceil(klength / token_distance)), 1)
        for i_token in range(num_tokens - 1):
            tokens.append(_point_on_line(kline, i_token * token_distance))
        tok = kline[1].copy()
        tok[0] = min(tok[0], width - 0.6)
        tok[1] = min(tok[1], height - 0.6)
        tokens.append(tok)
        num_sublines = int(math.ceil(num_tokens / max_tokens))
        sub = np.zeros((num_sublines, 2, 2))
        sub[0, 0] = kline[0]
        sub[-1, 1] = kline[1]
        for i_s in range(num_sublines - 1):
            mid_tok = tokens[(i_s + 1) * max_tokens - 1]
            sub[i_s, 1] = mid_tok
            sub[i_s + 1, 0] = mid_tok
        slines.extend(sub)
        n_slines_per_kline.append(num_sublines)
        tok_s = np.zeros((num_sublines, max_tokens, 2))
        msk_s = np.zeros((num_sublines, max_tokens + 1, 1))
        msk_s[:, 0] = 1
        for i_s in range(num_sublines):
            chunk = np.asarray(tokens[i_s * max_tokens:
                                      (i_s + 1) * max_tokens])
            tok_s[i_s, :len(chunk)] = chunk
            msk_s[i_s, 1:len(chunk) + 1] = 1
        tokens_all.extend(tok_s)
        masks_all.extend(msk_s)
        max_length = token_distance * max_tokens
        for i_s in range(num_sublines):
            resp_all.append([np.linalg.norm(sub[i_s, 1] - sub[i_s, 0])
                             / max_length])
            ang_all.append(angles[i])
    S, L = len(slines), len(klines)
    k2s = np.zeros((L, S))
    st = 0
    for i, n_s in enumerate(n_slines_per_kline):
        k2s[i, st:st + n_s] = 1.0 / n_s
        st += n_s
    return (np.asarray(slines), np.asarray(tokens_all),
            np.asarray(masks_all), np.asarray(resp_all),
            np.asarray(ang_all), k2s)


def sample_dense_descriptors(desc_grid: torch.Tensor, tokens: np.ndarray,
                             s: int = 8) -> torch.Tensor:
    """The descriptor grid [Hc, Wc, C] sampled at token pixels [..., 2]
    as grid_sample(align_corners=True) with clipped corners, then
    L2-normalized, in float64 -> [*tokens.shape[:-1], C] float64."""
    Hc, Wc, C = desc_grid.shape
    dev = desc_grid.device
    kp = torch.as_tensor(np.asarray(tokens, np.float64).reshape(-1, 2),
                         device=dev)
    kp = kp - s / 2 + 0.5
    kp = kp / torch.tensor([(Wc * s - s / 2 - 0.5), (Hc * s - s / 2 - 0.5)],
                           dtype=torch.float64, device=dev)
    kp = kp * 2 - 1
    u = (kp[:, 0] + 1) / 2 * (Wc - 1)
    v = (kp[:, 1] + 1) / 2 * (Hc - 1)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, Wc - 1)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, Hc - 1)
    u1 = torch.clamp(u0 + 1, 0, Wc - 1)
    v1 = torch.clamp(v0 + 1, 0, Hc - 1)
    fu = torch.clamp(u - u0, 0, 1)[:, None]
    fv = torch.clamp(v - v0, 0, 1)[:, None]
    g = desc_grid.to(torch.float64)
    d = (g[v0, u0] * (1 - fv) * (1 - fu) + g[v0, u1] * (1 - fv) * fu
         + g[v1, u0] * fv * (1 - fu) + g[v1, u1] * fv * fu)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    return d.reshape(*np.asarray(tokens).shape[:-1], C)


def score_at(score_map: torch.Tensor, pts: np.ndarray) -> torch.Tensor:
    """The score map at the rounded (half to even), clipped points."""
    ti = np.round(np.asarray(pts)).astype(int)
    ti[..., 0] = ti[..., 0].clip(0, score_map.shape[1] - 1)
    ti[..., 1] = ti[..., 1].clip(0, score_map.shape[0] - 1)
    t = torch.as_tensor(ti, device=score_map.device)
    return score_map[t[..., 1], t[..., 0]]


def normalize_keylines(slines, tokens, image_shape):
    height, width = image_shape
    size = np.asarray([width, height], np.float64)
    center = size / 2
    scaling = size.max() * 0.7
    return (slines - center) / scaling, (tokens - center) / scaling


# --------------------------------------------------------------- plugin
@register_extractor("linetr")
class LineTRExtractor(BaseDetector):
    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        sd = read_checkpoint(self.weight_path, "line2d", "LineTR",
                             "weights", "LineTR_weight.pth")
        self.net = load_torch_state_dict(
            sd if sd is not None else init_params(options.get("seed", 0)))
        self.net = self.net.to(self.device).eval()
        from limap_tpu_torch.point2d.superpoint import SuperPoint
        self.sp = SuperPoint(weight_path=options.get("sp_weight_path"),
                             device=self.device)
        self.token_distance = options.get("token_distance", 8.0)
        self.max_tokens = options.get("max_tokens", 21)

    def get_module_name(self):
        return "linetr"

    def compute_descinfo(self, img: np.ndarray, segs: np.ndarray) -> dict:
        segs = np.asarray(segs)
        if len(segs) == 0:
            return {"line_descriptors": np.empty((0, 256)),
                    "mat_klines2sublines": np.empty((0, 0))}
        orig_h, orig_w = img.shape[:2]
        new_h, new_w = 480, 640
        s_h, s_w = new_h / orig_h, new_w / orig_w
        t = torch.as_tensor(np.ascontiguousarray(img), device=self.device)
        new_img = cv2_ops.resize(t, (new_w, new_h)).cpu().numpy()
        klines = segs[:, :4].reshape(-1, 2, 2) * [s_w, s_h]
        heat, desc_grid = self.sp._forward(new_img)
        slines, tokens, masks, resp, ang, k2s = tokenize(
            klines, self.token_distance, self.max_tokens, (new_h, new_w))
        desc = sample_dense_descriptors(desc_grid, tokens)
        scores = score_at(heat, tokens)[..., None]
        slines_n, tokens_n = normalize_keylines(slines, tokens,
                                                (new_h, new_w))
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a), device=dev).to(
                torch.float32)

        out = linetr_forward(self.net, f32(slines_n), f32(resp), f32(ang),
                             f32(tokens_n), desc.to(torch.float32),
                             scores.to(torch.float32), f32(masks))
        return {"line_descriptors": out.cpu().numpy(),
                "mat_klines2sublines": k2s}

    def extract(self, camview, segs) -> dict:
        img = np.asarray(camview.read_image(set_gray=True))
        return self.compute_descinfo(img, np.asarray(segs))


@register_matcher("linetr")
class LineTRMatcher(BaseMatcher):
    def __init__(self, extractor, options: Optional[dict] = None):
        super().__init__(extractor, options)
        assert extractor.get_module_name() == "linetr"
        options = options or {}
        self.device = resolve_device(options.get("device"))
        self.nn_threshold = options.get("nn_threshold", 0.8)

    def get_module_name(self):
        return "linetr"

    def match_pair(self, descinfo1, descinfo2):
        dev = self.device
        m1 = np.asarray(descinfo1["mat_klines2sublines"])
        m2 = np.asarray(descinfo2["mat_klines2sublines"])
        if (len(descinfo1["line_descriptors"]) == 0
                or len(descinfo2["line_descriptors"]) == 0
                or m1.size == 0 or m2.size == 0):
            return np.zeros((0, 2), int)
        d1 = torch.as_tensor(np.asarray(descinfo1["line_descriptors"],
                                        np.float32), device=dev)
        d2 = torch.as_tensor(np.asarray(descinfo2["line_descriptors"],
                                        np.float32), device=dev)
        dist_sub = torch.clamp_min(2.0 - 2.0 * (d1 @ d2.T), 0)
        dist = torch.as_tensor(m1, device=dev) @ dist_sub.to(torch.float64) \
            @ torch.as_tensor(m2, device=dev).T
        if self.topk == 0:
            idx = torch.argmin(dist, dim=1)
            rows = torch.arange(dist.shape[0], device=dev)
            keep = dist[rows, idx] < self.nn_threshold
            keep &= rows == torch.argmin(dist, dim=0)[idx]
            ids1 = torch.nonzero(keep, as_tuple=True)[0]
            return torch.stack([ids1, idx[ids1]], 1).cpu().numpy()
        k = min(self.topk, dist.shape[1])
        order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
        order = order.cpu().numpy()
        rows = np.arange(dist.shape[0])
        return np.concatenate([np.stack([rows, order[:, i]], axis=1)
                               for i in range(k)], axis=0)
