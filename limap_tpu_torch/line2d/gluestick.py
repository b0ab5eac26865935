"""GlueStick-style joint line matcher: a GNN over the lines' endpoints.

The extractor takes each line's endpoints as junction nodes with
SuperPoint descriptors sampled from the dense grid (``linetr``'s
float64 sampler) and the score map's value.  The matcher encodes the
junctions (an MLP of position and score added to the descriptor), runs
9 rounds of self-attention, line message passing (each junction attends
to its line's other endpoint) and cross-attention, scores each line
pair by its endpoints' similarities (the better of the two orderings),
and assigns lines by a 30-iteration optimal transport with a learned
dustbin on ``ops/log_sinkhorn.py`` (kernel R on the card), keeping
mutual best matches above a threshold.  The state dict is keyed like
the reference's spec (``line2d/GlueStick/checkpoint_GlueStick_MD.tar``
under a weights directory).  The attention stays plain torch
(ROADMAP.md, later hand kernels).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.line2d.linetr import (AttentionNet, mlp_spec,
                                           sample_dense_descriptors,
                                           score_at)
from limap_tpu_torch.line2d.spec_net import read_checkpoint
from limap_tpu_torch.ops.log_sinkhorn import log_sinkhorn

D = 256
N_HEADS = 4
N_GNN_LAYERS = 9
OT_ITERS = 30
ENCODER = [3, 32, 64, 128, 256, D]


def _attn_spec(prefix):
    spec = [(f"{prefix}.attn.merge.weight", (D, D, 1)),
            (f"{prefix}.attn.merge.bias", (D,))]
    for j in range(3):
        spec.append((f"{prefix}.attn.proj.{j}.weight", (D, D, 1)))
        spec.append((f"{prefix}.attn.proj.{j}.bias", (D,)))
    return spec + mlp_spec(f"{prefix}.mlp", [2 * D, 2 * D, D])


def _spec():
    spec = mlp_spec("kenc.encoder", ENCODER) + mlp_spec("lenc.encoder",
                                                        ENCODER)
    for i in range(N_GNN_LAYERS):
        for kind in ("self", "line", "cross"):
            spec += _attn_spec(f"gnn.{kind}.{i}")
    spec.append(("final_proj.weight", (D, D, 1)))
    spec.append(("final_proj.bias", (D,)))
    spec.append(("bin_score", ()))
    return spec


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded init, draw for draw (a dustbin score of
    1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in _spec():
        if key == "bin_score":
            v = np.asarray(1.0, np.float32)
        elif key.endswith(".running_var"):
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


class GlueStickNet(AttentionNet):
    def __init__(self):
        super().__init__(_spec())

    def layer(self, prefix, x, source, mask=None):
        msg = self.conv_attention(f"{prefix}.attn", x, source, mask)
        return x + self.mlp(f"{prefix}.mlp", torch.cat([x, msg], 0),
                            [2 * D, 2 * D, D])

    def encode(self, junc_desc, feats):
        """Node descriptors [D, N]: descriptors [D, N] + the MLP of
        (x, y, score) [3, N]."""
        return junc_desc + self.mlp("lenc.encoder", feats, ENCODER)

    def forward(self, desc0, desc1, adj0, adj1):
        """desc [D, N] node descriptors; adj [N, N] bool (a junction and
        its line's other endpoint) -> the two final projections."""
        x0, x1 = desc0, desc1
        for i in range(N_GNN_LAYERS):
            x0 = self.layer(f"gnn.self.{i}", x0, x0)
            x1 = self.layer(f"gnn.self.{i}", x1, x1)
            if adj0 is not None:
                x0 = self.layer(f"gnn.line.{i}", x0, x0, adj0)
            if adj1 is not None:
                x1 = self.layer(f"gnn.line.{i}", x1, x1, adj1)
            x0, x1 = (self.layer(f"gnn.cross.{i}", x0, x1),
                      self.layer(f"gnn.cross.{i}", x1, x0))
        return self.conv1d("final_proj", x0), self.conv1d("final_proj", x1)


def gluestick_gnn(net: GlueStickNet, desc0, desc1, adj0, adj1):
    with torch.no_grad():
        return net(desc0, desc1, adj0, adj1)


def load_torch_state_dict(sd, key_map: Optional[Dict[str, str]] = None
                          ) -> GlueStickNet:
    return GlueStickNet().load_spec_state_dict(sd, "GlueStick", key_map)


@register_extractor("gluestick")
class GlueStickExtractor(BaseDetector):
    """Line endpoints as junction nodes with SuperPoint descriptors."""

    def __init__(self, options: Optional[dict] = None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        from limap_tpu_torch.point2d.superpoint import SuperPoint
        self.sp = SuperPoint(weight_path=options.get("sp_weight_path"),
                             device=self.device)

    def get_module_name(self):
        return "gluestick"

    def extract(self, camview, segs) -> dict:
        return self.extract_array(camview.read_image(set_gray=True), segs)

    def extract_array(self, img: np.ndarray, segs) -> dict:
        img = np.asarray(img)
        segs = np.asarray(segs)
        lines = segs[:, :4].reshape(-1, 2, 2) if len(segs) else \
            np.zeros((0, 2, 2))
        heat, desc_grid = self.sp._forward(img)
        junctions = lines.reshape(-1, 2).astype(np.float32)
        if len(junctions):
            jdesc = sample_dense_descriptors(
                desc_grid, junctions[None])[0].cpu().numpy()
            jscore = score_at(heat, junctions).cpu().numpy()
        else:
            jdesc = np.zeros((0, desc_grid.shape[-1]))
            jscore = np.zeros(0)
        return {"lines": lines.astype(np.float32), "junctions": junctions,
                "junc_desc": jdesc, "junc_score": jscore.astype(np.float32),
                "image_shape": np.asarray(img.shape[:2])}


def adjacency(n_lines: int, device) -> torch.Tensor:
    """[2n, 2n] bool: each endpoint and its line's other endpoint."""
    i = torch.arange(2 * n_lines, device=device)
    return (i[:, None] ^ 1) == i[None, :]


@register_matcher("gluestick")
class GlueStickMatcher(BaseMatcher):
    def __init__(self, extractor, options: Optional[dict] = None):
        super().__init__(extractor, options)
        assert extractor.get_module_name() == "gluestick"
        options = options or {}
        self.device = resolve_device(options.get("device"))
        sd = read_checkpoint(self.weight_path, "line2d", "GlueStick",
                             "checkpoint_GlueStick_MD.tar")
        if sd is None:
            self.net = load_torch_state_dict(
                init_params(options.get("seed", 0)))
        else:
            self.net = load_torch_state_dict(sd, options.get("key_map"))
        self.net = self.net.to(self.device).eval()
        self.match_threshold = options.get("match_threshold", 0.2)

    def get_module_name(self):
        return "gluestick"

    def _encode(self, descinfo):
        dev = self.device
        juncs = np.asarray(descinfo["junctions"], np.float32)
        h, w = descinfo["image_shape"]
        size = max(int(h), int(w)) * 0.7
        center = np.asarray([w / 2, h / 2], np.float32)
        pos = (juncs - center) / size
        feats = np.concatenate([pos, np.asarray(descinfo["junc_score"])[
            :, None]], axis=1).T
        desc = torch.as_tensor(np.asarray(descinfo["junc_desc"]).T,
                               device=dev).to(torch.float32)
        with torch.no_grad():
            return self.net.encode(desc, torch.as_tensor(
                np.ascontiguousarray(feats, np.float32), device=dev))

    def scores(self, descinfo1, descinfo2) -> torch.Tensor:
        """Line scores [n1, n2]: the endpoints' similarities after the
        GNN, the better of the two orderings."""
        n1, n2 = len(descinfo1["lines"]), len(descinfo2["lines"])
        dev = self.device
        f0, f1 = gluestick_gnn(self.net, self._encode(descinfo1),
                               self._encode(descinfo2),
                               adjacency(n1, dev), adjacency(n2, dev))
        f0 = f0 / (torch.linalg.vector_norm(f0, dim=0, keepdim=True) + 1e-8)
        f1 = f1 / (torch.linalg.vector_norm(f1, dim=0, keepdim=True) + 1e-8)
        s = (f0.T @ f1).reshape(n1, 2, n2, 2)
        fwd = 0.5 * (s[:, 0, :, 0] + s[:, 1, :, 1])
        bwd = 0.5 * (s[:, 0, :, 1] + s[:, 1, :, 0])
        return torch.maximum(fwd, bwd)

    def assignment(self, line_score: torch.Tensor) -> torch.Tensor:
        """The log assignment of the OT (kernel R on the card)."""
        return log_sinkhorn((line_score * 10.0).contiguous(),
                            float(self.net.p("bin_score")), OT_ITERS)

    def match_pair(self, descinfo1, descinfo2):
        n1, n2 = len(descinfo1["lines"]), len(descinfo2["lines"])
        if n1 == 0 or n2 == 0:
            return np.zeros((0, 2), int)
        Z = self.assignment(self.scores(descinfo1, descinfo2))
        return matches_from_assignment(Z, self.match_threshold)


def matches_from_assignment(Z: torch.Tensor, threshold: float) -> np.ndarray:
    """Mutual best entries of exp(Z) without the dustbins, above
    ``threshold``: [M, 2]."""
    P = torch.exp(Z[:-1, :-1])
    i1 = torch.arange(P.shape[0], device=P.device)
    best = torch.argmax(P, dim=1)
    keep = (torch.argmax(P, dim=0)[best] == i1) & (P[i1, best] > threshold)
    ids1 = torch.nonzero(keep, as_tuple=True)[0]
    return torch.stack([ids1, best[ids1]], 1).cpu().numpy()
