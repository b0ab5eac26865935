"""SuperGlue attentional-GNN matcher.

The keypoint MLP encoder, 18 self/cross attentional layers (256-D, 4
heads), the final projection and the log-domain optimal-transport head
with a learned dustbin score.  Parameters are a flat dict of tensors
keyed by the published ``state_dict`` names, in the published shapes
(Conv1d kernels [out, in, 1]); the loader is strict: it checks the exact
key set and shapes of ``superglue_indoor.pth`` / ``superglue_outdoor.pth``
before accepting a file.  The attention is written out as
softmax(Q K^T / sqrt(d)) V with matrix products; the optimal transport
runs on kernel R (``ops/log_sinkhorn.py``).

Layout: descriptors are [D, N] (channel-major, as Conv1d), one pair, no
batch dimension.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.ops.log_sinkhorn import log_sinkhorn

DESCRIPTOR_DIM = 256
KEYPOINT_ENCODER = [32, 64, 128, 256]
GNN_LAYERS = ["self", "cross"] * 9
SINKHORN_ITERATIONS = 100
MATCH_THRESHOLD = 0.2
HEADS = 4
_BN_EPS = 1e-5


# --------------------------------------------------------------- params
def _mlp_key_spec(prefix: str, channels: List[int]) -> Dict[str, tuple]:
    """state_dict keys and shapes of the reference's ``MLP(channels)``:
    Conv1d(k=1) + BatchNorm1d + ReLU a hidden layer, a bare Conv1d last."""
    spec = {}
    idx = 0
    n = len(channels)
    for i in range(1, n):
        spec[f"{prefix}.{idx}.weight"] = (channels[i], channels[i - 1], 1)
        spec[f"{prefix}.{idx}.bias"] = (channels[i],)
        idx += 1
        if i < n - 1:
            for suffix in ("weight", "bias", "running_mean", "running_var"):
                spec[f"{prefix}.{idx}.{suffix}"] = (channels[i],)
            idx += 2  # BatchNorm1d + ReLU
    return spec


def key_spec() -> Dict[str, tuple]:
    """The exact key -> shape map of the published checkpoints."""
    d = DESCRIPTOR_DIM
    spec = {"bin_score": ()}
    spec.update(_mlp_key_spec("kenc.encoder", [3] + KEYPOINT_ENCODER + [d]))
    for li in range(len(GNN_LAYERS)):
        p = f"gnn.layers.{li}"
        spec[f"{p}.attn.merge.weight"] = (d, d, 1)
        spec[f"{p}.attn.merge.bias"] = (d,)
        for j in range(3):
            spec[f"{p}.attn.proj.{j}.weight"] = (d, d, 1)
            spec[f"{p}.attn.proj.{j}.bias"] = (d,)
        spec.update(_mlp_key_spec(f"{p}.mlp", [d * 2, d * 2, d]))
    spec["final_proj.weight"] = (d, d, 1)
    spec["final_proj.bias"] = (d,)
    return spec


def params_from_state_dict(sd, device="cpu") -> Dict[str, torch.Tensor]:
    """A ``state_dict`` (tensors or arrays) as float32 tensors on
    ``device``, after checking its keys and shapes strictly against
    :func:`key_spec` (``num_batches_tracked`` entries are dropped)."""
    arrays = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                  else torch.as_tensor(np.asarray(v)))
              for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    spec = key_spec()
    missing = sorted(set(spec) - set(arrays))
    unexpected = sorted(set(arrays) - set(spec))
    if missing or unexpected:
        raise ValueError(
            f"SuperGlue checkpoint key mismatch: missing={missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}, "
            f"unexpected={unexpected[:5]}"
            f"{'...' if len(unexpected) > 5 else ''}")
    params = {}
    for k, shape in spec.items():
        a = arrays[k]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"SuperGlue param {k}: shape {tuple(a.shape)} "
                             f"!= checkpoint spec {shape}")
        params[k] = a.to(device=device, dtype=torch.float32)
    return params


def load_checkpoint(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """A published ``superglue_*.pth`` file, strictly checked."""
    return params_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), device)


def random_params(seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """Random parameters with the checkpoint's keys and shapes, the
    reference's draws (numpy's generator, unit-normal kernels, zero
    biases, identity batch norms, dustbin score 1)."""
    rng = np.random.default_rng(seed)
    params = {}
    for k, shape in key_spec().items():
        if k.endswith("running_mean"):
            a = np.zeros(shape, np.float32)
        elif k.endswith("running_var"):
            a = np.ones(shape, np.float32)
        elif k == "bin_score":
            a = np.asarray(1.0, np.float32)
        elif k.endswith("bias"):
            a = np.zeros(shape, np.float32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
            a *= 1.0 / np.sqrt(max(shape[-1] if len(shape) > 1 else 1, 1))
        params[k] = torch.as_tensor(a, device=device)
    return params


# -------------------------------------------------------------- forward
def _conv(p, prefix, x):
    return p[f"{prefix}.weight"][:, :, 0] @ x + p[f"{prefix}.bias"][:, None]


def _mlp(p, prefix, channels, x):
    idx = 0
    n = len(channels)
    for i in range(1, n):
        x = _conv(p, f"{prefix}.{idx}", x)
        idx += 1
        if i < n - 1:
            g = p[f"{prefix}.{idx}.weight"][:, None]
            b = p[f"{prefix}.{idx}.bias"][:, None]
            m = p[f"{prefix}.{idx}.running_mean"][:, None]
            v = p[f"{prefix}.{idx}.running_var"][:, None]
            x = (x - m) * torch.rsqrt(v + _BN_EPS) * g + b
            idx += 2
            x = torch.relu(x)
    return x


def normalize_keypoints(kpts: torch.Tensor, height, width) -> torch.Tensor:
    """Keypoints [N, 2] relative to the image centre, over 0.7 times the
    longer side."""
    size = torch.stack([torch.as_tensor(width), torch.as_tensor(height)]).to(
        device=kpts.device, dtype=torch.float32)
    center = size / 2
    scaling = torch.max(size) * 0.7
    return (kpts - center[None, :]) / scaling


def _attention_layer(p, prefix, x, source):
    """AttentionalPropagation: a 4-head attention message, merged, then
    an MLP over [x ; message].  Channel c of a projection is (c // heads,
    c % heads) = (dim, head), as the reference's view."""
    d = x.shape[0]
    dh = d // HEADS
    q = _conv(p, f"{prefix}.attn.proj.0", x).reshape(dh, HEADS, -1)
    k = _conv(p, f"{prefix}.attn.proj.1", source).reshape(dh, HEADS, -1)
    v = _conv(p, f"{prefix}.attn.proj.2", source).reshape(dh, HEADS, -1)
    scores = torch.matmul(q.permute(1, 2, 0), k.permute(1, 0, 2)) / dh ** 0.5
    prob = torch.softmax(scores, dim=-1)                       # [h, n, m]
    msg = torch.matmul(prob, v.permute(1, 2, 0))                # [h, n, dh]
    msg = _conv(p, f"{prefix}.attn.merge",
                msg.permute(2, 0, 1).reshape(d, -1))
    return _mlp(p, f"{prefix}.mlp", [d * 2, d * 2, d],
                torch.cat([x, msg], dim=0))


def _forward_scores(params, kpts0, scores0, desc0, kpts1, scores1, desc1,
                    shape0, shape1) -> torch.Tensor:
    """Encoder + GNN + final projection -> the raw score matrix [N0, N1]
    (before the optimal transport)."""
    kenc_channels = [3] + KEYPOINT_ENCODER + [DESCRIPTOR_DIM]
    kn0 = normalize_keypoints(kpts0, shape0[0], shape0[1])
    kn1 = normalize_keypoints(kpts1, shape1[0], shape1[1])
    inp0 = torch.cat([kn0.T, scores0[None, :]], dim=0)
    inp1 = torch.cat([kn1.T, scores1[None, :]], dim=0)
    desc0 = desc0 + _mlp(params, "kenc.encoder", kenc_channels, inp0)
    desc1 = desc1 + _mlp(params, "kenc.encoder", kenc_channels, inp1)
    for li, name in enumerate(GNN_LAYERS):
        src0, src1 = (desc1, desc0) if name == "cross" else (desc0, desc1)
        delta0 = _attention_layer(params, f"gnn.layers.{li}", desc0, src0)
        delta1 = _attention_layer(params, f"gnn.layers.{li}", desc1, src1)
        desc0 = desc0 + delta0
        desc1 = desc1 + delta1
    mdesc0 = _conv(params, "final_proj", desc0)
    mdesc1 = _conv(params, "final_proj", desc1)
    return (mdesc0.T @ mdesc1) / DESCRIPTOR_DIM ** 0.5


def solve_optimal_transport(scores: torch.Tensor, bin_score,
                            iters: int = SINKHORN_ITERATIONS) -> torch.Tensor:
    """Log-domain OT with dustbins on kernel R: [M+1, N+1]."""
    return log_sinkhorn(scores.to(torch.float32).contiguous(),
                        float(bin_score), iters)


def get_matches(Z, match_threshold: float = MATCH_THRESHOLD):
    """Mutual max and threshold on the OT output [M+1, N+1] (host):
    (matches0, matches1, mscores0, mscores1)."""
    Z = Z.cpu().numpy() if isinstance(Z, torch.Tensor) else np.asarray(Z)
    inner = Z[:-1, :-1]
    m0 = inner.argmax(1)
    m1 = inner.argmax(0)
    max0 = inner.max(1)
    n0, n1 = inner.shape
    mutual0 = np.arange(n0) == m1[m0]
    mutual1 = np.arange(n1) == m0[m1]
    mscores0 = np.where(mutual0, np.exp(max0), 0.0)
    mscores1 = np.where(mutual1, mscores0[m1], 0.0)
    valid0 = mutual0 & (mscores0 > match_threshold)
    valid1 = mutual1 & valid0[m1]
    return (np.where(valid0, m0, -1), np.where(valid1, m1, -1),
            mscores0, mscores1)


class SuperGlue:
    """Pair matcher on ``device`` (None means cuda).  ``weight_path``: a
    published ``superglue_*.pth`` (strictly checked); None -> the
    reference's random parameters (smoke and parity use only)."""

    def __init__(self, weight_path: Optional[str] = None,
                 match_threshold: float = MATCH_THRESHOLD,
                 sinkhorn_iterations: int = SINKHORN_ITERATIONS,
                 device=None):
        self.device = resolve_device(device)
        self.params = (load_checkpoint(weight_path, self.device)
                       if weight_path is not None
                       else random_params(device=self.device))
        self.match_threshold = match_threshold
        self.sinkhorn_iterations = sinkhorn_iterations

    def scores(self, data: dict) -> torch.Tensor:
        """The raw (pre-OT) score matrix [N0, N1] on the device."""
        t = lambda k: torch.as_tensor(np.asarray(data[k], np.float32),
                                      device=self.device)
        with torch.no_grad():
            return _forward_scores(
                self.params, t("keypoints0"), t("scores0"), t("descriptors0"),
                t("keypoints1"), t("scores1"), t("descriptors1"),
                t("image_shape0"), t("image_shape1"))

    def solve_optimal_transport(self, scores) -> torch.Tensor:
        return solve_optimal_transport(scores, self.params["bin_score"],
                                       self.sinkhorn_iterations)

    def __call__(self, data: dict) -> dict:
        n0 = np.asarray(data["keypoints0"]).shape[0]
        n1 = np.asarray(data["keypoints1"]).shape[0]
        if n0 == 0 or n1 == 0:
            return {"matches0": np.full(n0, -1, np.int32),
                    "matches1": np.full(n1, -1, np.int32),
                    "matching_scores0": np.zeros(n0),
                    "matching_scores1": np.zeros(n1),
                    "scores": np.zeros((n0, n1))}
        raw = self.scores(data)
        Z = self.solve_optimal_transport(raw)
        m0, m1, ms0, ms1 = get_matches(Z, self.match_threshold)
        return {"matches0": m0, "matches1": m1, "matching_scores0": ms0,
                "matching_scores1": ms1, "scores": raw.cpu().numpy()}
