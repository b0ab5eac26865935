"""A network whose parameters are named by a checkpoint's keys.

The learned detectors and descriptors of the zoo are written as
functions of their published state dicts, as the reference package
writes them.  :class:`SpecNet` registers one parameter per
``(key, shape)`` of a spec under the dotted key itself (nested
submodules, so ``state_dict()`` has exactly those keys), and offers the
convolutions the forwards share.  Tensors are channels-first inside;
the public forwards take and return the reference's channels-last
layout.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class SpecNet(nn.Module):
    """Parameters [zeros] for every (key, torch shape) of ``spec``."""

    def __init__(self, spec: Iterable[Tuple[str, tuple]]):
        super().__init__()
        self.spec = list(spec)
        for key, shape in self.spec:
            *path, leaf = key.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(
                torch.zeros(shape), requires_grad=False))

    def p(self, key: str) -> torch.Tensor:
        return self.get_parameter(key)

    def has(self, key: str) -> bool:
        try:
            self.get_parameter(key)
            return True
        except AttributeError:
            return False

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             padding="same") -> torch.Tensor:
        """Conv2d by the parameters ``name.weight`` [O, I, kh, kw] (and
        ``name.bias`` where the spec has one).  ``"same"`` pads k // 2
        (odd kernels, stride 1, as the reference's SAME), ``"valid"``
        nothing, an int or pair that much."""
        w = self.p(name + ".weight")
        b = self.p(name + ".bias") if self.has(name + ".bias") else None
        if padding == "same":
            padding = (w.shape[2] // 2, w.shape[3] // 2)
        elif padding == "valid":
            padding = 0
        if w.shape[2:] == (1, 1) and stride == 1 and padding in (0, (0, 0)):
            # a 1x1 convolution is a matrix product over the channels:
            # cuDNN's fp32 algorithms for one to four output channels
            # launch a matrix-vector product a row (measured on an H100)
            out = torch.matmul(w[:, :, 0, 0], x.flatten(2)).view(
                x.shape[0], w.shape[0], *x.shape[2:])
            return out if b is None else out + b[:, None, None]
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def conv1d(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 Conv1d ``name`` [O, C, 1] on x [..., C, N]."""
        w = self.p(name + ".weight")[..., 0]
        b = self.p(name + ".bias")
        return torch.matmul(w, x) + b[:, None]

    def load_spec_state_dict(self, sd: Dict, what: str,
                             key_map: Optional[Dict[str, str]] = None,
                             verbose: bool = False) -> "SpecNet":
        """Load every spec key from ``sd`` (renamed by ``key_map`` first),
        each with its exact shape; a missing or misshapen entry raises
        with the full list.  Keys beyond the spec are ignored (listed when
        ``verbose``)."""
        if key_map:
            sd = {key_map.get(k, k): v for k, v in sd.items()}
        problems, values = [], {}
        for key, shape in self.spec:
            if key not in sd:
                problems.append(f"missing {key} {shape}")
                continue
            v = torch.as_tensor(np.asarray(sd[key], np.float32))
            if tuple(v.shape) != tuple(shape):
                problems.append(f"{key}: got {tuple(v.shape)}, want {shape}")
                continue
            values[key] = v
        if problems:
            raise ValueError(f"checkpoint does not match the {what} spec:\n"
                             + "\n".join(problems))
        if verbose:
            extra = sorted(k for k in sd if k not in values
                           and "num_batches_tracked" not in k)
            if extra:
                print(f"{what}: ignoring {len(extra)} keys beyond the spec, "
                      f"e.g. {extra[:5]}")
        self.load_state_dict(values)
        return self


def he_normal_state_dict(spec, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's seeded init of the convolutional detectors, draw
    for draw: biases 0, kernels N(0, 2 / fan_in) in the spec's order."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in spec:
        if key.endswith(".bias"):
            v = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0, (2.0 / fan_in) ** 0.5, shape).astype(
                np.float32)
        sd[key] = torch.as_tensor(v)
    return sd


def read_checkpoint(weight_path, *parts) -> Optional[Dict[str, np.ndarray]]:
    """The state dict of a checkpoint file (or of ``parts`` under a
    weights directory), unwrapped from ``{"model": ...}``; None when the
    file is absent."""
    if weight_path is None:
        return None
    ckpt = weight_path
    if os.path.isdir(ckpt):
        ckpt = os.path.join(ckpt, *parts)
    if not os.path.isfile(ckpt):
        return None
    blob = torch.load(ckpt, map_location="cpu", weights_only=False)
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                          else v) for k, v in sd.items()}


def relu(x):
    return torch.clamp_min(x, 0.0)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()
