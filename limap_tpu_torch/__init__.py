"""limap_tpu_torch — the PyTorch/CUDA port of limap_tpu.

The JAX package ``limap_tpu`` is the reference; this package mirrors its
module paths and public names so each counterpart is easy to find.  It
imports torch, numpy and scipy only.

Device policy: every entry point takes ``device=None``, which means
``cuda``.  Without a GPU an entry point raises unless the caller passes
``device="cpu"`` explicitly; nothing falls back to the CPU quietly.

Precision policy: everything is fp32, and TF32 is off for matrix
products and convolutions (the covariance einsum of the aggregator and
the LM normal equations are full fp32 in the reference).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
