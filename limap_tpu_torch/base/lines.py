"""Batched 2D/3D segments as a NamedTuple of tensors."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from limap_tpu_torch.base.pose import cross

EPS = 1e-12


class Segments(NamedTuple):
    """Segments with ``start``/``end`` [..., D] and optional ``score``
    [...], ``depths`` [..., 2] and ``uncertainty`` [...]."""

    start: torch.Tensor
    end: torch.Tensor
    score: Optional[torch.Tensor] = None
    depths: Optional[torch.Tensor] = None
    uncertainty: Optional[torch.Tensor] = None

    def length(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.end - self.start, dim=-1)

    def midpoint(self) -> torch.Tensor:
        return 0.5 * (self.start + self.end)

    def direction(self) -> torch.Tensor:
        d = self.end - self.start
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + EPS)

    def coords(self) -> torch.Tensor:
        """2D only: normalized homogeneous line coordinates [..., 3]."""
        one = torch.ones_like(self.start[..., :1])
        c = cross(torch.cat([self.start, one], -1),
                  torch.cat([self.end, one], -1))
        return c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + EPS)

    def expand(self, dim: int) -> "Segments":
        """``unsqueeze(dim)`` of every field; ``dim`` >= 0 is a batch
        axis (the reference's ``_expand``)."""
        return Segments(*(None if x is None else x.unsqueeze(dim)
                          for x in self))
