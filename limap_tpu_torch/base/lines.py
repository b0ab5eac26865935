"""Batched 2D/3D segments as a NamedTuple of tensors."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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

    @property
    def dim(self) -> int:
        return self.start.shape[-1]

    def length(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.end - self.start, dim=-1)

    def midpoint(self) -> torch.Tensor:
        return 0.5 * (self.start + self.end)

    def direction(self) -> torch.Tensor:
        d = self.end - self.start
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + EPS)

    def perp_direction(self) -> torch.Tensor:
        """2D only: the direction turned by -90 deg."""
        d = self.direction()
        return torch.stack([d[..., 1], -d[..., 0]], dim=-1)

    def point_projection(self, p: torch.Tensor) -> torch.Tensor:
        """The point(s) of the segment nearest to ``p``."""
        d = self.direction()
        t = torch.sum((p - self.start) * d, dim=-1)
        t = torch.minimum(torch.clamp(t, min=0.0), self.length())
        return self.start + t[..., None] * d

    def point_distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(p - self.point_projection(p), dim=-1)

    def as_array(self) -> torch.Tensor:
        """[..., 2, D] endpoints."""
        return torch.stack([self.start, self.end], dim=-2)

    def as_flat(self) -> torch.Tensor:
        """[..., 2 D] rows (x1 y1 [z1] x2 y2 [z2])."""
        return torch.cat([self.start, self.end], dim=-1)

    def select(self, idx) -> "Segments":
        """A subset or reordering along the leading axis."""
        return Segments(*(None if x is None else x[idx] for x in self))

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

    @classmethod
    def from_flat(cls, arr: torch.Tensor, score=None, depths=None,
                  uncertainty=None) -> "Segments":
        """From [..., 4] (2D), [..., 5] (2D and a score column) or
        [..., >= 6] (3D) flat rows."""
        n = arr.shape[-1]
        if n not in (4, 5) and n < 6:
            raise ValueError(f"bad segment array width {n}")
        d = 2 if n in (4, 5) else 3
        if n == 5 and score is None:
            score = arr[..., 4]
        return cls(arr[..., :d], arr[..., d:2 * d], score, depths,
                   uncertainty)


def segments2d_from_numpy(segs: np.ndarray, device=None) -> Segments:
    """Segments from an (N, 4) or (N, 5) detection array, on ``device``
    (``None`` means cuda)."""
    from limap_tpu_torch import resolve_device
    segs = np.asarray(segs, dtype=np.float32)
    if segs.ndim != 2 or segs.shape[-1] not in (4, 5):
        raise ValueError(f"expected (N,4|5) array, got {segs.shape}")
    return Segments.from_flat(torch.as_tensor(
        segs, device=resolve_device(device)))


def pad_segments(segs: Segments, n: int, fill: float = 0.0):
    """Pad along the leading axis to length ``n``: (padded segments,
    [n] mask, True on the real entries)."""
    cur = segs.start.shape[0]
    if cur > n:
        raise ValueError(f"cannot pad {cur} segments down to {n}")

    def pad(x):
        if x is None:
            return None
        tail = torch.full((n - cur,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    mask = torch.arange(n, device=segs.start.device) < cur
    return Segments(*(pad(x) for x in segs)), mask
