"""Endpoint aggregation: the supports of a track -> one segment.

Tracks with >= 4 supports take the total-least-squares direction of the
endpoint scatter (the principal eigenvector of a 3x3 covariance) and
trimmed extreme projections; smaller tracks take the best-scored support.
"""

from __future__ import annotations

import torch

from limap_tpu_torch.base.lines import EPS, Segments

_BIG = 1e30
EIGH_CHUNK = 16384


def principal_direction(points: torch.Tensor, mask: torch.Tensor,
                        center: torch.Tensor = None):
    """Principal axis of masked points [..., P, 3] -> (unit [..., 3],
    center [..., 3]).  The sign of the axis is not fixed."""
    m = mask[..., None].to(points.dtype)
    cnt = torch.sum(m, dim=-2)
    if center is None:
        center = torch.sum(points * m, dim=-2) / torch.clamp(cnt, min=1.0)
    centered = (points - center[..., None, :]) * m
    cov = torch.einsum("...pi,...pj->...ij", centered, centered)
    # ascending eigenvalues: the principal axis is the last column.  The
    # card's batched eigensolver refuses 32768 matrices or more at once
    flat = cov.reshape(-1, 3, 3)
    direc = torch.cat([torch.linalg.eigh(flat[k:k + EIGH_CHUNK]).eigenvectors
                       [..., :, 2] for k in range(0, max(len(flat), 1),
                                                  EIGH_CHUNK)])
    direc = direc.reshape(cov.shape[:-1])
    return direc / (torch.linalg.vector_norm(direc, dim=-1, keepdim=True)
                    + EPS), center


def aggregate_tracks(line3d: Segments, scores: torch.Tensor,
                     mask: torch.Tensor, num_outliers: int = 2) -> Segments:
    """Supports [T, S] -> representative segments [T]; carries the min
    support uncertainty when ``line3d.uncertainty`` is given."""
    T, S = mask.shape
    cnt = torch.sum(mask, dim=1)
    rows = torch.arange(T, device=mask.device)

    # best-scored support (first on ties)
    best = torch.argmax(torch.where(mask, scores,
                                    torch.full_like(scores, -_BIG)), dim=1)
    best_start = line3d.start[rows, best]
    best_end = line3d.end[rows, best]

    # TLS direction + trimmed extreme projections
    endpoints = torch.cat([line3d.start, line3d.end], dim=1)   # [T, 2S, 3]
    ep_mask = torch.cat([mask, mask], dim=1)
    direc, center = principal_direction(endpoints, ep_mask)
    proj = torch.sum((endpoints - center[:, None]) * direc[:, None], dim=-1)
    lo_sorted = torch.sort(torch.where(ep_mask, proj,
                                       torch.full_like(proj, _BIG)),
                           dim=1).values
    hi_sorted = torch.sort(torch.where(ep_mask, proj,
                                       torch.full_like(proj, -_BIG)),
                           dim=1).values
    k = torch.clamp(torch.clamp((2 * cnt - 1) // 2, min=0),
                    max=max(num_outliers, 0))
    t_lo = torch.gather(lo_sorted, 1, k[:, None])[:, 0]
    t_hi = torch.gather(hi_sorted, 1, (2 * S - 1 - k)[:, None])[:, 0]
    tls_start = center + direc * t_lo[:, None]
    tls_end = center + direc * t_hi[:, None]

    use_tls = (cnt >= 4)[:, None]
    uncertainty = None
    if line3d.uncertainty is not None:
        uncertainty = torch.amin(
            torch.where(mask, line3d.uncertainty,
                        torch.full_like(line3d.uncertainty, _BIG)), dim=1)
    return Segments(start=torch.where(use_tls, tls_start, best_start),
                    end=torch.where(use_tls, tls_end, best_end),
                    uncertainty=uncertainty)
