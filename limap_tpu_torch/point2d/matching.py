"""Point matching: mutual nearest neighbours and Sinkhorn optimal
transport with dustbins.

The optimal-transport solver is the one the reference exposes from its
vendored SuperGlue; the endpoint line matchers reuse it.  It runs on
kernel R (``ops/log_sinkhorn.py``): the whole fixed-iteration solve in
one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.ops.log_sinkhorn import log_sinkhorn as _log_sinkhorn


def log_sinkhorn(scores, bin_score, iters: int = 50,
                 device=None) -> torch.Tensor:
    """Log-domain Sinkhorn with dustbins (SuperGlue's
    _solve_optimal_transport).

    scores: [M, N] similarity matrix (a tensor stays on its device;
    anything else goes to ``device``, where None means cuda).  Returns
    the log assignment [M+1, N+1] f32: the coupling plus the potentials
    minus the norm -log(M + N), with the reference's marginals (every
    point 1 / (M + N), the dustbins N / (M + N) and M / (M + N)).
    """
    if isinstance(scores, torch.Tensor) and device is None:
        t = scores.to(torch.float32)
    else:
        t = torch.as_tensor(np.asarray(scores, np.float32),
                            device=resolve_device(device))
    return _log_sinkhorn(t, float(bin_score), iters)


def mutual_nn_match(desc1: np.ndarray, desc2: np.ndarray,
                    min_score: float = 0.7) -> np.ndarray:
    """[M, 2] index pairs that are each other's best match by the dot
    product of L2-normalized descriptors, with score >= ``min_score``
    (the first index on ties)."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros((0, 2), np.int64)
    return mutual_argmax_matches(np.asarray(desc1) @ np.asarray(desc2).T,
                                 min_score)


def mutual_argmax_matches(P: np.ndarray, threshold: float) -> np.ndarray:
    """[K, 2] pairs (i, j) where j is row i's first argmax, i is column
    j's, and P[i, j] >= ``threshold``."""
    b2 = P.argmax(1)
    b1 = P.argmax(0)
    i = np.arange(P.shape[0])
    good = (b1[b2] == i) & (P[i, b2] >= threshold)
    return np.stack([i[good], b2[good]], axis=1)


def sinkhorn_match(desc1: np.ndarray, desc2: np.ndarray,
                   bin_score: float = 0.5, match_threshold: float = 0.2,
                   iters: int = 50, temperature: float = 0.1,
                   device=None) -> np.ndarray:
    """OT-based matching with dustbins (SuperGlue-style selection) of
    descriptors [M, D] and [N, D]: the cosine similarities over
    ``temperature`` (on the host, in the descriptors' precision, as the
    reference) through :func:`log_sinkhorn`, then mutual argmax of the
    assignment probabilities above ``match_threshold``.  Returns [K, 2]
    index pairs."""
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros((0, 2), np.int64)
    scores = np.asarray(desc1) @ np.asarray(desc2).T / temperature
    Z = log_sinkhorn(scores, bin_score, iters, device=device)
    P = np.exp(Z[:-1, :-1].cpu().numpy())
    return mutual_argmax_matches(P, match_threshold)
