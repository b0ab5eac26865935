"""2D segment merging (``do_merge_lines``).

Merges collinear nearby segments: broadcast line distances over all
pairs propose merge edges, union-find groups them, and each group is
re-fit by its principal direction with the extreme projections as
endpoints.  Runs on the CPU: a detector's few hundred segments.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.hostops import group_by_labels, union_find


def merge_lines(segs: np.ndarray,
                th_angle: float = 4.0,
                th_perp: float = 3.0,
                th_gap: float = 20.0) -> np.ndarray:
    """Merge near-collinear 2D segments; segs (N, >=4) -> (M, 4).

    Two segments merge when their directions agree within ``th_angle``
    degrees, mutual perpendicular distance is below ``th_perp`` px, and
    the along-line gap is below ``th_gap`` px.
    """
    segs = np.asarray(segs, np.float64)
    n = len(segs)
    if n <= 1:
        return segs[:, :4]
    seg = Segments(torch.as_tensor(segs[:, :2], dtype=torch.float32),
                   torch.as_tensor(segs[:, 2:4], dtype=torch.float32))
    a = Segments(seg.start[:, None], seg.end[:, None])
    b = Segments(seg.start[None, :], seg.end[None, :])
    ang_ok = ld.angle(a, b) <= th_angle
    perp_ok = ld.dist_endpoints_perpendicular_oneway(a, b) <= th_perp
    gap_ok = ld.dist_minpoint(a, b) <= th_gap
    ok = (ang_ok & perp_ok & gap_ok).numpy().copy()
    np.fill_diagonal(ok, False)
    edges = np.argwhere(np.triu(ok & ok.T, k=1))

    labels = union_find(n, edges.reshape(-1, 2))
    ids, offsets = group_by_labels(labels, np.ones(n, bool))
    out = []
    endpoints = segs[:, :4].reshape(n, 2, 2)
    for g in range(len(offsets) - 1):
        members = ids[offsets[g]:offsets[g + 1]]
        pts = endpoints[members].reshape(-1, 2)
        if len(members) == 1:
            out.append(segs[members[0], :4])
            continue
        center = pts.mean(0)
        u, _, _ = np.linalg.svd((pts - center).T @ (pts - center))
        d = u[:, 0]
        t = (pts - center) @ d
        out.append(np.concatenate([center + t.min() * d,
                                   center + t.max() * d]))
    return np.stack(out)
