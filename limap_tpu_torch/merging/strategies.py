"""The "exhaustive" and "avg" track-label strategies.

The default "greedy" strategy is order-independent (connected
components, on the device).  These two test a candidate merge with the
3D linker (``to_avgtest_merging``) before they accept it, so they are
order-dependent Kruskal variants over the edges sorted by score: host
union-find loops, with each merge's linker test evaluated in one batch
of fp32 torch ops on the CPU.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base.line_linker import LineLinker3dConfig, check_3d
from limap_tpu_torch.base.lines import Segments


def _find(parent: List[int], x: int) -> int:
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def compute_track_labels_avg(edges: np.ndarray, scores: np.ndarray,
                             node_lines: np.ndarray, image_idx: np.ndarray,
                             linker3d: LineLinker3dConfig) -> np.ndarray:
    """Merge two unions only if their running average lines (float64)
    pass the avgtest linker.  ``edges`` [E, 2] node pairs, ``scores``
    [E], ``node_lines`` [n, 2, 3]; labels [n], -1 for singletons."""
    cfg = linker3d.to_avgtest_merging()
    n = len(node_lines)
    parent = list(range(n))
    avg = {i: (np.asarray(node_lines[i], np.float64), 1) for i in range(n)}
    size = {i: 1 for i in range(n)}

    def linker_ok(l1, l2):
        a = Segments(_f32(l1[0])[None], _f32(l1[1])[None])
        b = Segments(_f32(l2[0])[None], _f32(l2[1])[None])
        return bool(check_3d(a, b, cfg)[0])

    for e in np.argsort(-np.asarray(scores), kind="stable"):
        ra, rb = _find(parent, int(edges[e][0])), _find(parent, int(edges[e][1]))
        if ra == rb:
            continue
        (la, ca), (lb, cb) = avg[ra], avg[rb]
        if not linker_ok(la, lb):
            continue
        if size[ra] < size[rb]:
            ra, rb, la, ca, lb, cb = rb, ra, lb, cb, la, ca
        parent[rb] = ra
        avg[ra] = ((la * ca + lb * cb) / (ca + cb), ca + cb)
        size[ra] += size[rb]
    return _labels_from_parents(parent)


def compute_track_labels_exhaustive(edges: np.ndarray, scores: np.ndarray,
                                    node_lines: np.ndarray,
                                    image_idx: np.ndarray,
                                    linker3d: LineLinker3dConfig
                                    ) -> np.ndarray:
    """Merge two unions only if every overlapping pair of lines across
    them passes the avgtest linker; arguments as
    :func:`compute_track_labels_avg`."""
    cfg = linker3d.to_avgtest_merging()
    n = len(node_lines)
    parent = list(range(n))
    members = {i: [i] for i in range(n)}
    start, end = _f32(np.asarray(node_lines)[:, 0]), \
        _f32(np.asarray(node_lines)[:, 1])
    for e in np.argsort(-np.asarray(scores), kind="stable"):
        ra, rb = _find(parent, int(edges[e][0])), _find(parent, int(edges[e][1]))
        if ra == rb:
            continue
        ia = torch.as_tensor(members[ra])
        ib = torch.as_tensor(members[rb])
        la = Segments(start[ia][:, None], end[ia][:, None])
        lb = Segments(start[ib][None, :], end[ib][None, :])
        if bool(((ld.compute_overlap(la, lb) > 0)
                 & ~check_3d(la, lb, cfg)).any()):
            continue
        if len(members[ra]) < len(members[rb]):
            ra, rb = rb, ra
        parent[rb] = ra
        members[ra] = members[ra] + members.pop(rb)
    return _labels_from_parents(parent)


def _labels_from_parents(parent: List[int]) -> np.ndarray:
    """Labels 0.. in order of first appearance for components of >= 2
    nodes; -1 for singletons."""
    n = len(parent)
    roots = np.asarray([_find(parent, i) for i in range(n)], np.int64)
    counts = np.bincount(roots, minlength=n)
    labels = np.full(n, -1, np.int64)
    root_map = {}
    for i in range(n):
        r = int(roots[i])
        if counts[r] >= 2:
            labels[i] = root_map.setdefault(r, len(root_map))
    return labels
