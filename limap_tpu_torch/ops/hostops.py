"""Host-side numpy ops: bucketing, union-find, grouping, packing."""

from __future__ import annotations

import numpy as np


def union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Root labels (min node id per component) for an edge list."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in np.asarray(edges, np.int64).reshape(-1, 2):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], np.int64)


def group_by_labels(labels: np.ndarray, valid: np.ndarray):
    """(sorted_node_ids, group_offsets) over valid nodes by label."""
    ids = np.nonzero(np.asarray(valid, bool))[0]
    lab = np.asarray(labels, np.int64)[ids]
    order = np.argsort(lab, kind="stable")
    ids, lab = ids[order], lab[order]
    splits = np.nonzero(np.diff(lab))[0] + 1
    offsets = np.concatenate([[0], splits, [len(ids)]]) if len(ids) else \
        np.asarray([0])
    return ids.astype(np.int64), offsets.astype(np.int64)


def pack_supports(sorted_ids: np.ndarray, offsets: np.ndarray, S: int):
    """Pad per-group ids to [G, S] with a mask."""
    G = len(offsets) - 1
    index = np.zeros((G, S), np.int64)
    mask = np.zeros((G, S), bool)
    for g in range(G):
        sel = sorted_ids[offsets[g]:offsets[g + 1]][:S]
        index[g, :len(sel)] = sel
        mask[g, :len(sel)] = True
    return index, mask


def bucket_scene(key: np.ndarray, vals: np.ndarray, n_rows: int, T: int):
    """Stable bucket fill -> (words int32 [n_rows, T] padded with -1,
    overflow count).  Edge i lands at (key[i], running count)."""
    key = np.asarray(key, np.int64)
    vals = np.asarray(vals, np.int32)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.searchsorted(ks, np.arange(n_rows))
    pos = np.arange(len(ks)) - starts[np.clip(ks, 0, n_rows - 1)]
    keep = (ks >= 0) & (ks < n_rows) & (pos < T)
    words = np.full((n_rows, T), -1, np.int32)
    words[ks[keep], pos[keep]] = vals[order][keep]
    overflow = int((np.bincount(ks[(ks >= 0) & (ks < n_rows)],
                                minlength=n_rows) - T).clip(0).sum())
    return words, overflow
