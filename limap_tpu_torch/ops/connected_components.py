"""Connected components by min-label hooking and pointer jumping.

The reference's default "greedy" track strategy merges across every edge,
so its partition is the connected components of the edge graph.  Each
label is the minimum node id of its component.
"""

from __future__ import annotations

import torch


def connected_components(n_nodes: int, edges: torch.Tensor,
                         edge_mask: torch.Tensor) -> torch.Tensor:
    """Labels [n_nodes] int32 for edges [E, 2] where ``edge_mask`` [E].

    Alternates a scatter-min hook across edges with full pointer jumping
    until nothing changes (O(log n) rounds in practice).
    """
    device = edges.device
    labels = torch.arange(n_nodes, dtype=torch.int64, device=device)
    u = edges[:, 0].long()[edge_mask]
    v = edges[:, 1].long()[edge_mask]
    if u.numel() == 0:
        return labels.to(torch.int32)
    n_jumps = max(int(n_nodes).bit_length(), 1)
    while True:
        lu, lv = labels[u], labels[v]
        lmin = torch.minimum(lu, lv)
        # parent[label] <- min label over all its edges
        new = labels.clone()
        new.scatter_reduce_(0, lu, lmin, reduce="amin", include_self=True)
        new.scatter_reduce_(0, lv, lmin, reduce="amin", include_self=True)
        for _ in range(n_jumps):
            new = new[new]
        if torch.equal(new, labels):
            return labels.to(torch.int32)
        labels = new


def compact_labels(labels: torch.Tensor, node_mask=None):
    """Dense component ids in [0, n_comp) (masked nodes -1) and n_comp."""
    n = labels.shape[0]
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=labels.device)
    is_root = (labels == torch.arange(n, device=labels.device)) & node_mask
    dense_of_root = torch.cumsum(is_root.to(torch.int32), 0) - 1
    dense = torch.where(node_mask, dense_of_root[labels.long()],
                        torch.full_like(dense_of_root, -1))
    return dense, int(is_root.sum())


def union_find_numpy(n_nodes, edges):
    """Host union-find: the root label (the least node id of its
    component) of each of ``n_nodes`` nodes under ``edges`` [E, 2]."""
    from limap_tpu_torch.ops.hostops import union_find
    return union_find(n_nodes, edges)
