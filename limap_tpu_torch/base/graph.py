"""Feature-track graph: patch nodes, scored undirected edges and track
labels by union-find, on the host (the batched stages label tracks with
:mod:`limap_tpu_torch.ops.connected_components`)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from limap_tpu_torch.ops.hostops import union_find as union_find_numpy


class PatchNode:
    """(image_idx, line_idx) node."""

    def __init__(self, image_idx: int, line_idx: int, node_idx: int = -1):
        self.image_idx = image_idx
        self.line_idx = line_idx
        self.node_idx = node_idx
        self.out_edges: List[int] = []
        self.in_edges: List[int] = []


class Edge:
    def __init__(self, node_idx1: int, node_idx2: int, sim: float):
        self.node_idx1 = node_idx1
        self.node_idx2 = node_idx2
        self.sim = sim


class Graph:
    """Undirected scored graph with track computation."""

    def __init__(self):
        self.nodes: List[PatchNode] = []
        self.node_map: Dict[Tuple[int, int], int] = {}
        self.undirected_edges: List[Edge] = []

    def FindOrCreateNode(self, image_idx: int, line_idx: int) -> PatchNode:
        key = (image_idx, line_idx)
        if key not in self.node_map:
            node = PatchNode(image_idx, line_idx, len(self.nodes))
            self.node_map[key] = len(self.nodes)
            self.nodes.append(node)
        return self.nodes[self.node_map[key]]

    def GetNodeID(self, image_idx: int, line_idx: int) -> int:
        return self.node_map.get((image_idx, line_idx), -1)

    def AddEdge(self, node1: PatchNode, node2: PatchNode,
                sim: float = 1.0) -> None:
        e = Edge(node1.node_idx, node2.node_idx, sim)
        node1.out_edges.append(len(self.undirected_edges))
        node2.in_edges.append(len(self.undirected_edges))
        self.undirected_edges.append(e)

    def Clear(self) -> None:
        self.nodes.clear()
        self.node_map.clear()
        self.undirected_edges.clear()


def compute_track_labels(graph: Graph) -> np.ndarray:
    """Track labels [n]: the connected components of the edges (every
    edge merges), numbered in node order; a node without an edge gets
    -1."""
    n = len(graph.nodes)
    edges = np.asarray([[e.node_idx1, e.node_idx2]
                        for e in graph.undirected_edges]).reshape(-1, 2)
    roots = union_find_numpy(n, edges)
    labels = np.full(n, -1, np.int64)
    deg = np.zeros(n, np.int64)
    if len(edges):
        np.add.at(deg, edges.reshape(-1), 1)
    next_label = 0
    root_label: Dict[int, int] = {}
    for i in range(n):
        if deg[i] == 0:
            continue
        r = int(roots[i])
        if r not in root_label:
            root_label[r] = next_label
            next_label += 1
        labels[i] = root_label[r]
    return labels


def union_find_get_root(node_idx: int, parent_nodes: List[int]) -> int:
    """The root of ``node_idx`` in a parent list (-1 at a root)."""
    while parent_nodes[node_idx] != -1:
        node_idx = parent_nodes[node_idx]
    return node_idx
