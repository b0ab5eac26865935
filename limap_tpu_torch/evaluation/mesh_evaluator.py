"""Distance of a line map to a ground-truth triangle mesh.

Each line is sampled at ``n_samples`` points and each sample's distance
to the nearest triangle comes from
:func:`~limap_tpu_torch.ops.mesh_distance.mesh_min_dist` (kernel N for a
mesh on the GPU, the plain chunked scan on the CPU).  The mesh is given
as arrays, vertices [V, 3] and faces [M, 3], so no mesh package is
needed.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.evaluation.evaluator import (DEFAULT_N_SAMPLES,
                                                  sample_points_on_segments)
from limap_tpu_torch.ops.mesh_distance import (mesh_min_dist,
                                               point_triangle_distance)

__all__ = ["MeshEvaluator", "point_triangle_distance"]


class MeshEvaluator:
    """Distance evaluation against a GT mesh (vertices [V, 3], faces
    [M, 3] vertex indices)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, device=None):
        self.device = resolve_device(device)
        v = np.asarray(vertices, np.float32)
        f = np.asarray(faces, np.int64).reshape(-1, 3)
        self.tris = torch.as_tensor(v[f], device=self.device).contiguous()

    def ComputeDistPoint(self, p) -> float:
        """Distance of one point [3] to the mesh."""
        q = torch.as_tensor(np.asarray(p, np.float32).reshape(1, 3),
                            device=self.device)
        return float(mesh_min_dist(q, self.tris)[0])

    def ComputeDistsLine(self, seg: Segments,
                         n_samples: int = DEFAULT_N_SAMPLES) -> torch.Tensor:
        """[N, n_samples] sample distances of a batch of lines."""
        samples = sample_points_on_segments(seg, n_samples)
        d = mesh_min_dist(samples.reshape(-1, 3).contiguous(), self.tris)
        return d.reshape(samples.shape[:-1])

    def ComputeInlierRatio(self, seg: Segments, threshold: float,
                           n_samples: int = DEFAULT_N_SAMPLES) -> torch.Tensor:
        """Per-line fraction of samples within ``threshold``."""
        d = self.ComputeDistsLine(seg, n_samples)
        return torch.mean((d <= threshold).to(torch.float32), dim=1)
