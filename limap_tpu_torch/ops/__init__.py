"""Graph ops, host bucketing and the hand-written CUDA kernels."""

from limap_tpu_torch.ops import connected_components
from limap_tpu_torch.ops.connected_components import compact_labels

__all__ = ["connected_components", "compact_labels"]
