"""Graph ops, host bucketing and the hand-written CUDA kernels."""

from limap_tpu_torch.ops import connected_components
from limap_tpu_torch.ops.connected_components import (compact_labels,
                                                      count_component_sizes,
                                                      union_find_numpy)

__all__ = ["connected_components", "compact_labels", "count_component_sizes",
           "union_find_numpy"]
