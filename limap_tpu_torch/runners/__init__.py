"""Pipelines: the stage functions, the line-triangulation runner and the
hybrid localization runner."""

from limap_tpu_torch.runners.hybrid_localization import hybrid_localization
from limap_tpu_torch.runners.line_triangulation import line_triangulation

__all__ = ["hybrid_localization", "line_triangulation"]
