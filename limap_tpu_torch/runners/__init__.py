"""Pipelines: the stage functions and the line-triangulation runner."""

from limap_tpu_torch.runners.line_triangulation import line_triangulation

__all__ = ["line_triangulation"]
