"""2D point features: SuperPoint, the classical Harris-patch extractor,
SuperGlue, and matching (mutual nearest neighbours, Sinkhorn optimal
transport on kernel R)."""

from limap_tpu_torch.point2d.matching import (log_sinkhorn, mutual_nn_match,
                                              sinkhorn_match)
from limap_tpu_torch.point2d.superpoint import HarrisPatchExtractor, SuperPoint

__all__ = ["log_sinkhorn", "mutual_nn_match", "sinkhorn_match",
           "HarrisPatchExtractor", "SuperPoint"]
