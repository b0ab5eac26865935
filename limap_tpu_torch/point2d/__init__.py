"""2D point features: the classical Harris-patch extractor and mutual
nearest-neighbour matching (SuperPoint, SuperGlue and the Sinkhorn
matcher are not ported yet: ROADMAP.md queue 1 item 14)."""

from limap_tpu_torch.point2d.matching import mutual_nn_match
from limap_tpu_torch.point2d.superpoint import HarrisPatchExtractor

__all__ = ["mutual_nn_match", "HarrisPatchExtractor"]
