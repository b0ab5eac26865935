"""Point-line bipartite structures."""

from limap_tpu_torch.structures.pl_bipartite import (
    Junction, PL_Bipartite2d, PL_Bipartite2dConfig, PL_Bipartite3d, Point2d,
    PointTrack, compute_2d_bipartites_from_points)

__all__ = ["Junction", "PL_Bipartite2d", "PL_Bipartite2dConfig",
           "PL_Bipartite3d", "Point2d", "PointTrack",
           "compute_2d_bipartites_from_points"]
