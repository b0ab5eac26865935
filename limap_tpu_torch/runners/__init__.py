"""Pipelines: the stage functions, the line-triangulation and
fit-and-merge runners, the hybrid localization runner and the point-line
association runner."""

from limap_tpu_torch.runners.functions import (compute_2d_segs,
                                               compute_matches,
                                               compute_sfminfos, setup,
                                               undistort_images)
from limap_tpu_torch.runners.hybrid_localization import hybrid_localization
from limap_tpu_torch.runners.line_fitnmerge import (fit_3d_segs,
                                                    fit_3d_segs_with_points3d,
                                                    line_fitnmerge,
                                                    line_fitting_with_points3d)
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.runners.pointline_association import \
    pointline_association

__all__ = ["compute_2d_segs", "compute_matches", "compute_sfminfos", "setup",
           "undistort_images", "fit_3d_segs", "line_fitnmerge",
           "line_triangulation", "hybrid_localization",
           "fit_3d_segs_with_points3d", "line_fitting_with_points3d",
           "pointline_association"]
