"""3D segments fitted to depth maps or point maps."""

from limap_tpu_torch.fitting.fitting import (draw_hypotheses,
                                             estimate_segs3d_from_depth,
                                             estimate_segs3d_from_points3d,
                                             fit_lines_from_hypotheses,
                                             fit_lines_ransac,
                                             sample_segment_depths,
                                             unproject_points)

__all__ = ["estimate_segs3d_from_depth", "estimate_segs3d_from_points3d",
           "fit_lines_ransac", "sample_segment_depths", "unproject_points",
           "draw_hypotheses", "fit_lines_from_hypotheses"]
