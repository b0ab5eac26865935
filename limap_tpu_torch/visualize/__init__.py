"""Visualization: track reports, 2D overlays, match plots, 3D viewers.

The interactive backends (open3d / pyvista) are optional — all geometry
assembly is backend-free NumPy in vis_lines.py; viewers import their
backend lazily.
"""

from limap_tpu_torch.visualize.trackvis import (BaseTrackVisualizer,
                                                Open3DTrackVisualizer,
                                                PyVistaTrackVisualizer,
                                                get_track_visualizer)
from limap_tpu_torch.visualize.vis_lines import (build_camera_set,
                                                 build_line_set,
                                                 camera_frustum_lines,
                                                 open3d_vis_3d_lines,
                                                 pyvista_vis_3d_lines,
                                                 track_colors)
from limap_tpu_torch.visualize.vis_matches import (plot_color_line_matches,
                                                   plot_color_lines,
                                                   plot_images, plot_lines,
                                                   plot_matches, save_plot)
from limap_tpu_torch.visualize.vis_utils import (compute_robust_range_lines,
                                                 compute_robust_range_points,
                                                 draw_matches, draw_points,
                                                 draw_segments, filter_ranges,
                                                 test_line_inside_ranges,
                                                 test_point_inside_ranges)

__all__ = [
    "BaseTrackVisualizer", "Open3DTrackVisualizer",
    "PyVistaTrackVisualizer", "get_track_visualizer",
    "build_line_set", "build_camera_set", "camera_frustum_lines",
    "track_colors", "open3d_vis_3d_lines", "pyvista_vis_3d_lines",
    "plot_images", "plot_matches", "plot_lines",
    "plot_color_line_matches", "plot_color_lines", "save_plot",
    "draw_segments", "draw_matches", "draw_points",
    "test_point_inside_ranges", "test_line_inside_ranges",
    "compute_robust_range_points", "compute_robust_range_lines",
    "filter_ranges",
]
