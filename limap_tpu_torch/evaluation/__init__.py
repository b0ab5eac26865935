"""Evaluation of line maps against ground truth."""

from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                  RefLineEvaluator,
                                                  point_segment_distance,
                                                  report_error_to_gt,
                                                  report_track_stats,
                                                  sample_points_on_segments)
from limap_tpu_torch.evaluation.mesh_evaluator import (MeshEvaluator,
                                                       point_triangle_distance)

__all__ = ["MeshEvaluator", "PointCloudEvaluator", "RefLineEvaluator",
           "point_segment_distance", "point_triangle_distance",
           "report_error_to_gt", "report_track_stats",
           "sample_points_on_segments"]
