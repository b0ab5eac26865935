"""Evaluation of line maps against ground truth."""

from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                  report_error_to_gt,
                                                  report_track_stats,
                                                  sample_points_on_segments)

__all__ = ["PointCloudEvaluator", "report_error_to_gt", "report_track_stats",
           "sample_points_on_segments"]
