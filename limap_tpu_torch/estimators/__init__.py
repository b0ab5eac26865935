"""Pose estimators (PnPL RANSAC)."""

from limap_tpu_torch.estimators.absolute_pose import (
    RansacOptions, pl_estimate_absolute_pose)
from limap_tpu_torch.estimators.p3p import kabsch, p3p

__all__ = ["RansacOptions", "pl_estimate_absolute_pose", "kabsch", "p3p"]
