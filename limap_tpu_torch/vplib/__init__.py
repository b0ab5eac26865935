"""Vanishing points: per-image detection (kernel J) and multi-view VP
tracks."""

from limap_tpu_torch.vplib.jlinkage import JLinkage, JLinkageConfig, VPResult
from limap_tpu_torch.vplib.progressivex import (ProgressiveX,
                                                ProgressiveXConfig)
from limap_tpu_torch.vplib.vptrack import (GlobalVPTrackConstructor,
                                           GlobalVPTrackConstructorConfig,
                                           VPTrack,
                                           merge_vptracks_by_direction)


def get_vp_detector(cfg_vpdet: dict, n_jobs: int = 1, device=None):
    """The detector ``cfg_vpdet["method"]`` names (``jlinkage`` or
    ``progressive-x``) on ``device``."""
    method = cfg_vpdet.get("method", "jlinkage")
    if method == "jlinkage":
        return JLinkage(JLinkageConfig.from_dict(cfg_vpdet), device=device)
    if method == "progressive-x":
        return ProgressiveX(ProgressiveXConfig.from_dict(cfg_vpdet),
                            device=device)
    raise NotImplementedError(f"unknown VP detector {method!r}")


__all__ = ["JLinkage", "JLinkageConfig", "ProgressiveX",
           "ProgressiveXConfig", "VPResult", "VPTrack",
           "GlobalVPTrackConstructor", "GlobalVPTrackConstructorConfig",
           "merge_vptracks_by_direction", "get_vp_detector"]
