"""Track building, aggregation, filtering and remerging."""

from limap_tpu_torch.merging.aggregator import (aggregate_tracks,
                                                principal_direction)
from limap_tpu_torch.merging.merging import (
    check_reprojection, check_sensitivity, compact_track_batch,
    filter_chain_batch, filter_tracks_by_num_images, filter_tracks_by_overlap,
    filter_tracks_by_reprojection, filter_tracks_by_sensitivity,
    merge_to_linetracks, remerge, remerge_batch, set_uncertainty_segs3d)
from limap_tpu_torch.merging.strategies import (
    compute_track_labels_avg, compute_track_labels_exhaustive)

__all__ = [
    "aggregate_tracks", "principal_direction", "check_reprojection",
    "check_sensitivity", "compact_track_batch", "filter_chain_batch",
    "filter_tracks_by_num_images", "filter_tracks_by_overlap",
    "filter_tracks_by_reprojection", "filter_tracks_by_sensitivity",
    "merge_to_linetracks", "remerge", "remerge_batch",
    "set_uncertainty_segs3d", "compute_track_labels_avg",
    "compute_track_labels_exhaustive",
]
