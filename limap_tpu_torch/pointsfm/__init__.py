"""Point-SfM integration: COLMAP, Bundler and VisualSfM model readers,
the SfM model's neighbours and ranges, and SfM with known poses."""

from limap_tpu_torch.pointsfm.colmap_reader import (ReadInfos,
                                                    ReadPointTracks,
                                                    read_model,
                                                    write_model_txt)
from limap_tpu_torch.pointsfm.colmap_sfm import run_colmap_sfm_with_known_poses
from limap_tpu_torch.pointsfm.readers import (ReadModelBundler,
                                              ReadModelVisualSfM)
from limap_tpu_torch.pointsfm.sfm import run_sfm_with_known_poses
from limap_tpu_torch.pointsfm.sfm_model import (SfmModel, compute_metainfos,
                                                compute_neighbors)

__all__ = ["ReadInfos", "ReadPointTracks", "read_model", "write_model_txt",
           "run_colmap_sfm_with_known_poses", "ReadModelBundler",
           "ReadModelVisualSfM", "run_sfm_with_known_poses",
           "SfmModel", "compute_metainfos", "compute_neighbors"]
