"""Core geometry: segments, cameras, linkers, infinite lines, tracks,
depth and point-map readers."""

from limap_tpu_torch.base import line_dists, line_geometry, line_linker, pose
from limap_tpu_torch.base.camera import (Camera, CameraPose, CameraView,
                                         CameraViewsBatch)
from limap_tpu_torch.base.depth_reader_base import (ArrayDepthReader,
                                                    BaseDepthReader)
from limap_tpu_torch.base.infinite_line import (
    InfiniteLines3d, MinimalInfiniteLines3d, infline2d_from_segment,
    intersect_infinite_lines_2d, line_world_to_pixel, minimal_to_plucker)
from limap_tpu_torch.base.line_linker import (LineLinker, LineLinker2dConfig,
                                              LineLinker3dConfig)
from limap_tpu_torch.base.lines import (Segments, pad_segments,
                                        segments2d_from_numpy)
from limap_tpu_torch.base.p3d_reader_base import (ArrayP3DReader,
                                                  BaseP3DReader)

__all__ = [
    "line_dists", "line_geometry", "line_linker", "pose",
    "Camera", "CameraPose", "CameraView", "CameraViewsBatch",
    "InfiniteLines3d", "MinimalInfiniteLines3d", "infline2d_from_segment",
    "intersect_infinite_lines_2d", "line_world_to_pixel",
    "minimal_to_plucker", "Segments", "pad_segments",
    "segments2d_from_numpy", "LineLinker", "LineLinker2dConfig",
    "LineLinker3dConfig", "BaseDepthReader", "ArrayDepthReader",
    "BaseP3DReader", "ArrayP3DReader",
]
