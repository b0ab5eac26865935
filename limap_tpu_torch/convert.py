"""Build the port's containers from another package's containers.

Each function reads fields by name and converts them with ``np.asarray``,
so it takes the reference package's NamedTuples (or anything with the
same field names) without importing that package.  Used to feed one
stage's reference output into the port's next stage.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import MinimalInfiniteLines3d
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import HostTrackBatch, TrackBatch


def _tensor(x, device):
    return None if x is None else torch.as_tensor(np.array(x),
                                                  device=device)


def _fields(cls, obj, device):
    device = resolve_device(device)
    return cls(*(_tensor(getattr(obj, f), device) for f in cls._fields))


def segments(obj, device=None) -> Segments:
    return _fields(Segments, obj, device)


def views(obj, device=None) -> CameraViewsBatch:
    return _fields(CameraViewsBatch, obj, device)


def minimal_lines(obj, device=None) -> MinimalInfiniteLines3d:
    return _fields(MinimalInfiniteLines3d, obj, device)


def track_batch(obj, device=None) -> TrackBatch:
    device = resolve_device(device)
    kw = {f: _tensor(getattr(obj, f), device) for f in TrackBatch._fields
          if f not in ("line", "line2d", "line3d")}
    return TrackBatch(line=segments(obj.line, device),
                      line2d=segments(obj.line2d, device),
                      line3d=segments(obj.line3d, device), **kw)


def host_track_batch(obj) -> HostTrackBatch:
    return HostTrackBatch(*(np.array(getattr(obj, f))
                            for f in HostTrackBatch._fields))


def hybrid_ba_state(obj, device=None):
    """The hybrid BA's state (``line_params``, ``point_params``,
    ``pose_params``, ``cam_fxfy``) as the port's ``HybridBAState``."""
    from limap_tpu_torch.parallel.sharded_ba import HybridBAState
    return _fields(HybridBAState, obj, device)


def hybrid_ba_data(data, device=None) -> tuple:
    """A ``line_data`` or ``point_data`` tuple of the hybrid BA as tensors
    (floats stay float32, indices stay integers)."""
    device = resolve_device(device)
    return tuple(_tensor(x, device) for x in data)
