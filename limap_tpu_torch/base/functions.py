"""Helpers between per-image 2D segment arrays and line tracks."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from limap_tpu_torch.base.linetrack import LineTrack


def get_all_lines_2d(all_2d_segs: Dict[int, np.ndarray]):
    """The (N, 4) endpoint columns of per-image (N, >= 4) arrays."""
    return {k: np.asarray(v)[:, :4] for k, v in all_2d_segs.items()}


def get_invert_idmap_from_linetracks(
        all_2d_segs: Dict[int, np.ndarray],
        linetracks: List[LineTrack]) -> Dict[int, np.ndarray]:
    """Per image, an array mapping line id -> track id (-1 when the line
    is in no track)."""
    out = {img_id: np.full(len(segs), -1, np.int64)
           for img_id, segs in all_2d_segs.items()}
    for track_id, track in enumerate(linetracks):
        for img_id, line_id in zip(track.image_id_list, track.line_id_list):
            if img_id in out and line_id < len(out[img_id]):
                out[img_id][line_id] = track_id
    return out
