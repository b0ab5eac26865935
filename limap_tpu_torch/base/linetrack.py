"""Line tracks: host :class:`LineTrack` objects, the padded tensor
:class:`TrackBatch` every batched stage takes, and its numpy mirror
:class:`HostTrackBatch`."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.util import shape_bucket


class LineTrack:
    """One 3D line with its supporting 2D/3D segments."""

    def __init__(self, line=None, image_id_list=None, line_id_list=None,
                 line2d_list=None, line3d_list=None, score_list=None,
                 node_id_list=None):
        self.line = (np.zeros((2, 3)) if line is None
                     else np.asarray(line, dtype=np.float64))
        self.image_id_list: List[int] = list(image_id_list or [])
        self.line_id_list: List[int] = list(line_id_list or [])
        self.line2d_list = [np.asarray(x, np.float64)
                            for x in (line2d_list or [])]
        self.line3d_list = [np.asarray(x, np.float64)
                            for x in (line3d_list or [])]
        self.score_list: List[float] = list(score_list or [])
        self.node_id_list: List[int] = list(node_id_list or [])
        self.active = True

    def count_lines(self) -> int:
        return len(self.image_id_list)

    def count_images(self) -> int:
        return len(set(self.image_id_list))

    def as_dict(self) -> dict:
        return {
            "line": self.line.tolist(),
            "image_id_list": self.image_id_list,
            "line_id_list": self.line_id_list,
            "line2d_list": [l.tolist() for l in self.line2d_list],
            "line3d_list": [l.tolist() for l in self.line3d_list],
            "score_list": self.score_list,
            "node_id_list": self.node_id_list,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LineTrack":
        return cls(line=d["line"], image_id_list=d["image_id_list"],
                   line_id_list=d["line_id_list"],
                   line2d_list=d.get("line2d_list"),
                   line3d_list=d.get("line3d_list"),
                   score_list=d.get("score_list"),
                   node_id_list=d.get("node_id_list"))

    # ---- txt IO in LIMAP's track file format ----
    def Write(self, filename: str) -> None:
        n_lines = self.count_lines()
        with open(filename, "w") as f:
            vals = list(np.nan_to_num(self.line[0])) + list(
                np.nan_to_num(self.line[1]))
            f.write(" ".join(f"{v:.10f}" for v in vals) + " \n")
            f.write(f"{n_lines} {self.count_images()}\n")
            f.write("image_id_list " +
                    " ".join(str(i) for i in self.image_id_list) + " \n")
            f.write("line_id_list " +
                    " ".join(str(i) for i in self.line_id_list) + " \n")
            f.write("line2d_list\n")
            for l in self.line2d_list:
                f.write(f"{l[0][0]:.10f} {l[0][1]:.10f} "
                        f"{l[1][0]:.10f} {l[1][1]:.10f} \n")
            if self.node_id_list:
                f.write("node_id_list " +
                        " ".join(str(i) for i in self.node_id_list) + " \n")
            if self.score_list:
                f.write("score_list " +
                        " ".join(f"{s:.10f}" for s in self.score_list) + " \n")
            if self.line3d_list:
                f.write("line3d_list\n")
                for l in self.line3d_list:
                    f.write(f"{l[0][0]:.10f} {l[0][1]:.10f} {l[0][2]:.10f} "
                            f"{l[1][0]:.10f} {l[1][1]:.10f} {l[1][2]:.10f} \n")
            f.write("END\n")

    def Read(self, filename: str) -> "LineTrack":
        with open(filename) as f:
            lines = [ln.strip() for ln in f.readlines()]
        vals = [float(v) for v in lines[0].split()]
        self.line = np.array([vals[:3], vals[3:6]])
        n_lines = int(lines[1].split()[0])
        self.image_id_list = [int(v) for v in lines[2].split()[1:]]
        self.line_id_list = [int(v) for v in lines[3].split()[1:]]
        assert lines[4] == "line2d_list"
        self.line2d_list = []
        row = 5
        for i in range(n_lines):
            v = [float(x) for x in lines[row + i].split()]
            self.line2d_list.append(np.array([v[:2], v[2:4]]))
        row += n_lines
        self.node_id_list, self.score_list, self.line3d_list = [], [], []
        while row < len(lines) and lines[row] != "END":
            tok = lines[row].split()
            if tok[0] == "node_id_list":
                self.node_id_list = [int(v) for v in tok[1:]]
                row += 1
            elif tok[0] == "score_list":
                self.score_list = [float(v) for v in tok[1:]]
                row += 1
            elif tok[0] == "line3d_list":
                row += 1
                for i in range(n_lines):
                    v = [float(x) for x in lines[row + i].split()]
                    self.line3d_list.append(np.array([v[:3], v[3:6]]))
                row += n_lines
            else:
                row += 1
        return self


def distinct_count(img_index: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Distinct masked values per row of [T, S], by sort and compare."""
    big = 2 ** 30
    ids = torch.where(mask, img_index.to(torch.int64),
                      torch.full_like(img_index, big, dtype=torch.int64))
    s = torch.sort(ids, dim=1).values
    diff = torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool),
                      s[:, 1:] != s[:, :-1]], dim=1)
    return torch.sum(diff & (s < big), dim=1)


class TrackBatch(NamedTuple):
    """``T`` tracks padded to ``S`` supports each, as tensors.

    ``img_index`` holds rows of the image batch (not image ids).
    """

    line: Segments                 # fields [T, 3]
    img_index: torch.Tensor        # [T, S] int32
    image_ids: torch.Tensor        # [T, S] int32
    line_ids: torch.Tensor         # [T, S] int32
    line2d: Segments               # fields [T, S, 2]
    line3d: Segments               # fields [T, S, 3]
    score: torch.Tensor            # [T, S]
    mask: torch.Tensor             # [T, S] bool
    track_mask: torch.Tensor       # [T] bool

    def count_images(self) -> torch.Tensor:
        return distinct_count(self.img_index, self.mask)


class HostTrackBatch(NamedTuple):
    """Numpy mirror of a TrackBatch's support fields, for host regrouping
    without bulk downloads."""

    line: np.ndarray        # [T, 2, 3]
    img_index: np.ndarray   # [T, S]
    image_ids: np.ndarray
    line_ids: np.ndarray
    l2d: np.ndarray         # [T, S, 2, 2]
    l3d: np.ndarray         # [T, S, 2, 3]
    score: np.ndarray
    mask: np.ndarray
    track_mask: np.ndarray

    def refresh(self, batch: TrackBatch,
                with_line: bool = False) -> "HostTrackBatch":
        """Pull only what the device stages change: the masks, and the
        line with ``with_line``."""
        out = self._replace(mask=batch.mask.cpu().numpy(),
                            track_mask=batch.track_mask.cpu().numpy())
        if with_line:
            out = out._replace(line=torch.stack(
                [batch.line.start, batch.line.end], 1).cpu().numpy())
        return out

    @classmethod
    def download(cls, batch: TrackBatch) -> "HostTrackBatch":
        n = lambda x: x.cpu().numpy()
        return cls(n(torch.stack([batch.line.start, batch.line.end], 1)),
                   n(batch.img_index), n(batch.image_ids), n(batch.line_ids),
                   n(torch.stack([batch.line2d.start, batch.line2d.end], 2)),
                   n(torch.stack([batch.line3d.start, batch.line3d.end], 2)),
                   n(batch.score), n(batch.mask), n(batch.track_mask))


def batch_from_flat_supports(
        track_of: np.ndarray,          # [E] track per support, SORTED
        img_index: np.ndarray,         # [E] image row per support
        image_ids: np.ndarray,         # [E]
        line_ids: np.ndarray,          # [E]
        l2d: np.ndarray,               # [E, 2, 2]
        l3d: np.ndarray,               # [E, 2, 3]
        score: np.ndarray,             # [E]
        line: Optional[np.ndarray] = None,   # [T, 2, 3] or None
        num_tracks: Optional[int] = None,
        return_slots: bool = False,
        return_host: bool = False,
        device=None):
    """Flat supports grouped by ``track_of`` (non-decreasing) -> padded
    :class:`TrackBatch` on ``device``, [T, S] padded to the reference's
    shape buckets (same padded shapes, same slot indices).  With
    ``return_slots`` / ``return_host`` also returns (track, slot) of each
    support and the :class:`HostTrackBatch` mirror."""
    device = resolve_device(device)
    E = len(track_of)
    T = int(num_tracks if num_tracks is not None
            else (track_of[-1] + 1 if E else 0))
    counts = np.bincount(track_of, minlength=max(T, 1)) if E else \
        np.zeros(max(T, 1), np.int64)
    S_needed = int(counts.max()) if E else 1
    T_pad = shape_bucket(max(T, 2), min_bucket=2)
    S = shape_bucket(max(S_needed, 2), min_bucket=2)
    starts = np.zeros(max(T, 1), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    si = (np.arange(E, dtype=np.int64) - starts[track_of]) if E else \
        np.zeros(0, np.int64)

    out_img_index = np.zeros((T_pad, S), np.int32)
    out_image_ids = np.zeros((T_pad, S), np.int32)
    out_line_ids = np.zeros((T_pad, S), np.int32)
    out_l2d = np.zeros((T_pad, S, 2, 2), np.float32)
    out_l3d = np.zeros((T_pad, S, 2, 3), np.float32)
    out_score = np.zeros((T_pad, S), np.float32)
    out_mask = np.zeros((T_pad, S), bool)
    track_mask = np.zeros((T_pad,), bool)
    track_mask[:T] = True
    if E:
        ti = track_of
        out_img_index[ti, si] = img_index
        out_image_ids[ti, si] = image_ids
        out_line_ids[ti, si] = line_ids
        out_l2d[ti, si] = l2d
        out_l3d[ti, si] = l3d
        out_score[ti, si] = score
        out_mask[ti, si] = True
    out_line = np.zeros((T_pad, 2, 3), np.float32)
    if line is not None:
        out_line[:T] = line[:T]
    t = lambda a: torch.as_tensor(a, device=device)
    batch = TrackBatch(
        line=Segments(t(out_line[:, 0]), t(out_line[:, 1])),
        img_index=t(out_img_index), image_ids=t(out_image_ids),
        line_ids=t(out_line_ids),
        line2d=Segments(t(out_l2d[:, :, 0]), t(out_l2d[:, :, 1])),
        line3d=Segments(t(out_l3d[:, :, 0]), t(out_l3d[:, :, 1])),
        score=t(out_score), mask=t(out_mask), track_mask=t(track_mask))
    extras = []
    if return_slots:
        extras.append((track_of if E else np.zeros(0, np.int64), si))
    if return_host:
        extras.append(HostTrackBatch(
            out_line, out_img_index, out_image_ids, out_line_ids, out_l2d,
            out_l3d, out_score, out_mask, track_mask))
    return (batch, *extras) if extras else batch


def tracks_to_batch(tracks: Sequence[LineTrack],
                    img_id_to_index: Dict[int, int],
                    device=None) -> TrackBatch:
    """Pack host tracks into a padded :class:`TrackBatch` on ``device``
    (a track without 3D supports or scores gets zeros there)."""
    counts = np.fromiter((t.count_lines() for t in tracks), np.int64,
                         count=len(tracks))
    track_of = np.repeat(np.arange(len(tracks), dtype=np.int64), counts)
    E = len(track_of)

    def flat(get, shape, dtype):
        parts = [np.asarray(get(t), dtype).reshape((-1,) + shape)
                 if len(get(t)) else np.zeros((n,) + shape, dtype)
                 for n, t in zip(counts, tracks)]
        return np.concatenate(parts) if parts else np.zeros((0,) + shape,
                                                             dtype)

    image_ids = flat(lambda t: t.image_id_list, (), np.int64)
    img_index = np.array([img_id_to_index[int(i)] for i in image_ids],
                         np.int64).reshape(E)
    line = (np.stack([t.line for t in tracks]) if tracks
            else np.zeros((0, 2, 3)))
    return batch_from_flat_supports(
        track_of, img_index, image_ids,
        flat(lambda t: t.line_id_list, (), np.int64),
        flat(lambda t: t.line2d_list, (2, 2), np.float64),
        flat(lambda t: t.line3d_list, (2, 3), np.float64),
        flat(lambda t: t.score_list, (), np.float64),
        line=line, num_tracks=len(tracks), device=device)


def batch_to_tracks(batch: TrackBatch,
                    host: Optional[HostTrackBatch] = None
                    ) -> List[LineTrack]:
    """Unpack a batch into host tracks, dropping padding; with a ``host``
    mirror only the masks and the line are downloaded."""
    host = (host.refresh(batch, with_line=True) if host is not None
            else HostTrackBatch.download(batch))
    tmask = host.track_mask
    T = len(tmask)
    ti, si = np.nonzero(host.mask & tmask[:, None])
    splits = np.cumsum(np.bincount(ti, minlength=T))[:-1]
    split = lambda a, dt: np.split(a[ti, si].astype(dt), splits)
    img_ids = split(host.image_ids, np.int64)
    line_ids = split(host.line_ids, np.int64)
    l2d = split(host.l2d, np.float64)
    l3d = split(host.l3d, np.float64)
    score = split(host.score, np.float64)
    line64 = host.line.astype(np.float64)
    tracks = []
    for t in np.nonzero(tmask)[0]:
        tr = LineTrack(line=line64[t])
        tr.image_id_list = img_ids[t].tolist()
        tr.line_id_list = line_ids[t].tolist()
        tr.line2d_list = list(l2d[t])
        tr.line3d_list = list(l3d[t])
        tr.score_list = score[t].tolist()
        tracks.append(tr)
    return tracks
