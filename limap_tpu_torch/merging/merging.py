"""The batch filter and remerge chain over a padded :class:`TrackBatch`.

Reprojection filter -> [remerge fixpoint -> reprojection filter] ->
sensitivity -> overlap.  The per-support tests run on the device; the
only host work is the remerge regrouping on the :class:`HostTrackBatch`
mirror, whose support fields never change on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base import line_geometry as lg
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import LineLinker3dConfig, check_3d
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import (HostTrackBatch, TrackBatch,
                                            batch_from_flat_supports,
                                            distinct_count)
from limap_tpu_torch.merging.aggregator import aggregate_tracks
from limap_tpu_torch.ops.connected_components import connected_components


def _support_views(batch: TrackBatch,
                   views: CameraViewsBatch) -> CameraViewsBatch:
    return views.select(batch.img_index)            # fields [T, S, ...]


def check_reprojection(batch: TrackBatch, views: CameraViewsBatch,
                       th_angular2d: float, th_perp2d: float) -> torch.Tensor:
    """Per-support reprojection test -> [T, S]."""
    proj = lg.project_segments(batch.line.expand(1),
                               _support_views(batch, views))
    ang = ld.angle(batch.line2d, proj)
    perp = ld.dist_endpoints_perpendicular_oneway(batch.line2d, proj)
    return (ang <= th_angular2d) & (perp <= th_perp2d) & batch.mask


def filter_tracks_by_reprojection(batch: TrackBatch, views: CameraViewsBatch,
                                  th_angular2d: float, th_perp2d: float,
                                  num_outliers: int = 2) -> TrackBatch:
    """Drop failing supports and re-aggregate."""
    new_mask = batch.mask & check_reprojection(batch, views, th_angular2d,
                                               th_perp2d)
    keep_track = batch.track_mask & (new_mask.sum(1) > 0)
    agg = aggregate_tracks(batch.line3d, batch.score, new_mask, num_outliers)
    return batch._replace(line=agg, mask=new_mask, track_mask=keep_track)


def filter_tracks_by_sensitivity(batch: TrackBatch, views: CameraViewsBatch,
                                 th_angular3d: float,
                                 min_support_ns: int) -> TrackBatch:
    """Keep tracks with >= N distinct well-conditioned images."""
    sens = lg.sensitivity(batch.line.expand(1), _support_views(batch, views))
    ok = (sens <= th_angular3d) & batch.mask
    return batch._replace(track_mask=batch.track_mask & (
        distinct_count(batch.img_index, ok) >= min_support_ns))


def filter_tracks_by_overlap(batch: TrackBatch, views: CameraViewsBatch,
                             th_overlap: float,
                             min_support_ns: int) -> TrackBatch:
    """Keep tracks whose projection overlaps enough of its 2D supports."""
    proj = lg.project_segments(batch.line.expand(1),
                               _support_views(batch, views))
    ok = (ld.compute_overlap(proj, batch.line2d) >= th_overlap) & batch.mask
    return batch._replace(track_mask=batch.track_mask & (
        distinct_count(batch.img_index, ok) >= min_support_ns))


def remerge_labels(batch: TrackBatch, views: CameraViewsBatch,
                   cfg: LineLinker3dConfig, tmask: torch.Tensor):
    """One remerge step: pairwise ``check_3d`` of the track lines (with
    the min support uncertainty) and connected components over the
    edges it finds.  Returns (labels [T], changed)."""
    sv = _support_views(batch, views)
    u_support = lg.compute_uncertainty(
        Segments(batch.line3d.start, batch.line3d.end), sv)
    u = torch.amin(torch.where(batch.mask, u_support,
                               torch.full_like(u_support, 1e30)), dim=1)
    line = Segments(batch.line.start, batch.line.end, uncertainty=u)
    T = line.start.shape[0]
    ok = check_3d(line.expand(1), line.expand(0), cfg)
    ok = ok & ~torch.eye(T, dtype=torch.bool, device=ok.device) \
        & tmask[:, None] & tmask[None, :]
    # the symmetric adjacency's edges, never a dense [T^2, 2] list
    edges = torch.nonzero(ok | ok.T)
    labels = connected_components(
        T, edges, torch.ones(len(edges), dtype=torch.bool,
                             device=edges.device))
    changed = bool((labels != torch.arange(T, device=labels.device)).any())
    return labels, changed


def compact_track_batch(host: HostTrackBatch,
                        labels: Optional[np.ndarray] = None,
                        return_host: bool = False, device=None):
    """Re-pack a host batch dropping masked tracks and supports; tracks
    with equal ``labels`` merge (their supports concatenated).  The first
    member's line represents a group."""
    T = len(host.track_mask)
    if labels is None:
        labels = np.arange(T)
    tvalid = host.track_mask
    lab = np.where(tvalid, labels, -1)
    uniq, inv = np.unique(lab, return_inverse=True)
    has_invalid = len(uniq) > 0 and uniq[0] == -1
    new_of = inv - 1 if has_invalid else inv
    n_groups = len(uniq) - (1 if has_invalid else 0)
    tidx = np.nonzero(tvalid)[0]
    first = np.zeros(max(n_groups, 1), np.int64)
    first[new_of[tidx][::-1]] = tidx[::-1]
    line = host.line[first[:n_groups]] if n_groups else None
    ti, si = np.nonzero(host.mask & tvalid[:, None])
    g = new_of[ti]
    order = np.argsort(g, kind="stable")
    ti, si, g = ti[order], si[order], g[order]
    return batch_from_flat_supports(
        g, host.img_index[ti, si], host.image_ids[ti, si],
        host.line_ids[ti, si], host.l2d[ti, si], host.l3d[ti, si],
        host.score[ti, si], line=line, num_tracks=n_groups,
        return_host=return_host, device=device)


def _aggregate_batch(batch: TrackBatch, views: CameraViewsBatch,
                     num_outliers: int) -> TrackBatch:
    """Per-support uncertainty + endpoint aggregation."""
    u_support = lg.compute_uncertainty(batch.line3d,
                                       _support_views(batch, views))
    seg = batch.line3d._replace(uncertainty=u_support)
    return batch._replace(line=aggregate_tracks(seg, batch.score,
                                                batch.mask, num_outliers))


def remerge_batch(batch: TrackBatch, views: CameraViewsBatch,
                  cfg3d: LineLinker3dConfig, num_outliers: int = 2,
                  max_iters: int = 10,
                  host: Optional[HostTrackBatch] = None):
    """Remerge to a fixpoint; returns (batch, host)."""
    cfg = cfg3d.to_spatial_merging()
    device = batch.mask.device
    host = (host.refresh(batch) if host is not None
            else HostTrackBatch.download(batch))
    n_prev = None
    for _ in range(max_iters):
        T = int(host.track_mask.sum())
        if T <= 1 or (n_prev is not None and T == n_prev):
            break
        n_prev = T
        labels, changed = remerge_labels(
            batch, views, cfg, torch.as_tensor(host.track_mask,
                                               device=device))
        if not changed:
            break
        batch, host = compact_track_batch(host, labels.cpu().numpy(),
                                          return_host=True, device=device)
        batch = _aggregate_batch(batch, views, num_outliers)
    return batch, host


def filter_chain_batch(batch: TrackBatch, views: CameraViewsBatch,
                       f2d: dict,
                       remerge_linker3d: Optional[LineLinker3dConfig] = None,
                       num_outliers: int = 2,
                       host: Optional[HostTrackBatch] = None):
    """The whole post-triangulation filter tail.  Returns (batch, host);
    the mirror's masks may be stale (refresh before host-side use)."""
    th_ang, th_perp = f2d.get("th_angular_2d", 10.0), f2d.get("th_perp_2d",
                                                            10.0)
    batch = filter_tracks_by_reprojection(batch, views, th_ang, th_perp,
                                          num_outliers)
    if remerge_linker3d is not None:
        batch, host = remerge_batch(batch, views, remerge_linker3d,
                                    num_outliers, host=host)
        batch = filter_tracks_by_reprojection(batch, views, th_ang, th_perp,
                                              num_outliers)
    batch = filter_tracks_by_sensitivity(
        batch, views, f2d.get("th_sv_angular_3d", 70.0),
        f2d.get("th_sv_num_supports", 3))
    batch = filter_tracks_by_overlap(
        batch, views, f2d.get("th_overlap", 0.05),
        f2d.get("th_overlap_num_supports", 3))
    return batch, host
