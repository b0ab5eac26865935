"""Track building, filtering and remerging.

Fit and merge: :func:`merge_to_linetracks` builds tracks from per-image
3D segments (the linker's edge test, then connected components).  The
batch filter and remerge chain over a padded :class:`TrackBatch`:
reprojection filter -> [remerge fixpoint -> reprojection filter] ->
sensitivity -> overlap; the per-support tests run on the device and the
only host work is the remerge regrouping on the :class:`HostTrackBatch`
mirror, whose support fields never change on the device.  The list path
(:func:`remerge`) regroups host :class:`LineTrack` lists.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from limap_tpu_torch.base import line_dists as ld
from limap_tpu_torch.base import line_geometry as lg
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import (LineLinker, LineLinker3dConfig,
                                              check_3d)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import (HostTrackBatch, LineTrack,
                                            TrackBatch,
                                            batch_from_flat_supports,
                                            distinct_count, tracks_to_batch)
from limap_tpu_torch.merging.aggregator import aggregate_tracks
from limap_tpu_torch.ops.connected_components import connected_components
from limap_tpu_torch.ops.linker_edges import edges_from_bits, linker_edges


def set_uncertainty_segs3d(seg3d: Segments, views: CameraViewsBatch,
                           var2d: float = 5.0) -> Segments:
    """Attach the per-view depth uncertainty of each segment."""
    return seg3d._replace(
        uncertainty=lg.compute_uncertainty(seg3d, views, var2d))


def merge_to_linetracks(all_lines_2d: Segments, all_lines_3d: Segments,
                        line_mask: torch.Tensor, views: CameraViewsBatch,
                        neighbors: torch.Tensor,
                        neighbor_mask: torch.Tensor, linker: LineLinker,
                        image_ids=None,
                        num_outliers: int = 0) -> List[LineTrack]:
    """Tracks from per-image segments: fields [I, L, 2] / [I, L, 3] (3D
    with uncertainty), ``line_mask`` [I, L], ``views`` [I], dense
    ``neighbors`` [I, K] rows with ``neighbor_mask``.  The linker's edge
    test (``ops/linker_edges.py``) runs over all self and neighbour
    pairs; tracks are the connected components of its edges with >= 2
    lines, grouped as :func:`_tracks_from_labels` says."""
    I, L = line_mask.shape
    if image_ids is None:
        image_ids = np.arange(I)
    self_bits, cross_bits = linker_edges(
        all_lines_2d, all_lines_3d, line_mask, views,
        neighbors.to(torch.int32), neighbor_mask, linker.linker_2d,
        linker.linker_3d.to_spatial_merging())
    edges = edges_from_bits(self_bits, cross_bits, neighbors, L)
    labels = connected_components(
        I * L, edges, torch.ones(len(edges), dtype=torch.bool,
                                 device=edges.device))
    deg = torch.bincount(edges.reshape(-1), minlength=I * L)
    valid_node = (deg > 0) & line_mask.reshape(-1)
    return _tracks_from_labels(
        labels.cpu().numpy(), valid_node.cpu().numpy(), I, L, image_ids,
        all_lines_2d, all_lines_3d, num_outliers)


def _tracks_from_labels(labels, valid_node, I, L, image_ids, all_lines_2d,
                        all_lines_3d, num_outliers) -> List[LineTrack]:
    """Group the valid nodes by component label (nodes ascending within a
    group, groups by ascending label), keep groups of >= 2 lines, and
    aggregate each group's 3D segments with their uncertainties; a
    support's score is its 3D length."""
    host = lambda x, d: x.reshape(I * L, d).cpu().numpy()
    l2s, l2e = host(all_lines_2d.start, 2), host(all_lines_2d.end, 2)
    l3s, l3e = host(all_lines_3d.start, 3), host(all_lines_3d.end, 3)
    unc = (all_lines_3d.uncertainty.reshape(I * L).cpu().numpy()
           if all_lines_3d.uncertainty is not None else np.ones(I * L))
    length3d = np.linalg.norm(l3e - l3s, axis=-1)
    node_ids = np.nonzero(valid_node)[0]
    lab = labels[node_ids]
    order = np.argsort(lab, kind="stable")
    node_ids, lab = node_ids[order], lab[order]
    groups = np.split(node_ids, np.nonzero(np.diff(lab))[0] + 1)
    groups = [g for g in groups if len(g) >= 2]
    if not groups:
        return []
    tracks = [LineTrack(
        image_id_list=[int(image_ids[n // L]) for n in g],
        line_id_list=[int(n % L) for n in g],
        line2d_list=[np.stack([l2s[n], l2e[n]]) for n in g],
        line3d_list=[np.stack([l3s[n], l3e[n]]) for n in g],
        score_list=[float(length3d[n]) for n in g],
        node_id_list=[int(n) for n in g]) for g in groups]
    device = all_lines_3d.start.device
    id2idx = {int(img): i for i, img in enumerate(image_ids)}
    batch = tracks_to_batch(tracks, id2idx, device=device)
    u_pad = np.ones(tuple(batch.mask.shape), np.float32)
    for gi, g in enumerate(groups):
        u_pad[gi, :len(g)] = unc[g]
    seg3d = batch.line3d._replace(uncertainty=torch.as_tensor(u_pad,
                                                              device=device))
    agg = aggregate_tracks(seg3d, batch.score, batch.mask, num_outliers)
    lines = torch.stack([agg.start, agg.end], 1).cpu().numpy()
    for tr, line in zip(tracks, lines):
        tr.line = line.astype(np.float64)
    return tracks


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


def check_sensitivity(batch: TrackBatch, views: CameraViewsBatch,
                      th_angular3d: float) -> torch.Tensor:
    """Per-support sensitivity test -> [T, S]."""
    sens = lg.sensitivity(batch.line.expand(1), _support_views(batch, views))
    return (sens <= th_angular3d) & batch.mask


def filter_tracks_by_sensitivity(batch: TrackBatch, views: CameraViewsBatch,
                                 th_angular3d: float,
                                 min_support_ns: int) -> TrackBatch:
    """Keep tracks with >= N distinct well-conditioned images."""
    ok = check_sensitivity(batch, views, th_angular3d)
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


def filter_tracks_by_num_images(batch: TrackBatch,
                                n_visible_views: int) -> TrackBatch:
    return batch._replace(track_mask=batch.track_mask
                          & (batch.count_images() >= n_visible_views))


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


def remerge_once(tracks: List[LineTrack], views: CameraViewsBatch,
                 id2idx: Dict[int, int], cfg3d: LineLinker3dConfig,
                 num_outliers: int = 2) -> List[LineTrack]:
    """One remerge pass over host tracks: the pairwise check of their
    lines (:func:`remerge_labels`), groups in order of first appearance
    over ascending track index (their supports concatenated), and each
    group re-aggregated with the per-support uncertainty."""
    if len(tracks) <= 1:
        return tracks
    device = views.kvec.device
    batch = tracks_to_batch(tracks, id2idx, device=device)
    labels, _ = remerge_labels(batch, views, cfg3d.to_spatial_merging(),
                               batch.track_mask)
    groups: Dict[int, List[int]] = {}
    for ti, lab in enumerate(labels[:len(tracks)].tolist()):
        groups.setdefault(lab, []).append(ti)
    new_tracks = []
    for members in groups.values():
        tr = LineTrack()
        for ti in members:
            src = tracks[ti]
            tr.image_id_list += src.image_id_list
            tr.line_id_list += src.line_id_list
            tr.line2d_list += src.line2d_list
            tr.line3d_list += src.line3d_list
            tr.score_list += src.score_list
            tr.node_id_list += src.node_id_list
        new_tracks.append(tr)
    nb = _aggregate_batch(tracks_to_batch(new_tracks, id2idx, device=device),
                          views, num_outliers)
    lines = torch.stack([nb.line.start, nb.line.end], 1).cpu().numpy()
    for tr, line in zip(new_tracks, lines):
        tr.line = line.astype(np.float64)
    return new_tracks


def remerge(tracks: List[LineTrack], views: CameraViewsBatch,
            id2idx: Dict[int, int], cfg3d: LineLinker3dConfig,
            num_outliers: int = 2, max_iters: int = 10) -> List[LineTrack]:
    """Remerge passes until the track count stops changing."""
    num = len(tracks)
    for _ in range(max_iters):
        tracks = remerge_once(tracks, views, id2idx, cfg3d, num_outliers)
        if len(tracks) == num:
            break
        num = len(tracks)
    return tracks
