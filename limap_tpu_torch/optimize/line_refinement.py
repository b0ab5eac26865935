"""Per-track line refinement with fixed cameras: the geometric term of
line BA, and optionally VP constraints, heatmap terms and cross-view
feature consistency, every track an independent 4-DOF problem, all
solved at once: on the card by kernel K (``ops/lm_line_refine.py``, one
launch a solve), on the CPU by the eager ``lm_solve``.

The pixel-level terms read small patches cut once up front
(:func:`build_heatmap_patches`, :func:`build_fconsis_terms`), so a
residual evaluation touches a few texels of device memory, never a whole
image.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import MinimalInfiniteLines3d
from limap_tpu_torch.base.linetrack import (LineTrack, TrackBatch,
                                            batch_to_tracks, tracks_to_batch)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.pose import quat_rotate
from limap_tpu_torch.ops import lm_line_refine
from limap_tpu_torch.optimize import residuals as res
from limap_tpu_torch.optimize.line_ba import (LineBAConfig, get_output_tracks,
                                              pack_minimal_lines,
                                              unpack_minimal_lines)


@dataclasses.dataclass(frozen=True)
class RefinementConfig(LineBAConfig):
    """The refinement's terms and weights."""

    use_geometric: bool = True
    use_vp: bool = False
    vp_multiplier: float = 0.1
    use_heatmap: bool = False
    heatmap_multiplier: float = 1.0
    use_feature: bool = False
    fconsis_multiplier: float = 1.0
    n_samples_feature: int = 100
    sample_range_min: float = 0.05
    sample_range_max: float = 0.95


def build_heatmap_patches(batch: TrackBatch, heatmaps: Dict[int, "object"],
                          n_perp: int = 11, perp_spacing: float = 1.0,
                          n_along: int = 16):
    """Line-aligned heatmap patches of every (track, support), cut once.

    Returns (patches [T, S, A, P], origin [T, S, 2], u_axis [T, S, 2],
    v_axis [T, S, 2], length [T, S]) on the batch's device, where patch
    coordinates are p = origin + a * u_axis * (len / (A - 1))
    + (b - (P - 1) / 2) * v_axis.
    """
    from limap_tpu_torch.features.featuremap import extract_line_patches
    dev = batch.mask.device
    T, S = batch.mask.shape
    img_ids = batch.image_ids.cpu().numpy()
    mask = batch.mask.cpu().numpy()
    l2s, l2e = batch.line2d.start, batch.line2d.end
    patches = torch.zeros((T, S, n_along, n_perp), dtype=torch.float32,
                          device=dev)
    for img_id in sorted(set(img_ids[mask].tolist())):
        sel = np.argwhere((img_ids == img_id) & mask)
        hm = torch.as_tensor(heatmaps[int(img_id)], dtype=torch.float32,
                             device=dev)
        ti = torch.as_tensor(sel[:, 0], device=dev)
        si = torch.as_tensor(sel[:, 1], device=dev)
        p = extract_line_patches(hm[..., None], l2s[ti, si], l2e[ti, si],
                                 n_along=n_along, n_perp=n_perp,
                                 perp_spacing=perp_spacing)
        patches[ti, si] = p[..., 0]
    d = l2e - l2s
    length = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    u = d / torch.clamp(length, min=1e-8)
    v = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
    return patches, l2s, u, v, length[..., 0]


def _cut_patches(fmap: torch.Tensor, centers: np.ndarray, radius: int):
    """Square patches [n, P, P, C] of ``fmap`` [H, W, C] around the
    rounded ``centers`` [n, 2] (x, y), zero beyond the image, and their
    origins (x0, y0) [n, 2]."""
    H, W, _ = fmap.shape
    P = 2 * radius + 1
    c = np.round(np.asarray(centers, np.float64)).astype(np.int64)
    origin = c - radius
    off = torch.arange(P, device=fmap.device)
    o = torch.as_tensor(origin, device=fmap.device)
    ys = o[:, 1, None, None] + off[None, :, None]
    xs = o[:, 0, None, None] + off[None, None, :]
    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    vals = fmap[ys.clamp(0, H - 1), xs.clamp(0, W - 1)]
    return vals * inside[..., None], origin.astype(np.float32)


def build_fconsis_terms(batch: TrackBatch, views: CameraViewsBatch,
                        featuremaps: Dict[int, "object"], id2row,
                        n_samples: int = 10, sample_range=(0.05, 0.95),
                        patch_radius: int = 10, max_terms: int = 64):
    """Cross-view feature-consistency terms of every track.

    For each track, points are sampled along its 3D line; for each
    sample the supports whose projection falls inside ``sample_range`` of
    their segment are kept, the longest is the *reference*, and every
    other, in order of decreasing length, a *target*, at most
    ``max_terms`` terms a track.  A term carries the sample's
    perpendicular line in the reference image and the two patches cut
    around the sample's projections.

    featuremaps: {img_id: [H, W, C] array or tensor}.  Returns, on the
    batch's device, (ref_view, tgt_view [T, F] int32, coords [T, F, 3],
    ref_patch, tgt_patch [T, F, P, P, C], ref_origin, tgt_origin
    [T, F, 2], w [T, F]) with F the most terms of a track (at least 1).
    """
    dev = batch.mask.device
    row2id = {row: img_id for img_id, row in id2row.items()}
    T = batch.mask.shape[0]
    C = next(iter(featuremaps.values())).shape[-1] if featuremaps else 1
    mask = batch.mask.cpu().numpy()
    img_index = batch.img_index.cpu().numpy()
    l2s = batch.line2d.start.cpu().numpy()
    l2e = batch.line2d.end.cpu().numpy()
    ts = np.linspace(0.0, 1.0, n_samples)
    # every sample projected into every support at once: [T, n, S, 2]
    line_s = batch.line.start.cpu().numpy()
    line_e = batch.line.end.cpu().numpy()
    p3 = (line_s[:, None] * (1 - ts[None, :, None])
          + line_e[:, None] * ts[None, :, None]).astype(np.float32)
    sv = views.select(batch.img_index)
    p3t = torch.as_tensor(p3, device=dev)[:, :, None]      # [T, n, 1, 3]
    pc = quat_rotate(sv.qvec[:, None], p3t) + sv.tvec[:, None]
    kv = sv.kvec[:, None]
    xy = torch.stack([kv[..., 0] * pc[..., 0] / pc[..., 2] + kv[..., 2],
                      kv[..., 1] * pc[..., 1] / pc[..., 2] + kv[..., 3]],
                     -1).cpu().numpy()                     # [T, n, S, 2]
    d2 = l2e - l2s
    ln = np.linalg.norm(d2, axis=-1)                       # [T, S]
    with np.errstate(divide="ignore", invalid="ignore"):
        proj = np.sum((xy - l2s[:, None]) * (d2 / ln[..., None])[:, None],
                      -1) / ln[:, None]                    # [T, n, S]
    good_all = (proj >= sample_range[0]) & (proj <= sample_range[1]) \
        & (ln >= 1e-6)[:, None]

    terms = []     # (track, ref_row, tgt_row, coords, ref_xy, tgt_xy)
    fill = np.zeros(T, np.int64)
    for ti in range(T):
        sup = np.nonzero(mask[ti])[0]
        if len(sup) < 2:
            continue
        sup = [si for si in sup if int(img_index[ti, si]) in row2id]
        for k in range(n_samples):
            good = [si for si in sup if good_all[ti, k, si]]
            if len(good) < 2:
                continue
            good.sort(key=lambda si: -ln[ti, si])
            ref_si = good[0]
            ref_row = int(img_index[ti, ref_si])
            ref_xy = xy[ti, k, ref_si]
            d = d2[ti, ref_si] / (np.linalg.norm(d2[ti, ref_si]) + 1e-12)
            perp = np.array([-d[1], d[0]])
            coords = np.array([perp[1], -perp[0],
                               perp[0] * ref_xy[1] - perp[1] * ref_xy[0]])
            coords = coords / (np.linalg.norm(coords[:2]) + 1e-12)
            if row2id[ref_row] not in featuremaps:
                continue
            for tgt_si in good[1:]:
                if fill[ti] >= max_terms:
                    break
                tgt_row = int(img_index[ti, tgt_si])
                if row2id[tgt_row] not in featuremaps:
                    continue
                terms.append((ti, fill[ti], ref_row, tgt_row, coords,
                              ref_xy, xy[ti, k, tgt_si]))
                fill[ti] += 1
    F = max(1, int(fill.max()) if T else 1)
    P = 2 * patch_radius + 1
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    out = dict(ref_view=z(T, F, dt=torch.int32),
               tgt_view=z(T, F, dt=torch.int32), coords=z(T, F, 3),
               ref_patch=z(T, F, P, P, C), tgt_patch=z(T, F, P, P, C),
               ref_origin=z(T, F, 2), tgt_origin=z(T, F, 2), w=z(T, F))
    if terms:
        ti = np.array([t[0] for t in terms])
        fi = np.array([t[1] for t in terms])
        rows = {"ref": np.array([t[2] for t in terms]),
                "tgt": np.array([t[3] for t in terms])}
        centers = {"ref": np.stack([t[5] for t in terms]),
                   "tgt": np.stack([t[6] for t in terms])}
        idx = (torch.as_tensor(ti, device=dev), torch.as_tensor(fi, device=dev))
        out["coords"][idx] = torch.as_tensor(
            np.stack([t[4] for t in terms]).astype(np.float32), device=dev)
        for side in ("ref", "tgt"):
            out[f"{side}_view"][idx] = torch.as_tensor(
                rows[side], dtype=torch.int32, device=dev)
            for row in np.unique(rows[side]):
                sel = np.nonzero(rows[side] == row)[0]
                fmap = torch.as_tensor(
                    featuremaps[row2id[int(row)]], dtype=torch.float32,
                    device=dev)
                patch, origin = _cut_patches(fmap, centers[side][sel],
                                             patch_radius)
                i = (idx[0][sel], idx[1][sel])
                out[f"{side}_patch"][i] = patch
                out[f"{side}_origin"][i] = torch.as_tensor(origin,
                                                           device=dev)
        # the reference's weight normalization
        wt = 1.0 / np.maximum((n_samples / 100.0)
                              * (fill / n_samples / 5.0 + 1e-9), 1e-3)
        out["w"][idx] = torch.as_tensor(wt[ti].astype(np.float32),
                                        device=dev)
    return tuple(out[k] for k in ("ref_view", "tgt_view", "coords",
                                  "ref_patch", "tgt_patch", "ref_origin",
                                  "tgt_origin", "w"))


def refine_data(batch: TrackBatch, views: CameraViewsBatch,
                cfg: RefinementConfig, track_vps=None, track_has_vp=None,
                heatmap_data=None, fconsis_data=None):
    """The kernel's inputs and terms for a batch: (params0, RefineData,
    RefineTerms)."""
    dev = batch.mask.device
    T, S = batch.mask.shape
    params0 = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(
        Segments(batch.line.start, batch.line.end))).contiguous()
    sup = views.select(batch.img_index)
    free = (batch.count_images() >= cfg.min_num_images) & batch.track_mask
    weights = res.compute_line_weights(batch.line2d) * batch.mask \
        * free[:, None]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    if cfg.use_vp and track_vps is not None:
        vps = track_vps.to(torch.float32)
        vp_w = (track_has_vp & batch.mask & free[:, None]).to(
            torch.float32) * cfg.vp_multiplier
    else:
        vps, vp_w = z(T, S, 3), z(T, S)
    use_heatmap = cfg.use_heatmap and heatmap_data is not None
    hm = tuple(heatmap_data) if use_heatmap else (
        z(T, S, 1, 1), z(T, S, 2), z(T, S, 2), z(T, S, 2),
        torch.ones((T, S), device=dev))
    use_fconsis = cfg.use_feature and fconsis_data is not None
    if use_fconsis:
        # a track seen in fewer than min_num_images views stays as it is:
        # its feature terms go too (the JAX package keeps them, so such a
        # track moves on them alone; ROADMAP.md section 3)
        fconsis_data = tuple(fconsis_data[:7]) + (
            fconsis_data[7] * free[:, None],)
    fc = tuple(fconsis_data) if use_fconsis else (
        torch.zeros((T, 0), dtype=torch.int32, device=dev),
        torch.zeros((T, 0), dtype=torch.int32, device=dev), z(T, 0, 3),
        z(T, 0, 1, 1, 1), z(T, 0, 1, 1, 1), z(T, 0, 2), z(T, 0, 2),
        z(T, 0))
    RefineData = lm_line_refine.RefineData
    data = RefineData(sup.kvec, sup.qvec, sup.tvec, batch.line2d.start,
                      batch.line2d.end, weights, vps, vp_w, *hm, views.kvec,
                      views.qvec, views.tvec, *fc)
    terms = lm_line_refine.RefineTerms(
        use_geometric=cfg.use_geometric, use_heatmap=use_heatmap,
        use_fconsis=use_fconsis, geometric_alpha=cfg.geometric_alpha,
        loss=cfg.loss, loss_scale=cfg.loss_scale,
        heatmap_multiplier=cfg.heatmap_multiplier,
        fconsis_multiplier=cfg.fconsis_multiplier)
    return params0, RefineData(*(t.contiguous() for t in data)), terms


def solve_line_refinement(
        batch: TrackBatch, views: CameraViewsBatch,
        cfg: RefinementConfig = RefinementConfig(),
        track_vps: Optional[torch.Tensor] = None,
        track_has_vp: Optional[torch.Tensor] = None,
        heatmap_data=None, fconsis_data=None, num_iterations: int = 20):
    """Refine all tracks; optional per-(track, support) VP constraints
    (``track_vps`` [T, S, 3] homogeneous pixels, ``track_has_vp`` [T, S]
    bool), heatmap terms (``heatmap_data`` from
    :func:`build_heatmap_patches`) and feature-consistency terms
    (``fconsis_data`` from :func:`build_fconsis_terms`).  Returns the
    refined minimal lines and the LM diagnostics."""
    params0, data, terms = refine_data(batch, views, cfg, track_vps,
                                       track_has_vp, heatmap_data,
                                       fconsis_data)
    result = lm_line_refine.solve(params0, data, terms, num_iterations)
    return unpack_minimal_lines(result.params), result


def support_vps(batch: TrackBatch, vpresults):
    """Each support's VP (homogeneous pixels) [T, S, 3] and whether it has
    one [T, S], from per-image VP results."""
    T, S = batch.mask.shape
    vps = np.zeros((T, S, 3), np.float32)
    has = np.zeros((T, S), bool)
    img_ids = batch.image_ids.cpu().numpy()
    line_ids = batch.line_ids.cpu().numpy()
    ti, si = np.nonzero(batch.mask.cpu().numpy())
    for t, s in zip(ti, si):
        resu = vpresults.get(int(img_ids[t, s]))
        lid = int(line_ids[t, s])
        if resu is not None and lid < resu.count_lines() and resu.HasVP(lid):
            vps[t, s] = resu.GetVP(lid)
            has[t, s] = True
    dev = batch.mask.device
    return torch.as_tensor(vps, device=dev), torch.as_tensor(has, device=dev)


def line_refinement(cfg, tracks: List[LineTrack], imagecols,
                    vpresults: Optional[Dict[int, "object"]] = None,
                    num_iterations: int = 20, device=None
                    ) -> List[LineTrack]:
    """Refine tracks with fixed cameras, re-trim their segments from the
    2D supports and return new tracks; ``cfg`` a dict or a
    :class:`RefinementConfig`."""
    device = resolve_device(device)
    if not tracks:
        return tracks
    rcfg = RefinementConfig.from_dict(cfg) if isinstance(cfg, dict) else cfg
    views = imagecols.batch(device)
    batch = tracks_to_batch(tracks, imagecols.img_id_to_index(),
                            device=device)
    track_vps = track_has_vp = None
    if vpresults is not None and rcfg.use_vp:
        track_vps, track_has_vp = support_vps(batch, vpresults)
    refined, _ = solve_line_refinement(batch, views, rcfg, track_vps,
                                       track_has_vp,
                                       num_iterations=num_iterations)
    out = get_output_tracks(batch, views, refined,
                            rcfg.num_outliers_aggregator)
    return batch_to_tracks(out)
