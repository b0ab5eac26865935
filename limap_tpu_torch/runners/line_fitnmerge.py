"""Fit and merge: line mapping from posed images with depth.

[A] metainfos -> [B] 2D detection -> [C] 3D segments fitted to the depth
of every image (one batched RANSAC over all segments) -> [D] tracks from
the linker's edge test -> reprojection filter / remerge fixpoint -> [E]
optional line BA -> [F] save.  ``line_fitting_with_points3d`` fits to
dense per-pixel point maps instead of depth maps.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

import limap_tpu_torch.runners.functions as runners
from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import LineLinker, LineLinker3dConfig
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import (LineTrack, batch_to_tracks,
                                            tracks_to_batch)
from limap_tpu_torch.evaluation.evaluator import report_track_stats
from limap_tpu_torch.fitting.fitting import (depth_fit_inputs,
                                             draw_hypotheses,
                                             fit_lines_from_hypotheses,
                                             points3d_fit_inputs)
from limap_tpu_torch.merging.merging import (filter_tracks_by_reprojection,
                                             merge_to_linetracks, remerge,
                                             set_uncertainty_segs3d)
from limap_tpu_torch.optimize.line_ba import (LineBAConfig,
                                              get_output_tracks,
                                              solve_line_bundle_adjustment)
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.profiler import StageProfiler

DEFAULT_VAR2D = {"lsd": 2.0, "tpu_lsd": 2.0, "sold2": 5.0, "hawpv3": 5.0,
                 "tp_lsd": 5.0, "deeplsd": 4.0}
N_SAMPLES = 64
N_HYPOTHESES = 32


def _fit_all(all_2d_segs, imagecols, fitting_config, seed, device,
             fit_inputs):
    """Every image's RANSAC inputs (``fit_inputs(seg2d, view, img_id)``)
    and hypotheses, drawn per image in image-id order from one generator
    seeded by ``seed``, fitted in one batch; {img_id: [N, 2, 3] float32},
    failed fits as zero rows."""
    gen = torch.Generator().manual_seed(int(seed))
    views = imagecols.batch(device)
    id2idx = imagecols.img_id_to_index()
    ransac_th = fitting_config.get("ransac_th", 0.75)
    var2d = fitting_config.get("var2d", 2.0)
    inputs, rows, out = [], [], {}
    for img_id in imagecols.get_img_ids():
        segs = np.asarray(all_2d_segs[img_id], np.float32)
        if len(segs) == 0:
            out[img_id] = np.zeros((0, 2, 3), np.float32)
            continue
        seg2d = Segments(torch.as_tensor(segs[:, :2], device=device),
                         torch.as_tensor(segs[:, 2:4], device=device))
        points, valid, th = fit_inputs(seg2d, views.select(id2idx[img_id]),
                                       img_id, ransac_th, var2d)
        inputs.append((points, valid, th, *draw_hypotheses(
            len(segs), N_SAMPLES, N_HYPOTHESES, gen)))
        rows.append((img_id, len(segs)))
    if not inputs:
        return out
    fitted = fit_lines_from_hypotheses(
        *(torch.cat(parts) for parts in zip(*inputs)),
        min_inlier_ratio=fitting_config.get("min_percentage_inliers", 0.9))
    arr = torch.stack([fitted.start, fitted.end], 1).cpu().numpy()
    start = 0
    for img_id, n in rows:
        out[img_id] = arr[start:start + n]
        start += n
    return out


def fit_3d_segs(all_2d_segs: Dict[int, np.ndarray], imagecols, depths,
                fitting_config: dict, seed: int = 0,
                device=None) -> Dict[int, np.ndarray]:
    """3D segments of every image from its depth map (``depths``:
    {img_id: depth reader}); {img_id: [N, 2, 3]}, zero rows where the
    fit failed.  The RANSAC kernel launches once for all images."""
    device = resolve_device(device)

    def inputs(seg2d, view, img_id, ransac_th, var2d):
        cam = imagecols.camview(img_id)
        depth = depths[img_id].read_depth(img_hw=[cam.h(), cam.w()])
        return depth_fit_inputs(
            seg2d, torch.as_tensor(np.asarray(depth, np.float32),
                                   device=device),
            view, ransac_th, var2d, N_SAMPLES)

    return _fit_all(all_2d_segs, imagecols, fitting_config, seed, device,
                    inputs)


def fit_3d_segs_with_points3d(all_2d_segs, imagecols, p3d_readers,
                              fitting_config: dict, seed: int = 0,
                              device=None) -> Dict[int, np.ndarray]:
    """The point-map variant of :func:`fit_3d_segs`: ``p3d_readers``
    {img_id: reader} with ``read(None)`` -> [H, W, 3] world points."""
    device = resolve_device(device)

    def inputs(seg2d, view, img_id, ransac_th, var2d):
        cam = imagecols.camview(img_id)
        p3d = np.asarray(p3d_readers[img_id].read(None), np.float32)
        return points3d_fit_inputs(
            seg2d, torch.as_tensor(p3d, device=device), view,
            (cam.h(), cam.w()), ransac_th, var2d, N_SAMPLES)

    return _fit_all(all_2d_segs, imagecols, fitting_config, seed, device,
                    inputs)


def _pad_per_image(all_2d_segs, seg3d_list, img_ids):
    """[I, L] padded 2D segments, 3D segments and the mask of lines with
    a fitted (non-zero-length) 3D segment."""
    L = max(max((len(all_2d_segs[i]) for i in img_ids), default=1), 1)
    I = len(img_ids)
    l2d = np.zeros((I, L, 4), np.float32)
    l3d = np.zeros((I, L, 2, 3), np.float32)
    mask = np.zeros((I, L), bool)
    for row, img_id in enumerate(img_ids):
        segs = np.asarray(all_2d_segs[img_id], np.float32)
        n = len(segs)
        if n:
            l2d[row, :n] = segs[:, :4]
            l3d[row, :n] = seg3d_list[img_id][:n]
            mask[row, :n] = np.linalg.norm(
                l3d[row, :n, 1] - l3d[row, :n, 0], axis=-1) > 0
    return l2d, l3d, mask


def _set_var2d(cfg: dict, sections) -> None:
    detector = cfg["line2d"]["detector"]["method"]
    for name in sections:
        if cfg[name].get("var2d", -1) == -1:
            cfg[name]["var2d"] = DEFAULT_VAR2D.get(detector, 2.0)


def line_fitnmerge(cfg: dict, imagecols, depths,
                   neighbors: Optional[dict] = None, ranges=None,
                   device=None) -> List[LineTrack]:
    """Main interface of fit and merge, from posed images and their depth
    readers ({img_id: reader}) to the saved line tracks.  Device work
    runs on ``device`` (``None`` means cuda).  Writes the detections,
    ``fitted_3d_segs.npy``, ``fitnmerge_metrics.json`` (stage seconds
    ``detect``, ``fit_3d_segs``, ``merge_to_tracks``), the output folder,
    ``fitnmerge_alltracks.txt`` and ``fitnmerge_lines_nv{n}.obj`` under
    ``cfg["output_dir"]``.  With ``load_fit`` the fitted segments are
    read from ``dir_load`` instead."""
    device = resolve_device(device)
    cfg = runners.setup(cfg)
    prof = StageProfiler(device=device)
    _set_var2d(cfg, ("fitting", "merging"))
    if cfg.get("max_image_dim", -1) not in (-1, None):
        imagecols.set_max_image_dim(cfg["max_image_dim"])

    # [A] metainfos
    if neighbors is None:
        _, neighbors, ranges = runners.compute_sfminfos(cfg, imagecols)
    else:
        neighbors = imagecols.update_neighbors(neighbors)
        for img_id in neighbors:
            neighbors[img_id] = neighbors[img_id][:cfg["n_neighbors"]]

    # [B] 2D segments
    with prof.stage("detect"):
        all_2d_segs, _ = runners.compute_2d_segs(
            cfg, imagecols, compute_descinfo=False, device=device)

    # [C] 3D segments from depth
    fname_fit = "fitted_3d_segs.npy"
    if not cfg.get("load_fit", False):
        with prof.stage("fit_3d_segs"):
            seg3d_list = fit_3d_segs(all_2d_segs, imagecols, depths,
                                     cfg["fitting"], device=device)
        limapio.save_npy(os.path.join(cfg["dir_save"], fname_fit), seg3d_list)
    else:
        seg3d_list = limapio.read_npy(
            os.path.join(cfg["dir_load"], fname_fit)).item()

    # [D] tracks; padded neighbour slots index row 0 under a false mask
    img_ids = imagecols.get_img_ids()
    id2row = {img_id: i for i, img_id in enumerate(img_ids)}
    l2d, l3d, mask = _pad_per_image(all_2d_segs, seg3d_list, img_ids)
    views = imagecols.batch(device)
    K = max(max((len(neighbors[i]) for i in img_ids), default=1), 1)
    nbrs = np.zeros((len(img_ids), K), np.int64)
    nmask = np.zeros_like(nbrs, bool)
    for row, img_id in enumerate(img_ids):
        for k, ng in enumerate(neighbors[img_id][:K]):
            nbrs[row, k] = id2row[ng]
            nmask[row, k] = True
    t = lambda a: torch.as_tensor(a, device=device)
    linker = LineLinker.from_dicts(cfg["merging"].get("linker2d"),
                                   cfg["merging"].get("linker3d"))
    vb = CameraViewsBatch(*(x[:, None] for x in views))
    seg3d = set_uncertainty_segs3d(
        Segments(t(l3d[:, :, 0]), t(l3d[:, :, 1])), vb,
        cfg["merging"]["var2d"])
    seg2d = Segments(t(l2d[..., :2]), t(l2d[..., 2:4]))
    with prof.stage("merge_to_tracks"):
        linetracks = merge_to_linetracks(
            seg2d, seg3d, t(mask), views, t(nbrs), t(nmask), linker,
            image_ids=np.asarray(img_ids))

    # reprojection filter, remerge fixpoint, reprojection filter
    def filter_reproj(tracks):
        if not tracks:
            return tracks
        tb = filter_tracks_by_reprojection(
            tracks_to_batch(tracks, id2row, device=device), views,
            cfg["filtering2d"]["th_angular_2d"],
            cfg["filtering2d"]["th_perp_2d"], num_outliers=0)
        return [x for x in batch_to_tracks(tb) if x.count_lines() > 0]

    linetracks = filter_reproj(linetracks)
    if not cfg["remerging"].get("disable", False) and linetracks:
        linker3d = LineLinker3dConfig.from_dict(
            cfg["remerging"].get("linker3d"))
        linetracks = remerge(linetracks, views, id2row, linker3d,
                             num_outliers=0)
        linetracks = filter_reproj(linetracks)

    # [E] optional line BA
    if not cfg["refinement"].get("disable", True) and linetracks:
        tb = tracks_to_batch(linetracks, id2row, device=device)
        ba_cfg = LineBAConfig.from_dict(cfg["refinement"])
        refined, _ = solve_line_bundle_adjustment(tb, views, ba_cfg)
        linetracks = batch_to_tracks(get_output_tracks(
            tb, views, refined, ba_cfg.num_outliers_aggregator))
    linetracks = [x for x in linetracks if x.length() > 0]

    with open(os.path.join(cfg["dir_save"], "fitnmerge_metrics.json"),
              "w") as f:
        json.dump({"stages_s": prof.report(),
                   "tracks": report_track_stats(
                       linetracks, cfg["n_visible_views"])}, f, indent=1)

    # [F] save
    output_folder = cfg.get("output_folder") or "fitnmerge_finaltracks"
    limapio.save_folder_linetracks_with_info(
        os.path.join(cfg["dir_save"], output_folder), linetracks,
        config=cfg, imagecols=imagecols, all_2d_segs=all_2d_segs)
    limapio.save_txt_linetracks(
        os.path.join(cfg["dir_save"], "fitnmerge_alltracks.txt"),
        linetracks, n_visible_views=4)
    nv = cfg["n_visible_views"]
    valid = [x.line for x in linetracks if x.count_images() >= nv]
    limapio.save_obj(
        os.path.join(cfg["dir_save"], f"fitnmerge_lines_nv{nv}.obj"),
        np.stack(valid) if valid else np.zeros((0, 2, 3)))
    return linetracks


def line_fitting_with_points3d(cfg: dict, imagecols, p3d_readers,
                               neighbors=None, ranges=None,
                               device=None) -> List[LineTrack]:
    """Fit and merge over per-pixel point maps: detection and the fit
    here, then :func:`line_fitnmerge` on the saved detections and fitted
    segments."""
    device = resolve_device(device)
    cfg = runners.setup(cfg)
    _set_var2d(cfg, ("fitting",))
    all_2d_segs, _ = runners.compute_2d_segs(cfg, imagecols,
                                             compute_descinfo=False,
                                             device=device)
    seg3d_list = fit_3d_segs_with_points3d(all_2d_segs, imagecols,
                                           p3d_readers, cfg["fitting"],
                                           device=device)
    limapio.save_npy(os.path.join(cfg["dir_save"], "fitted_3d_segs.npy"),
                     seg3d_list)
    cfg = dict(cfg, load_fit=True, load_dir=cfg["dir_save"], load_det=True)
    return line_fitnmerge(cfg, imagecols, depths=None, neighbors=neighbors,
                          ranges=ranges, device=device)
