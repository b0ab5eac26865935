"""RGB-only line triangulation pipeline (the flagship runner):
[A] metainfos -> [B] detection + description -> [C] matching ->
[D] multi-view triangulation -> filters / remerge -> [E] BA -> [F] save.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

import limap_tpu_torch.runners.functions as runners
from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.line_linker import LineLinker3dConfig
from limap_tpu_torch.base.linetrack import LineTrack, batch_to_tracks
from limap_tpu_torch.evaluation.evaluator import report_track_stats
from limap_tpu_torch.merging.merging import (compact_track_batch,
                                             filter_chain_batch)
from limap_tpu_torch.optimize.line_ba import (LineBAConfig,
                                              get_output_tracks,
                                              solve_line_bundle_adjustment)
from limap_tpu_torch.triangulation.triangulator import (
    GlobalLineTriangulator, TriangulatorConfig)
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.profiler import StageProfiler

DEFAULT_VAR2D = {"lsd": 2.0, "tpu_lsd": 2.0, "sold2": 5.0, "hawpv3": 5.0,
                 "tp_lsd": 5.0, "deeplsd": 4.0}


def line_triangulation(cfg: dict, imagecols, neighbors: Optional[dict] = None,
                       ranges=None, points3d: Optional[dict] = None,
                       device=None) -> List[LineTrack]:
    """Main interface of multi-view line triangulation, from posed images
    to the saved line tracks.  Device work runs on ``device`` (``None``
    means cuda).  Writes ``imagecols.npy``, ``metainfos.txt``, the
    detection / descriptor / match caches, ``alltracks.txt``, the
    ``finaltracks`` folder, ``metrics.json`` and
    ``triangulated_lines_nv{n}.obj`` under ``cfg["output_dir"]``."""
    device = resolve_device(device)
    cfg = runners.setup(cfg)
    prof = StageProfiler(device=device)
    tri_dict = cfg["triangulation"]
    use_exhaustive = tri_dict.get("use_exhaustive_matcher", False)
    if tri_dict.get("use_vp", False):
        raise NotImplementedError(
            "VP triangulation is not ported yet (ROADMAP.md queue 1 "
            "item 12)")
    detector = cfg["line2d"]["detector"]["method"]
    if tri_dict.get("var2d", -1) == -1:
        tri_dict["var2d"] = DEFAULT_VAR2D.get(detector, 2.0)
    if not imagecols.IsUndistorted():
        imagecols = runners.undistort_images(
            imagecols,
            os.path.join(cfg["dir_save"],
                         cfg.get("undistortion_output_dir",
                                 "undistorted_images")),
            skip_exists=cfg.get("load_undistort", False)
            or cfg.get("skip_exists", False))
    if cfg.get("max_image_dim", -1) not in (-1, None):
        imagecols.set_max_image_dim(cfg["max_image_dim"])
    limapio.save_npy(os.path.join(cfg["dir_save"], "imagecols.npy"),
                     imagecols.as_dict())

    # [A] metainfos
    if neighbors is None:
        _, neighbors, ranges = runners.compute_sfminfos(cfg, imagecols,
                                                        points3d)
    else:
        neighbors = imagecols.update_neighbors(neighbors)
        for img_id in neighbors:
            neighbors[img_id] = neighbors[img_id][:cfg["n_neighbors"]]
        limapio.save_txt_metainfos(
            os.path.join(cfg["dir_save"], "metainfos.txt"), neighbors,
            ranges if ranges is not None
            else runners.compute_pose_ranges(imagecols))

    # [B] 2D segments (+ descriptors unless matching exhaustively)
    with prof.stage("detect_describe"):
        all_2d_segs, descinfo_folder = runners.compute_2d_segs(
            cfg, imagecols, compute_descinfo=not use_exhaustive,
            device=device)

    # [C] matches
    if not use_exhaustive:
        with prof.stage("match"):
            matches_dir = runners.compute_matches(
                cfg, descinfo_folder, imagecols.get_img_ids(), neighbors,
                device=device)

    # [D] triangulation
    triangulator = GlobalLineTriangulator(
        TriangulatorConfig.from_dict(tri_dict), device=device)
    triangulator.init(all_2d_segs, imagecols)
    triangulator.set_ranges(ranges)
    with prof.stage("triangulate_score"):
        if use_exhaustive:
            # every line against every line of each neighbour, all
            # images in as few kernel calls as memory allows
            triangulator.triangulate_all_exhaustive(
                {i: neighbors[i] for i in imagecols.get_img_ids()})
            print(f"exhaustive matcher: {triangulator.exhaustive_stats}",
                  flush=True)
        else:
            matches_by_image = {
                img_id: np.load(
                    os.path.join(matches_dir, f"matches_{img_id}.npy"),
                    allow_pickle=True).item()
                for img_id in imagecols.get_img_ids()}
            triangulator.triangulate_all(matches_by_image)
    with prof.stage("track_build"):
        tb, tb_host = triangulator.compute_track_batch(return_host=True)

    # filters: reprojection -> remerge -> reprojection -> sensitivity ->
    # overlap, all on the device TrackBatch
    views = imagecols.batch(device)
    with prof.stage("filters_remerge"):
        if tb is not None:
            linker3d = None
            if not tri_dict["remerging"].get("disable", False):
                linker3d = LineLinker3dConfig.from_dict(
                    tri_dict["remerging"].get("linker3d"))
            tb, tb_host = filter_chain_batch(
                tb, views, tri_dict["filtering2d"], linker3d, host=tb_host)
            # drop dead tracks and supports before BA
            tb, tb_host = compact_track_batch(
                tb_host.refresh(tb, with_line=True), return_host=True,
                device=device)
            if not tb_host.track_mask.any():
                tb = None

    # [E] geometric refinement
    if not cfg["refinement"].get("disable", False) and tb is not None:
        with prof.stage("bundle_adjustment"):
            ba_cfg = LineBAConfig.from_dict(cfg["refinement"])
            refined, _ = solve_line_bundle_adjustment(tb, views, ba_cfg)
            tb = get_output_tracks(tb, views, refined,
                                   ba_cfg.num_outliers_aggregator)
    linetracks = [t for t in batch_to_tracks(tb, host=tb_host)
                  if t.count_lines() > 0] if tb is not None else []

    # [F] save
    limapio.save_txt_linetracks(
        os.path.join(cfg["dir_save"], "alltracks.txt"), linetracks,
        n_visible_views=4)
    limapio.save_folder_linetracks_with_info(
        os.path.join(cfg["dir_save"], cfg.get("output_folder",
                                              "finaltracks")),
        linetracks, config=cfg, imagecols=imagecols,
        all_2d_segs=all_2d_segs)
    metrics = {"stages_s": prof.report(),
               "tracks": report_track_stats(
                   linetracks, cfg["n_visible_views"]),
               "overflow_edges": int(triangulator.overflow_edges)}
    if use_exhaustive:
        metrics["exhaustive"] = triangulator.exhaustive_stats
    with open(os.path.join(cfg["dir_save"], "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)

    valid = [t.line for t in linetracks
             if t.count_images() >= cfg["n_visible_views"]]
    limapio.save_obj(
        os.path.join(
            cfg["dir_save"],
            f"triangulated_lines_nv{cfg['n_visible_views']}.obj"),
        np.stack(valid) if valid else np.zeros((0, 2, 3)))
    return linetracks
