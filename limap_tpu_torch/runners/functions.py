"""Shared pipeline stages (setup, detection, matching, sfm metainfos),
with ``skip_exists`` stage idempotence: every stage caches its result in
the output folder and can be resumed or loaded from it."""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import numpy as np

import limap_tpu_torch.line2d as line2d
from limap_tpu_torch.util import io as limapio


def setup(cfg: dict) -> dict:
    """Resolve the output and load folders into ``dir_save`` /
    ``dir_load``."""
    folder_save = cfg.get("output_dir") or "tmp"
    limapio.check_makedirs(folder_save)
    folder_load = cfg.get("load_dir")
    if cfg.get("use_tmp"):
        folder_load = "tmp"
    if folder_load is None:
        folder_load = folder_save
    cfg["dir_save"] = folder_save
    cfg["dir_load"] = folder_load
    return cfg


def undistort_images(imagecols, output_dir: str, skip_exists: bool = False):
    """Undistort every image of a distorted camera into ``output_dir``
    (``image{img_id:08d}.png``) with OpenCV, its camera turned PINHOLE
    with the same K; pinhole collections pass through.  Returns a new
    collection; the given one is left as it was.  (The JAX package
    writes only the first image of each camera and renames the others
    to files it never writes; ROADMAP.md section 3.)"""
    from limap_tpu_torch.undistortion import (undistort_camera,
                                              undistort_image_camera)
    if imagecols.IsUndistorted():
        return imagecols
    limapio.check_makedirs(output_dir)
    out = copy.deepcopy(imagecols)
    for img_id in imagecols.get_img_ids():
        cam_id = imagecols.camimage(img_id).cam_id
        cam = imagecols.cam(cam_id)
        if cam.is_undistorted():
            continue
        imname_out = os.path.join(output_dir, f"image{img_id:08d}.png")
        if skip_exists and os.path.exists(imname_out):
            new_cam = undistort_camera(cam)
        else:
            new_cam = undistort_image_camera(
                cam, imagecols.image_name(img_id), imname_out)
        new_cam.camera_id = cam_id
        out.change_camera(cam_id, new_cam)
        out.change_image_name(img_id, imname_out)
    return out


def compute_sfminfos(cfg: dict, imagecols, points3d: Optional[dict] = None,
                     images: Optional[dict] = None,
                     fname: str = "metainfos.txt", device=None):
    """Visual neighbours + robust ranges, saved to ``fname``.  The point
    model is (a) given (``points3d`` = {pid: {xyz, image_ids}}), (b)
    triangulated from ``images`` against the known poses on ``device``
    (:func:`pointsfm.sfm.run_sfm_with_known_poses`), or (c) absent: then
    the neighbours come from pose proximity and the ranges from the pose
    extents.  ``load_meta`` reads both from ``dir_load``."""
    from limap_tpu_torch.pointsfm import SfmModel, compute_metainfos
    if not cfg.get("load_meta", False):
        if points3d is None and images is not None:
            from limap_tpu_torch.pointsfm.sfm import run_sfm_with_known_poses
            points3d = run_sfm_with_known_poses(
                imagecols, images=images,
                n_neighbors=cfg.get("n_neighbors", 20),
                weight_path=cfg.get("weight_path"), device=device)
        if points3d:
            model = SfmModel.from_imagecols_and_points(imagecols, points3d)
            neighbors, ranges = compute_metainfos(
                cfg.get("sfm", {}), model,
                n_neighbors=cfg.get("n_neighbors", 20))
        else:
            neighbors = compute_pose_neighbors(imagecols,
                                               cfg.get("n_neighbors", 20))
            ranges = compute_pose_ranges(imagecols)
        limapio.save_txt_metainfos(os.path.join(cfg["dir_save"], fname),
                                   neighbors, ranges)
    else:
        neighbors, ranges = limapio.read_txt_metainfos(
            os.path.join(cfg["dir_load"], fname))
        for img_id in neighbors:
            neighbors[img_id] = neighbors[img_id][:cfg.get("n_neighbors", 20)]
    return None, neighbors, ranges


def compute_pose_neighbors(imagecols, n_neighbors: int):
    """Neighbour ranking by camera-centre distance."""
    ids = imagecols.get_img_ids()
    centers = np.stack([imagecols.campose(i).center() for i in ids])
    d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    out = {}
    for k, img_id in enumerate(ids):
        order = np.argsort(d[k])[:n_neighbors]
        out[img_id] = [ids[j] for j in order]
    return out


def compute_pose_ranges(imagecols, stretch: float = 10.0):
    centers = np.stack([imagecols.campose(i).center()
                        for i in imagecols.get_img_ids()])
    lo = centers.min(0)
    hi = centers.max(0)
    mid = 0.5 * (lo + hi)
    half = np.maximum(0.5 * (hi - lo), 1.0) * stretch
    return (mid - half, mid + half)


def compute_2d_segs(cfg: dict, imagecols, compute_descinfo: bool = True,
                    device=None):
    """Detect (+ describe) 2D lines on ``device``; returns ({img_id:
    segments}, descinfo folder or None)."""
    basedir = os.path.join("line_detections",
                           cfg["line2d"]["detector"]["method"])
    folder_save = os.path.join(cfg["dir_save"], basedir)
    se_det = cfg.get("skip_exists", False) \
        or cfg["line2d"]["detector"].get("skip_exists", False)
    detector = line2d.get_detector(
        cfg["line2d"]["detector"],
        max_num_2d_segs=cfg["line2d"].get("max_num_2d_segs", 3000),
        do_merge_lines=cfg["line2d"].get("do_merge_lines", False),
        weight_path=cfg.get("weight_path"), device=device)
    if not cfg.get("load_det", False):
        all_2d_segs = detector.detect_all_images(folder_save, imagecols,
                                                 skip_exists=se_det)
    else:
        folder_load = os.path.join(cfg["dir_load"], basedir)
        all_2d_segs = limapio.read_all_segments_from_folder(
            detector.get_segments_folder(folder_load))
        all_2d_segs = {i: all_2d_segs[i] for i in imagecols.get_img_ids()}
    descinfo_folder = None
    if compute_descinfo:
        se_ext = cfg.get("skip_exists", False) \
            or cfg["line2d"]["extractor"].get("skip_exists", False)
        extractor = line2d.get_extractor(
            cfg["line2d"]["extractor"], weight_path=cfg.get("weight_path"),
            device=device)
        descinfo_folder = extractor.extract_all_images(
            folder_save, imagecols, all_2d_segs, skip_exists=se_ext)
    return all_2d_segs, descinfo_folder


def compute_matches(cfg: dict, descinfo_folder: str, image_ids: List[int],
                    neighbors: Dict[int, List[int]], device=None):
    """Match lines with the visual neighbours on ``device``; returns the
    matches folder."""
    basedir = os.path.join(
        "line_matchings", cfg["line2d"]["detector"]["method"],
        "feats_{}".format(cfg["line2d"]["extractor"]["method"]))
    extractor = line2d.get_extractor(
        cfg["line2d"]["extractor"], weight_path=cfg.get("weight_path"),
        device=device)
    se_match = cfg.get("skip_exists", False) \
        or cfg["line2d"]["matcher"].get("skip_exists", False)
    matcher = line2d.get_matcher(
        cfg["line2d"]["matcher"], extractor,
        n_neighbors=cfg.get("n_neighbors", 20),
        weight_path=cfg.get("weight_path"), device=device)
    if not cfg.get("load_match", False):
        folder_save = os.path.join(cfg["dir_save"], basedir)
        return matcher.match_all_neighbors(folder_save, image_ids, neighbors,
                                           descinfo_folder,
                                           skip_exists=se_match)
    folder_load = os.path.join(cfg["dir_load"], basedir)
    return matcher.get_matches_folder(folder_load)
