"""InLoc pipeline glue (reference: runners/inloc/utils.py).

Portable pieces: the scan-cut point-map reader (.mat XYZcut), dataset
enumeration with InLoc's iphone7 intrinsics convention, result-file
naming, and coarse-pose reading.  ``run_hloc_inloc`` drives hloc's
InLoc localization and is IMPORT-GATED like runners/7scenes/utils.py.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.base.p3d_reader_base import BaseP3DReader


class InLocP3DReader(BaseP3DReader):
    """RGBD scan cut: <image>.mat 'XYZcut' [H, W, 3] world points."""

    def read(self, filename):
        from scipy.io import loadmat
        return loadmat(str(filename) + ".mat")["XYZcut"]


def parse_retrieval_pairs(loc_pairs):
    """{query: [db, ...]} from an hloc retrieval pairs file."""
    out = {}
    with open(loc_pairs) as f:
        for line in f:
            tok = line.strip().split()
            if len(tok) >= 2:
                out.setdefault(tok[0], []).append(tok[1])
    return out


def read_dataset_inloc(cfg, dataset_dir, loc_pairs, exclude_CSE=True,
                       get_scan_pose=None, logger=None):
    """Enumerate the InLoc images -> (ImageCollection, train_ids,
    query_ids, names, scales).  Database (scan) images get their
    cam2world scan pose via ``get_scan_pose(dataset_dir, name)``
    (hloc.localize_inloc.get_scan_pose when driving hloc; injectable
    for offline use); queries get identity poses and the dataset's
    35mm-equivalent f=28 mm intrinsics."""
    dataset_dir = Path(dataset_dir)
    retrieval_dict = parse_retrieval_pairs(loc_pairs)
    queries = set(retrieval_dict.keys())

    paths = []
    for g in ["*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG"]:
        paths += list(dataset_dir.glob("**/" + g))
    if not paths:
        raise ValueError(f"Could not find any image in {dataset_dir}.")
    names = sorted({p.relative_to(dataset_dir).as_posix()
                    for p in paths})
    if exclude_CSE:
        names = [n for n in names if "CSE" not in n]
    if logger:
        logger.info(f"Found {len(names)} images in {dataset_dir}, "
                    f"excluding CSE scenes: {exclude_CSE}")

    from PIL import Image
    cameras, images = {}, {}
    train_ids, query_ids = [], []
    max_dim = cfg.get("max_image_dim", -1)
    scales = {} if max_dim not in (-1, None) else None
    for img_id, name in enumerate(names):
        with Image.open(str(dataset_dir / name)) as im:
            width, height = im.size
        # InLoc convention: 28 mm-equivalent focal on a 36 mm sensor
        focal = max(width, height) * 28.0 / 36.0
        cameras[img_id] = Camera(
            model="SIMPLE_PINHOLE",
            params=[focal, 0.5 * width, 0.5 * height],
            cam_id=img_id, hw=(height, width))
        pose = CameraPose()
        if name in queries:
            query_ids.append(img_id)
            if scales is not None:
                scales[name] = max_dim / max(width, height)
        else:
            train_ids.append(img_id)
            if get_scan_pose is not None:
                Tr = get_scan_pose(dataset_dir, name)
                R = Tr[:3, :3].T
                t = (-R @ Tr[:3, -1:]).reshape(-1)
                pose = CameraPose(R=R, tvec=t)
        images[img_id] = CameraImage(img_id, pose,
                                     str(dataset_dir / name))
    return (ImageCollection(cameras, images), train_ids, query_ids,
            names, scales)


def get_result_filenames(cfg, use_temporal=True):
    """Reference get_result_filenames (InLoc variant)."""
    ransac_cfg = cfg["ransac"]
    ransac_postfix = ""
    if ransac_cfg["method"] is not None:
        if ransac_cfg["method"] in ["ransac", "hybrid"]:
            ransac_postfix = "_{}".format(ransac_cfg["method"])
        elif ransac_cfg["method"] == "solver":
            ransac_postfix = "_sfransac"
        else:
            raise ValueError(
                f"Unsupported ransac method: {ransac_cfg['method']}")
        ransac_postfix += "_{}".format(
            ransac_cfg["thres"] if ransac_cfg["method"] != "hybrid"
            else "{}_{}".format(ransac_cfg["thres_point"],
                                ransac_cfg["thres_line"]))
        ransac_postfix += ("_{}".format(ransac_cfg["weight_line"])
                           if ransac_cfg["method"] == "hybrid" else "")
    results_point = "results_{}point.txt".format(
        "temporal_" if use_temporal else "")
    results_joint = "results_newlsq_{}joint_{}{}{}{}{}.txt".format(
        "temporal_" if use_temporal else "",
        "{}_".format(cfg["2d_matcher"]),
        ("{}_".format(cfg["reprojection_filter"])
         if cfg.get("reprojection_filter") is not None else ""),
        ("filtered_" if cfg["2d_matcher"] == "superglue_endpoints"
         and cfg.get("epipolar_filter") else ""),
        cfg["line_cost_func"], ransac_postfix)
    return results_point, results_joint


def read_coarse_poses(results_file,
                      query_prefix: str = "query/iphone7/"):
    """Coarse per-query poses from an hloc/InLoc results txt."""
    poses = {}
    with open(results_file) as f:
        for data in f.read().rstrip().split("\n"):
            tok = data.split()
            if not tok:
                continue
            q, t = np.split(np.array(tok[1:8], float), [4])
            poses[query_prefix + tok[0]] = CameraPose(qvec=q, tvec=t)
    return poses


def run_hloc_inloc(cfg, dataset, loc_pairs, results_file, num_skip=15,
                   logger=None):
    """Drive hloc's InLoc point localization (the reference
    run_hloc_inloc flow).  Requires ``hloc`` importable; raises
    ImportError with instructions otherwise."""
    try:
        from hloc import extract_features, localize_inloc, \
            match_features
    except ImportError as exc:
        raise ImportError(
            "run_hloc_inloc drives the external hloc toolbox "
            "(github.com/cvg/Hierarchical-Localization); install it, "
            "or feed coarse poses via read_coarse_poses on a "
            "precomputed results file") from exc

    feature_conf = extract_features.confs["superpoint_inloc"]
    feature_conf["model"]["nms_radius"] = 3
    matcher_conf = match_features.confs["superglue"]
    results_file = Path(results_file)
    results_dir = results_file.parent
    feature_path = extract_features.main(feature_conf, dataset,
                                         results_dir)
    match_path = match_features.main(matcher_conf, loc_pairs,
                                     feature_conf["output"],
                                     results_dir)
    if not os.path.exists(results_file):
        if logger:
            logger.info("Running point-only localization...")
        localize_inloc.main(dataset, loc_pairs, feature_path,
                            match_path, results_file,
                            skip_matches=num_skip)
    poses = read_coarse_poses(results_file)
    return poses, f"{results_file}_logs.pkl"
