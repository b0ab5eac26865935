"""Cambridge Landmarks pipeline glue (reference:
runners/cambridge/utils.py).

Portable pieces: train/query split resolution, query-list writing,
result-file naming, and the dataset's pose evaluation protocol (median
errors + the 7-threshold recall table).  ``run_hloc_cambridge`` drives
hloc (retrieval, features, matching, known-pose SfM, point-only
localization) and is IMPORT-GATED like runners/7scenes/utils.py.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from limap_tpu_torch.base.camera import CameraPose

COLMAP_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE",
    10: "THIN_PRISM_FISHEYE",
}


def get_scene_info(vsfm_path, imagecols, query_images=None):
    """Train/query image-id split from the dataset's
    dataset_train.txt / dataset_test.txt (reference get_scene_info)."""
    with open(os.path.join(vsfm_path, "dataset_train.txt")) as f:
        train_names = [ln.split()[0] for ln in f.readlines()[3:]]
    query_start_idx = 0
    if query_images is None:
        query_images = os.path.join(vsfm_path, "dataset_test.txt")
        query_start_idx = 3
    with open(query_images) as f:
        query_names = [ln.split()[0]
                       for ln in f.readlines()[query_start_idx:]]

    train_ids, query_ids, id_to_origin_name = [], [], {}
    for img_id in imagecols.get_img_ids():
        name = "/".join(
            imagecols.camimage(img_id).image_name.split("/")[-2:])
        if name in train_names:
            train_ids.append(img_id)
        if name in query_names:
            query_ids.append(img_id)
        id_to_origin_name[img_id] = name
    return train_ids, query_ids, id_to_origin_name


def create_query_list(imagecols, out) -> None:
    """hloc query list with intrinsics (reference create_query_list)."""
    data = []
    for img_id in imagecols.get_img_ids():
        cam = imagecols.cam(imagecols.camimage(img_id).cam_id)
        name = imagecols.camimage(img_id).image_name.split("/")[-1]
        p = [name, cam.model_name, cam.w(), cam.h()] + list(cam.params)
        data.append(" ".join(map(str, p)))
    with open(out, "w") as f:
        f.write("\n".join(data))


def get_result_filenames(cfg):
    """Reference get_result_filenames (Cambridge variant — no
    dense/sparse prefix)."""
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
            else "{}-{}".format(ransac_cfg["thres_point"],
                                ransac_cfg["thres_line"]))
    results_point = "results_point.txt"
    results_joint = "results_joint_{}{}{}{}{}.txt".format(
        "{}_".format(cfg["2d_matcher"]),
        ("{}_".format(cfg["reprojection_filter"])
         if cfg.get("reprojection_filter") is not None else ""),
        ("filtered_" if cfg["2d_matcher"] == "superglue_endpoints"
         and cfg.get("epipolar_filter") else ""),
        cfg["line_cost_func"], ransac_postfix)
    return results_point, results_joint


def evaluate(filename, poses_gt, query_ids, id_to_name, logger=None):
    """Median pose errors + the Cambridge recall table (reference
    eval): thresholds (1cm,1deg) ... (5m,10deg)."""
    errors_t, errors_R = [], []
    pose_results = {}
    with open(filename) as f:
        for data in f.read().rstrip().split("\n"):
            tok = data.split()
            if not tok:
                continue
            q, t = np.split(np.array(tok[1:8], float), [4])
            pose_results[tok[0]] = CameraPose(qvec=q, tvec=t)

    for qid in query_ids:
        name = id_to_name[qid]
        key = name if name in pose_results else name.split("/")[-1]
        if key not in pose_results:
            e_t, e_R = np.inf, 180.0
        else:
            gt = poses_gt[qid]
            R_gt, t_gt = gt.R(), gt.tvec
            est = pose_results[key]
            R, t = est.R(), est.tvec
            e_t = np.linalg.norm(-R_gt.T @ t_gt + R.T @ t)
            cos = np.clip((np.trace(R_gt.T @ R) - 1) / 2, -1.0, 1.0)
            e_R = np.rad2deg(np.abs(np.arccos(cos)))
        errors_t.append(e_t)
        errors_R.append(e_R)
    errors_t = np.asarray(errors_t)
    errors_R = np.asarray(errors_R)

    out = {"median_t": float(np.median(errors_t)),
           "median_R": float(np.median(errors_R)), "recall": {}}
    threshs_t = [0.01, 0.02, 0.03, 0.05, 0.25, 0.5, 5.0]
    threshs_R = [1.0, 2.0, 3.0, 5.0, 2.0, 5.0, 10.0]
    text = (f"Results for file {filename}:\nMedian errors: "
            f"{out['median_t']:.3f}m, {out['median_R']:.3f}deg"
            "\nPercentage of test images localized within:")
    for th_t, th_R in zip(threshs_t, threshs_R):
        ratio = float(np.mean((errors_t < th_t) & (errors_R < th_R)))
        out["recall"][f"{th_t * 100:.0f}cm_{th_R:.0f}deg"] = ratio
        text += f"\n\t{th_t * 100:.0f}cm, {th_R:.0f}deg : " \
                f"{ratio * 100:.2f}%"
    (logger.info if logger else print)(text)
    return out


def run_hloc_cambridge(cfg, image_dir, imagecols, neighbors, train_ids,
                       query_ids, id_to_origin_name, results_file,
                       num_loc: int = 10, logger=None):
    """Drive hloc end-to-end for a Cambridge scene (NetVLAD retrieval,
    SuperPoint features, SuperGlue matching, known-pose SfM, point-only
    localization) — the reference run_hloc_cambridge flow.  Requires
    ``hloc`` importable; raises ImportError with instructions
    otherwise."""
    try:
        import pycolmap
        from hloc import (extract_features, localize_sfm,
                          match_features, pairs_from_retrieval)
    except ImportError as exc:
        raise ImportError(
            "run_hloc_cambridge drives the external hloc toolbox "
            "(github.com/cvg/Hierarchical-Localization); install it, "
            "or feed point correspondences via --point_corresp"
        ) from exc
    from limap_tpu_torch.pointsfm.colmap_sfm import \
        run_colmap_sfm_with_known_poses

    feature_conf = {
        "output": "feats-superpoint-n4096-r1024",
        "model": {"name": "superpoint", "nms_radius": 3,
                  "max_keypoints": 4096},
        "preprocessing": {"grayscale": True, "resize_max": 1024},
    }
    retrieval_conf = extract_features.confs["netvlad"]
    matcher_conf = match_features.confs["superglue"]

    results_file = Path(results_file)
    results_dir = results_file.parent
    query_list = results_dir / "query_list_with_intrinsics.txt"
    loc_pairs = results_dir / f"pairs-query-netvlad{num_loc}.txt"
    image_list = [f"image{i:08d}.png" for i in (train_ids + query_ids)]

    imagecols_train = imagecols.subset_by_image_ids(train_ids)
    imagecols_query = imagecols.subset_by_image_ids(query_ids)
    create_query_list(imagecols_query, query_list)

    global_descriptors = extract_features.main(
        retrieval_conf, Path(cfg["output_dir"]) / image_dir,
        results_dir, image_list=image_list)
    pairs_from_retrieval.main(
        global_descriptors, loc_pairs, num_loc,
        db_list=[f"image{i:08d}.png" for i in train_ids],
        query_list=[f"image{i:08d}.png" for i in query_ids])
    features = extract_features.main(
        feature_conf, Path(cfg["output_dir"]) / image_dir, results_dir,
        as_half=True, image_list=image_list)
    loc_matches = match_features.main(
        matcher_conf, loc_pairs, feature_conf["output"], results_dir)

    neighbors_train = imagecols_train.update_neighbors(neighbors)
    ref_sfm_path = run_colmap_sfm_with_known_poses(
        cfg.get("sfm", {}), imagecols_train,
        os.path.join(cfg["output_dir"], "tmp_colmap"),
        neighbors=neighbors_train,
        skip_exists=cfg.get("skip_exists", False))
    ref_sfm = pycolmap.Reconstruction(ref_sfm_path)

    if not os.path.exists(results_file):
        localize_sfm.main(
            ref_sfm, query_list, loc_pairs, features, loc_matches,
            results_file, covisibility_clustering=False)
    return (ref_sfm, str(results_dir / "logs.pkl"), features,
            loc_matches)
