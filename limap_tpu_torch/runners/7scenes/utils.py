"""7Scenes pipeline glue (reference: runners/7scenes/utils.py).

Portable pieces (no external deps): depth reader, train/test split from
the triangulated SfM model, reference-model creation, depth-corrected
SfM, result-file naming, pose evaluation.  The hloc-driving pipeline
``run_hloc_7scenes`` mirrors the reference's feature/retrieval/SfM/
point-localization flow and is IMPORT-GATED like
limap_tpu_torch.pointsfm.colmap_sfm: with ``hloc`` installed it drives the
real thing; without it, it raises with instructions instead of
silently degrading.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from limap_tpu_torch.base.depth_reader_base import BaseDepthReader
from limap_tpu_torch.pointsfm.colmap_reader import read_model


class SevenScenesDepthReader(BaseDepthReader):
    """Rendered-depth tiff in millimeters; 0 / >1000 m -> inf
    (reference utils.py DepthReader)."""

    def __init__(self, filename, depth_folder):
        super().__init__(filename)
        self.depth_folder = depth_folder

    def read(self, filename):
        import PIL.Image
        depth = PIL.Image.open(Path(self.depth_folder) / filename)
        depth = np.array(depth).astype("float64") / 1000.0
        depth[(depth == 0.0) | (depth > 1000.0)] = np.inf
        return depth


def image_path_to_rendered_depth_path(image_name: str) -> str:
    parts = image_name.split("/")
    name = "_".join(["".join(parts[0].split("-")), parts[1]])
    name = name.replace("color", "pose")
    name = name.replace("png", "depth.tiff")
    return name


def get_train_test_ids_from_sfm(full_model, blacklist=None):
    """Split image ids by the scene's test blacklist
    (reference utils.py get_train_test_ids_from_sfm)."""
    _, images, _, _ = read_model(str(full_model))
    if blacklist is not None:
        with open(blacklist) as f:
            blacklist = f.read().rstrip().split("\n")
    train_ids, test_ids = [], []
    for id_, image in images.items():
        if blacklist and image.image_name in blacklist:
            test_ids.append(id_)
        else:
            train_ids.append(id_)
    return train_ids, test_ids


def _point3d_ids_per_image(images, p2d, p3d):
    """Per-image array of point3D ids aligned with its 2D points."""
    out = {i: np.full(len(p2d.get(i, ())), -1, np.int64)
           for i in images}
    for pid, rec in p3d.items():
        for img_id, idx in zip(rec["image_ids"],
                               rec.get("point2D_idxs", [])):
            if img_id in out and idx < len(out[img_id]):
                out[img_id][idx] = pid
    return out


def write_model_txt_full(model_path, cams, images, p2d, p3d) -> None:
    """COLMAP text model WITH per-image 2D observations (needed by
    covisibility-based tooling; the library's minimal writer omits
    them)."""
    os.makedirs(model_path, exist_ok=True)
    p3did = _point3d_ids_per_image(images, p2d, p3d)
    with open(os.path.join(model_path, "cameras.txt"), "w") as f:
        for cam_id, cam in cams.items():
            params = " ".join(str(v) for v in cam.params)
            f.write(f"{cam_id} {cam.model_name} {cam.w()} {cam.h()} "
                    f"{params}\n")
    with open(os.path.join(model_path, "images.txt"), "w") as f:
        for img_id, im in images.items():
            q = " ".join(str(v) for v in im.pose.qvec)
            t = " ".join(str(v) for v in im.pose.tvec)
            f.write(f"{img_id} {q} {t} {im.cam_id} {im.image_name}\n")
            xy = p2d.get(img_id, np.zeros((0, 2)))
            f.write(" ".join(
                f"{x} {y} {pid}" for (x, y), pid
                in zip(np.asarray(xy)[:, :2], p3did[img_id])) + "\n")
    with open(os.path.join(model_path, "points3D.txt"), "w") as f:
        for pid, rec in p3d.items():
            xyz = " ".join(str(v) for v in rec["xyz"])
            track = " ".join(
                f"{i} {j}" for i, j in zip(rec["image_ids"],
                                           rec.get("point2D_idxs",
                                                   [0] * len(
                                                       rec["image_ids"]))))
            f.write(f"{pid} {xyz} 0 0 0 0.0 {track}\n")


def create_reference_sfm(full_model, ref_model, blacklist=None):
    """New model with only training images (reference utils.py
    create_reference_sfm), written as COLMAP text."""
    cams, images, p2d, p3d = read_model(str(full_model))
    if blacklist is not None:
        with open(blacklist) as f:
            bl = f.read().rstrip().split("\n")
    else:
        bl = []
    train_ids, test_ids = [], []
    images_ref = {}
    for id_, image in images.items():
        if image.image_name in bl:
            test_ids.append(id_)
            continue
        train_ids.append(id_)
        images_ref[id_] = image
    p3d_ref = {}
    for pid, rec in p3d.items():
        keep = [k for k, i in enumerate(rec["image_ids"])
                if i in images_ref]
        if not keep:
            continue
        p3d_ref[pid] = {
            "xyz": rec["xyz"],
            "image_ids": [rec["image_ids"][k] for k in keep],
            "point2D_idxs": [rec.get("point2D_idxs",
                                     [0] * len(rec["image_ids"]))[k]
                             for k in keep]}
    os.makedirs(str(ref_model), exist_ok=True)
    write_model_txt_full(str(ref_model), cams, images_ref,
                         {i: p2d.get(i, np.zeros((0, 2)))
                          for i in images_ref}, p3d_ref)
    return train_ids, test_ids


def correct_sfm_with_gt_depth(sfm_path, depth_folder_path, output_path):
    """Snap triangulated points onto the rendered ground-truth depth
    (reference utils.py correct_sfm_with_gt_depth), numpy-only."""
    import PIL.Image

    cams, images, p2d, p3d = read_model(str(sfm_path))
    for img_id, im in images.items():
        depth_name = image_path_to_rendered_depth_path(im.image_name)
        depth = np.array(PIL.Image.open(
            Path(depth_folder_path) / depth_name)).astype("float64")
        depth = depth / 1000.0
        bad = (depth == 0.0) | (depth > 1000.0)
        depth[bad] = np.nan
        K = cams[im.cam_id].K()
        R, t = im.pose.R(), im.pose.tvec
        pids = _point3d_ids_per_image({img_id: im},
                                      {img_id: p2d.get(img_id, [])},
                                      p3d)[img_id]
        H, W = depth.shape
        for idx, pid in enumerate(pids):
            if pid < 0 or pid not in p3d:
                continue
            pc = R @ np.asarray(p3d[pid]["xyz"]) + t
            if pc[2] < 1e-4:
                continue
            uv = (K @ pc)[:2] / pc[2]
            x, y = uv
            if not (1 <= x < W - 2 and 1 <= y < H - 2):
                continue
            x0, y0 = int(x), int(y)
            fx, fy = x - x0, y - y0
            patch = depth[y0:y0 + 2, x0:x0 + 2]
            if np.isnan(patch).any():
                d = patch[int(round(fy)), int(round(fx))]
            else:
                d = (patch[0, 0] * (1 - fx) * (1 - fy)
                     + patch[0, 1] * fx * (1 - fy)
                     + patch[1, 0] * (1 - fx) * fy
                     + patch[1, 1] * fx * fy)
            if not np.isfinite(d):
                continue
            ray = np.linalg.inv(K) @ np.array([x, y, 1.0])
            pc_new = ray * (d / ray[2])
            p3d[pid]["xyz"] = R.T @ (pc_new - t)
    os.makedirs(str(output_path), exist_ok=True)
    write_model_txt_full(str(output_path), cams, images, p2d, p3d)


def get_result_filenames(cfg, use_dense_depth=False):
    """Reference utils.py get_result_filenames, verbatim logic."""
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
    results_point = "results_{}_point.txt".format(
        "dense" if use_dense_depth else "sparse")
    results_joint = "results_{}_joint_{}{}{}{}{}.txt".format(
        "dense" if use_dense_depth else "sparse",
        "{}_".format(cfg["2d_matcher"]),
        ("{}_".format(cfg["reprojection_filter"])
         if cfg.get("reprojection_filter") is not None else ""),
        ("filtered_" if cfg["2d_matcher"] == "superglue_endpoints"
         and cfg.get("epipolar_filter") else ""),
        cfg["line_cost_func"], ransac_postfix)
    if cfg["2d_matcher"] == "gluestick":
        results_point = results_point.replace("point", "point_gluestick")
        results_joint = results_joint.replace("gluestick",
                                              "gluestickp+l")
    return results_point, results_joint


def run_hloc_7scenes(cfg, dataset, scene, results_file, test_list,
                     num_covis: int = 30, use_dense_depth: bool = False,
                     logger=None):
    """Drive hloc end-to-end for a 7Scenes scene (feature extraction,
    covisibility pairs, SuperGlue matching, SfM triangulation,
    point-only localization) — the reference's run_hloc_7scenes flow.

    Requires ``hloc`` importable; raises ImportError with instructions
    otherwise (the rest of the localization pipeline can then be fed
    from a precomputed hloc log via --hloc_log)."""
    try:
        import pycolmap
        from hloc import (extract_features, localize_sfm,
                          match_features, pairs_from_covisibility,
                          triangulation)
        from hloc.pipelines.Cambridge.utils import \
            create_query_list_with_intrinsics
    except ImportError as exc:
        raise ImportError(
            "run_hloc_7scenes drives the external hloc toolbox "
            "(github.com/cvg/Hierarchical-Localization); install it "
            "or pass --hloc_log with a precomputed localization log"
        ) from exc

    dataset = Path(dataset)
    results_file = Path(results_file)
    results_dir = results_file.parent
    gt_dir = dataset / f"7scenes_sfm_triangulated/{scene}/triangulated"
    ref_sfm_sift = results_dir / "sfm_sift"
    ref_sfm = results_dir / "sfm_superpoint+superglue"
    query_list = results_dir / "query_list_with_intrinsics.txt"
    sfm_pairs = results_dir / f"pairs-db-covis{num_covis}.txt"
    depth_dir = dataset / f"depth/7scenes_{scene}/train/depth"
    retrieval_path = (dataset / "7scenes_densevlad_retrieval_top_10"
                      / f"{scene}_top10.txt")
    feature_conf = {
        "output": "feats-superpoint-n4096-r1024",
        "model": {"name": "superpoint", "nms_radius": 3,
                  "max_keypoints": 4096},
        "preprocessing": {"globs": ["*.color.png"], "grayscale": True,
                          "resize_max": 1024},
    }
    matcher_conf = match_features.confs["superglue"]
    matcher_conf["model"]["sinkhorn_iterations"] = 5

    features = extract_features.main(feature_conf, dataset / scene,
                                     results_dir, as_half=True)
    train_ids, query_ids = get_train_test_ids_from_sfm(gt_dir, test_list)
    create_reference_sfm(gt_dir, ref_sfm_sift, test_list)
    create_query_list_with_intrinsics(gt_dir, query_list, test_list)
    if not sfm_pairs.exists():
        pairs_from_covisibility.main(ref_sfm_sift, sfm_pairs,
                                     num_matched=num_covis)
    sfm_matches = match_features.main(matcher_conf, sfm_pairs,
                                      feature_conf["output"],
                                      results_dir)
    loc_matches = match_features.main(matcher_conf, retrieval_path,
                                      feature_conf["output"],
                                      results_dir)
    if not ref_sfm.exists():
        triangulation.main(ref_sfm, ref_sfm_sift, dataset / scene,
                           sfm_pairs, features, sfm_matches)
    if use_dense_depth:
        ref_sfm_fix = results_dir / "sfm_superpoint+superglue+depth"
        if not cfg.get("skip_exists") or not ref_sfm_fix.exists():
            correct_sfm_with_gt_depth(ref_sfm, depth_dir, ref_sfm_fix)
        ref_sfm = ref_sfm_fix
    ref_sfm = pycolmap.Reconstruction(str(ref_sfm))

    if not os.path.exists(results_file):
        if logger:
            logger.info("Running point-only localization...")
        localize_sfm.main(
            ref_sfm, query_list, retrieval_path, features, loc_matches,
            results_file, covisibility_clustering=False,
            prepend_camera_name=True)
    return (ref_sfm, str(results_dir / "logs.pkl"), features,
            loc_matches, train_ids, query_ids)


def evaluate(results_file, gt_model, test_list=None):
    """Median pose errors + (5 cm, 5 deg) recall of a results txt
    ('name qw qx qy qz tx ty tz' per line) vs the GT model poses
    (hloc 7Scenes evaluation protocol)."""
    _, images, _, _ = read_model(str(gt_model))
    gt_by_name = {im.image_name: im.pose for im in images.values()}
    if test_list is not None:
        with open(test_list) as f:
            names = set(f.read().rstrip().split("\n"))
    else:
        names = set(gt_by_name)
    errs_t, errs_r = [], []
    with open(results_file) as f:
        for line in f:
            tok = line.strip().split()
            if not tok:
                continue
            name = tok[0]
            key = name.split("/", 1)[-1] if name not in gt_by_name \
                else name
            if key not in gt_by_name or key not in names:
                continue
            q = np.array([float(v) for v in tok[1:5]])
            t = np.array([float(v) for v in tok[5:8]])
            gt = gt_by_name[key]
            Rq = _qvec2rot(q)
            e_t = np.linalg.norm(-Rq.T @ t - (-gt.R().T @ gt.tvec))
            cos = np.clip((np.trace(Rq @ gt.R().T) - 1) / 2, -1, 1)
            errs_t.append(e_t)
            errs_r.append(np.degrees(np.arccos(cos)))
    errs_t, errs_r = np.asarray(errs_t), np.asarray(errs_r)
    out = {
        "n": len(errs_t),
        "median_t": float(np.median(errs_t)) if len(errs_t) else None,
        "median_R": float(np.median(errs_r)) if len(errs_r) else None,
        "recall_5cm_5deg": float(np.mean((errs_t < 0.05)
                                         & (errs_r < 5.0)))
        if len(errs_t) else None,
    }
    print(f"evaluate {results_file}: {out}")
    return out


def _qvec2rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])
