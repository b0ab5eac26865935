"""Joint SfM refinement on Hypersim: triangulate a line map on noisy SfM
poses, then bundle-adjust poses, points and lines together and measure
the pose errors against the GT poses before and after.

    python -m limap_tpu_torch.runners.hypersim.refine_sfm \\
        --data_dir HYPERSIM [--scene_id ai_001_001] [--cam_id 0] \\
        [--input_n_views 100] [--colmap_model_path MODEL] \\
        [--pose_noise 0.01] [--ba_iterations 20] [-c CONFIG] \\
        [--device cpu] [--section.key value ...]

The initial model comes from a COLMAP model folder
(``--colmap_model_path``, with every point's 2D observations) or from the
GT poses perturbed by ``pose_noise`` (the first two exact) and a point
model triangulated on them in process.  :func:`read_colmap_inputs` and
:func:`read_noisy_inputs` are the readers, :func:`run_refine_sfm` the
refinement on any collection.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from limap_tpu_torch.parallel import (HybridBAOptions,
                                      solve_hybrid_bundle_adjustment)
from limap_tpu_torch.runners.hypersim.loader import (Hypersim,
                                                     read_scene_hypersim)
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.structures.pl_bipartite import PointTrack
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.config import (default_triangulation_config,
                                         load_cli_config, update_config)
from limap_tpu_torch.util.evaluation import eval_imagecols


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="joint point-line SfM refinement on Hypersim")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="ai_001_001")
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--input_n_views", type=int, default=100)
    parser.add_argument("--colmap_model_path", type=str, default=None)
    parser.add_argument("--pose_noise", type=float, default=0.01,
                        help="perturbation (m / ~rad*0.5) applied to GT"
                             " poses when no COLMAP model is given")
    parser.add_argument("--ba_iterations", type=int, default=20)
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_triangulation_config)
    cfg = update_config(cfg, unknown, {"-sid": "--scene_id"})
    for k in ("data_dir", "scene_id", "cam_id", "input_n_views",
              "colmap_model_path", "pose_noise", "ba_iterations"):
        cfg[k] = getattr(args, k)
    return cfg, args.device


def read_colmap_inputs(model_path, image_path=""):
    """(imagecols, point tracks) of a COLMAP model: each track's
    point2D_idxs resolved into its images' 2D keypoints.  Refuses a model
    whose points have no 2D observation: every point residual would get
    weight 0 and the joint BA would quietly refine lines alone."""
    from limap_tpu_torch.pointsfm.colmap_reader import ReadInfos, read_model
    imagecols = ReadInfos(model_path, image_path)
    _, _, p2d_by_image, points3d = read_model(model_path)
    pointtracks = []
    for rec in points3d.values():
        pt = PointTrack(np.asarray(rec["xyz"]))
        for img_id, p2d_idx in zip(rec["image_ids"],
                                   rec.get("point2D_idxs", [])):
            xy = p2d_by_image.get(img_id)
            if xy is None or p2d_idx >= len(xy):
                continue
            pt.image_id_list.append(int(img_id))
            pt.p2d_list.append(np.asarray(xy[p2d_idx], np.float64)[:2])
        pointtracks.append(pt)
    if pointtracks and not any(pt.p2d_list for pt in pointtracks):
        raise ValueError(
            "COLMAP model has no 2D observations for any point "
            "track; joint BA would silently drop all point terms")
    return imagecols, pointtracks


def perturb_poses(imagecols_gt, pose_noise, seed=0):
    """The GT collection with each pose but the first two rotated by
    ~N(0, pose_noise / 2) rad and moved by ~N(0, pose_noise) m."""
    from scipy.spatial.transform import Rotation

    from limap_tpu_torch.base.camera import CameraPose
    from limap_tpu_torch.base.image_collection import (CameraImage,
                                                       ImageCollection)
    rng = np.random.default_rng(seed)
    noisy = {}
    for k, img_id in enumerate(imagecols_gt.get_img_ids()):
        im = imagecols_gt.images[img_id]
        R, t = im.pose.R(), im.pose.tvec
        if k >= 2:  # the first two poses anchor the gauge
            R = Rotation.from_rotvec(rng.normal(size=3) * pose_noise
                                     * 0.5).as_matrix() @ R
            t = t + rng.normal(size=3) * pose_noise
        noisy[img_id] = CameraImage(im.cam_id, CameraPose(R=R, tvec=t),
                                    im.image_name)
    return ImageCollection(dict(imagecols_gt.cameras), noisy)


def read_noisy_inputs(imagecols_gt, pose_noise, device=None):
    """(imagecols, point tracks): the GT poses perturbed, and a point
    model triangulated on them from the images."""
    from limap_tpu_torch.pointsfm.sfm import run_sfm_with_known_poses
    imagecols = perturb_poses(imagecols_gt, pose_noise)
    images = {i: imagecols.read_image(i, set_gray=True)
              for i in imagecols.get_img_ids()}
    points3d = run_sfm_with_known_poses(imagecols, images=images,
                                        device=device)
    pointtracks = []
    for rec in points3d.values():
        pt = PointTrack(np.asarray(rec["xyz"]))
        p2ds = rec.get("p2ds", {})
        for img_id in rec["image_ids"]:
            if img_id not in p2ds:
                continue
            pt.image_id_list.append(int(img_id))
            pt.p2d_list.append(np.asarray(p2ds[img_id]).reshape(-1)[:2])
        pointtracks.append(pt)
    return imagecols, pointtracks


def run_refine_sfm(cfg, imagecols_gt, imagecols, pointtracks, device=None,
                   opts=HybridBAOptions(n_fixed_poses=2)):
    """A line map on ``imagecols``, then the joint hybrid BA of poses,
    points and lines.  Returns a dict: the pose errors before and after
    ((trans, rot) lists), the BA's output (imagecols, points, linetracks,
    costs), the line map it started from and the seconds of the two
    stages (host clock; the BA ends on the host)."""
    te0, re0 = eval_imagecols(imagecols, imagecols_gt)
    print(f"original: trans {np.median(te0):.4f}, rot {np.median(re0):.4f}")
    t0 = time.perf_counter()
    linetracks = line_triangulation(cfg, imagecols, device=device)
    t1 = time.perf_counter()
    new_imagecols, new_points, new_tracks, costs = \
        solve_hybrid_bundle_adjustment(
            imagecols, pointtracks, linetracks, opts,
            n_iterations=cfg["ba_iterations"], device=device)
    seconds = {"line_triangulation": t1 - t0,
               "hybrid_ba": time.perf_counter() - t1}
    te1, re1 = eval_imagecols(new_imagecols, imagecols_gt)
    print(f"optimized: trans {np.median(te1):.4f}, rot {np.median(re1):.4f} "
          f"(cost {costs[0]:.4f} -> {costs[-1]:.4f})")
    return {"errors_before": (te0, re0), "errors_after": (te1, re1),
            "imagecols": new_imagecols, "points": new_points,
            "linetracks": new_tracks, "costs": costs,
            "linetracks_in": linetracks, "seconds": seconds}


def main(argv=None):
    cfg, device = parse_config(argv)
    dataset = Hypersim(cfg["data_dir"])
    imagecols_gt = read_scene_hypersim(cfg, dataset, cfg["scene_id"],
                                       cam_id=cfg["cam_id"])
    if cfg["colmap_model_path"]:
        imagecols, pointtracks = read_colmap_inputs(cfg["colmap_model_path"])
    else:
        imagecols, pointtracks = read_noisy_inputs(
            imagecols_gt, cfg["pose_noise"], device=device)
    out = run_refine_sfm(cfg, imagecols_gt, imagecols, pointtracks, device)
    folder = cfg.get("output_dir", "outputs/refine_sfm")
    limapio.check_makedirs(folder)
    limapio.save_npy(os.path.join(folder, "imagecols_optimized.npy"),
                     out["imagecols"].as_dict())
    print(f"saved optimized poses to {folder}")
    return out


if __name__ == "__main__":
    main()
