"""Hypersim line-map evaluation.

Builds the GT point cloud by unprojecting the scene's depth maps (every
4th pixel) and prints the length recall and precision at 1, 5 and 10 mm::

    python -m limap_tpu_torch.scripts.eval_hypersim -i FINALTRACKS \\
        --data_dir HYPERSIM [--scene_id ai_001_001] [--device cpu]

The depth maps are HDF5 (``h5py``) and OpenCV resizes them where their
size differs; both are imported only when a map is read.
"""

import argparse

import numpy as np

from limap_tpu_torch.evaluation import PointCloudEvaluator, report_error_to_gt
from limap_tpu_torch.util import io as limapio

MPAU = 0.02539999969303608  # metres per asset unit


def build_gt_cloud(imagecols, depths, stride: int = 4) -> np.ndarray:
    """[N, 3] f32 world points of every ``stride``-th pixel of each
    image's depth map."""
    pts = []
    for img_id in imagecols.get_img_ids():
        view = imagecols.camview(img_id)
        depth = depths[img_id].read_depth(img_hw=[view.h(), view.w()])
        h, w = depth.shape
        ys, xs = np.mgrid[0:h:stride, 0:w:stride]
        z = depth[ys, xs].ravel()
        homo = np.stack([xs.ravel(), ys.ravel(), np.ones(z.size)])
        p_cam = (view.K_inv() @ homo) * z
        pts.append((view.R().T @ (p_cam - view.T()[:, None])).T)
    return np.concatenate(pts).astype(np.float32)


def main(argv=None):
    from limap_tpu_torch.runners.hypersim.loader import (Hypersim,
                                                         read_scene_hypersim)
    parser = argparse.ArgumentParser(description="evaluate hypersim linemap")
    parser.add_argument("-i", "--input_dir", type=str, required=True,
                        help="finaltracks folder")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="ai_001_001")
    parser.add_argument("-nv", "--n_visible_views", type=int, default=4)
    parser.add_argument("--input_n_views", type=int, default=100)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    tracks, _, imagecols, _ = limapio.read_folder_linetracks_with_info(
        args.input_dir)
    _, depths = read_scene_hypersim(
        {"max_image_dim": -1, "input_n_views": args.input_n_views},
        Hypersim(args.data_dir), args.scene_id, load_depth=True)
    evaluator = PointCloudEvaluator(build_gt_cloud(imagecols, depths),
                                    device=args.device)
    lines = np.stack([t.line for t in tracks
                      if t.count_images() >= args.n_visible_views])
    thresholds = [0.001 / MPAU, 0.005 / MPAU, 0.01 / MPAU]
    report = report_error_to_gt(evaluator, lines, thresholds)
    for tau, label in zip(thresholds, ["1mm", "5mm", "10mm"]):
        print(f"recall@{label}: {report['recall'][tau] * MPAU:.3f} m  "
              f"precision@{label}: {report['precision'][tau]:.1f}%")


if __name__ == "__main__":
    main()
