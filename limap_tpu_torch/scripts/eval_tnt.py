"""Tanks and Temples line-map evaluation.

Loads a finaltracks folder, applies an optional Sim3 alignment (a 3 x 4
``alignment.txt``, x' = A[:, :3] x + A[:, 3]) and prints the length
recall and precision at 1, 5, 10 and 50 mm against the GT point cloud of
a ``.ply`` file::

    python -m limap_tpu_torch.scripts.eval_tnt -i FINALTRACKS \\
        --gt_ply GT.ply [--alignment alignment.txt] [--device cpu]

The distances come from ``PointCloudEvaluator`` (the nearest-neighbour
kernel on the GPU), all lines of a threshold in one call.
"""

import argparse

import numpy as np
import torch

from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.evaluation import PointCloudEvaluator
from limap_tpu_torch.util import io as limapio

THRESHOLDS = [0.001, 0.005, 0.01, 0.05]


def read_ply_xyz(path):
    """The xyz of a ``.ply`` point cloud: through open3d where it is
    installed, else ascii or binary little-endian float32 vertices."""
    try:
        import open3d as o3d

        return np.asarray(o3d.io.read_point_cloud(path).points)
    except ImportError:
        pass
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        fmt = next(h.split()[1] for h in header if h.startswith("format"))
        props = [h.split()[-1] for h in header
                 if h.startswith("property")]
        if fmt == "ascii":
            return np.loadtxt(f, max_rows=n)[:, :3]
        dt = np.dtype([(p, "<f4") for p in props])
        data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
        return np.stack([data["x"], data["y"], data["z"]], axis=1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="evaluate on TnT GT")
    parser.add_argument("-i", "--input_dir", type=str, required=True,
                        help="finaltracks folder")
    parser.add_argument("--gt_ply", type=str, required=True)
    parser.add_argument("--alignment", type=str, default=None,
                        help="a 3 x 4 Sim3, x' = A[:, :3] x + A[:, 3]")
    parser.add_argument("-nv", "--n_visible_views", type=int, default=4)
    parser.add_argument("--max_gt_points", type=int, default=2_000_000)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    tracks, _, _, _ = limapio.read_folder_linetracks_with_info(
        args.input_dir)
    lines = np.stack([t.line for t in tracks
                      if t.count_images() >= args.n_visible_views])
    if args.alignment:
        A = np.loadtxt(args.alignment)
        lines = lines @ A[:, :3].T + A[:, 3]

    gt = read_ply_xyz(args.gt_ply)
    if len(gt) > args.max_gt_points:
        sel = np.random.default_rng(0).choice(len(gt), args.max_gt_points,
                                              replace=False)
        gt = gt[sel]

    evaluator = PointCloudEvaluator(gt.astype(np.float32), device=args.device)
    t = torch.as_tensor(lines.astype(np.float32), device=evaluator.device)
    seg = Segments(t[:, 0], t[:, 1])
    lengths = np.linalg.norm(lines[:, 1] - lines[:, 0], axis=1)
    print(f"{len(lines)} lines, GT cloud {len(gt)} points")
    for tau in THRESHOLDS:
        ratios = np.array([float(r) for r in
                           evaluator.ComputeInlierRatio(seg, tau)])
        recall = float((lengths * ratios).sum())
        precision = 100.0 * float((ratios > 0).mean())
        print(f"R / P at {int(tau * 1000)}mm: "
              f"{recall:.2f} / {precision:.2f}")


if __name__ == "__main__":
    main()
