"""Line triangulation from a COLMAP model: the model's cameras and poses,
neighbours and ranges from its 3D points, then ``line_triangulation``.

    python -m limap_tpu_torch.runners.colmap_triangulation \\
        -a COLMAP_FOLDER [-m sparse] [-i images] [-c CONFIG] [--device cpu] \\
        [--triangulation.use_vp True ...]

``--device`` defaults to cuda; further ``--section.key value`` pairs
override the config file.
"""

from __future__ import annotations

import argparse
import os

import limap_tpu_torch.pointsfm as pointsfm
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.util.config import load_config, update_config


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines from a COLMAP reconstruction")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("-a", "--colmap_path", type=str, required=True)
    parser.add_argument("-m", "--model_path", type=str, default="sparse")
    parser.add_argument("-i", "--image_path", type=str, default="images")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config_file)
    cfg = update_config(cfg, unknown, {})
    cfg["colmap_path"] = args.colmap_path
    cfg["model_path"] = args.model_path
    cfg["image_path"] = args.image_path
    return cfg, args.device


def run(cfg: dict, device=None):
    """Read the model named by ``cfg`` and triangulate its images."""
    model_path = os.path.join(cfg["colmap_path"], cfg["model_path"])
    image_path = os.path.join(cfg["colmap_path"], cfg["image_path"])
    imagecols = pointsfm.ReadInfos(model_path, image_path)
    points3d = pointsfm.ReadPointTracks(model_path)
    return line_triangulation(cfg, imagecols, points3d=points3d,
                              device=device)


def main(argv=None):
    cfg, device = parse_config(argv)
    linetracks = run(cfg, device)
    print(f"triangulated {len(linetracks)} line tracks")


if __name__ == "__main__":
    main()
