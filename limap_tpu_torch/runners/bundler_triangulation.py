"""Line triangulation from a Bundler model.

    python -m limap_tpu_torch.runners.bundler_triangulation \\
        -a BUNDLER_FOLDER [-l bundle.list.txt] [-m bundle/bundle.orig.out] \\
        [-c CONFIG] [--device cpu] [--section.key value ...]

Bundler stores no principal point: each camera's is the centre of its
first image (``pointsfm.readers.fill_principal_points``).
"""

from __future__ import annotations

import argparse

from limap_tpu_torch.pointsfm.readers import (ReadModelBundler,
                                              fill_principal_points)
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.util.config import (default_triangulation_config,
                                         load_cli_config, update_config)


def read_scene_bundler(cfg, bundler_path, list_path, model_path):
    """(imagecols, points3d) of a Bundler reconstruction."""
    imagecols, points3d = ReadModelBundler(bundler_path, list_path,
                                           model_path)
    fill_principal_points(imagecols)
    return imagecols, points3d


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines from a Bundler model")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("-a", "--bundler_path", type=str, required=True)
    parser.add_argument("-l", "--list_path", type=str,
                        default="bundle.list.txt")
    parser.add_argument("-m", "--model_path", type=str,
                        default="bundle/bundle.orig.out")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_triangulation_config)
    cfg = update_config(cfg, unknown, {})
    imagecols, points3d = read_scene_bundler(
        cfg, args.bundler_path, args.list_path, args.model_path)
    linetracks = line_triangulation(cfg, imagecols, points3d=points3d,
                                    device=args.device)
    print(f"triangulated {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
