"""Line triangulation on a Hypersim scene (RGB only).

    python -m limap_tpu_torch.runners.hypersim.triangulation \\
        --data_dir HYPERSIM [--scene_id ai_001_001] [--cam_id 0] \\
        [--input_n_views 100] [-c CONFIG] [--device cpu] \\
        [--section.key value ...]
"""

from __future__ import annotations

import argparse

from limap_tpu_torch.runners.hypersim.loader import (Hypersim,
                                                     read_scene_hypersim)
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.util.config import (default_triangulation_config,
                                         load_cli_config, update_config)

SHORTCUTS = {
    "-nv": "--n_visible_views", "-nn": "--n_neighbors",
    "-sid": "--scene_id",
}


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines on a Hypersim scene")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="ai_001_001")
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--input_n_views", type=int, default=100)
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_triangulation_config)
    cfg = update_config(cfg, unknown, SHORTCUTS)
    for k in ("data_dir", "scene_id", "cam_id", "input_n_views"):
        cfg[k] = getattr(args, k)
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_config(argv)
    dataset = Hypersim(cfg["data_dir"])
    imagecols = read_scene_hypersim(cfg, dataset, cfg["scene_id"],
                                    cam_id=cfg["cam_id"])
    linetracks = line_triangulation(cfg, imagecols, device=device)
    print(f"triangulated {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
