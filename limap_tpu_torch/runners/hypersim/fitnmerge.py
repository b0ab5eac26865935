"""Fit and merge 3D lines on a Hypersim scene with its GT depth.

    python -m limap_tpu_torch.runners.hypersim.fitnmerge \\
        --data_dir HYPERSIM [--scene_id ai_001_001] [--cam_id 0] \\
        [--input_n_views 100] [-c CONFIG] [--device cpu] \\
        [--section.key value ...]
"""

from __future__ import annotations

import argparse

from limap_tpu_torch.runners.hypersim.loader import (Hypersim,
                                                     read_scene_hypersim)
from limap_tpu_torch.runners.line_fitnmerge import line_fitnmerge
from limap_tpu_torch.util.config import (default_fitnmerge_config,
                                         load_cli_config, update_config)


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="fit&merge 3D lines on a Hypersim scene with GT depth")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/fitnmerge/default.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="ai_001_001")
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--input_n_views", type=int, default=100)
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_fitnmerge_config)
    cfg = update_config(cfg, unknown, {})
    for k in ("data_dir", "scene_id", "cam_id", "input_n_views"):
        cfg[k] = getattr(args, k)
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_config(argv)
    dataset = Hypersim(cfg["data_dir"])
    imagecols, depths = read_scene_hypersim(
        cfg, dataset, cfg["scene_id"], cam_id=cfg["cam_id"],
        load_depth=True)
    linetracks = line_fitnmerge(cfg, imagecols, depths, device=device)
    print(f"fit&merged {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
