"""ETH3D depth-assisted fit&merge entry point
(reference: runners/eth3d/fitnmerge.py) — fits 3D segments from the
ground-truth/inpainted depth maps, then merges them into tracks.
"""

import argparse

import limap_tpu_torch.runners
from limap_tpu_torch.util.config import load_config, update_config
from limap_tpu_torch.runners.eth3d.ETH3D import ETH3D

SHORTCUTS = {"-nv": "--n_visible_views", "-nn": "--n_neighbors",
             "-sid": "--scene_id"}


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="fit&merge 3D lines on an ETH3D scene")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/fitnmerge/eth3d.yaml")
    parser.add_argument("--default_config_file", type=str,
                        default="cfgs/fitnmerge/default.yaml")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--scene_id", type=str, default=None)
    parser.add_argument("--use_ground_truth_depth", action="store_true",
                        help="read ground_truth_depth/ instead of "
                             "inpainted_depth/")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config_file,
                      default_path=args.default_config_file)
    cfg = update_config(cfg, unknown, SHORTCUTS)
    if args.data_dir:
        cfg["data_dir"] = args.data_dir
    if args.scene_id:
        cfg["scene_id"] = args.scene_id
    cfg["use_inpainted_depth"] = not args.use_ground_truth_depth
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_config(argv)
    dataset = ETH3D(cfg["data_dir"])
    scene_id = cfg.get("scene_id", "terrains")
    imagecols = dataset.read_imagecols(scene_id)
    if cfg.get("max_image_dim", -1) not in (-1, None):
        imagecols.set_max_image_dim(cfg["max_image_dim"])
    depths = dataset.read_depths(
        scene_id, imagecols,
        use_inpainted=cfg.get("use_inpainted_depth", True))
    tracks = limap_tpu_torch.runners.line_fitnmerge(cfg, imagecols, depths,
                                                    device=device)
    print(f"fit&merged {len(tracks)} line tracks")
    return tracks


if __name__ == "__main__":
    main()
