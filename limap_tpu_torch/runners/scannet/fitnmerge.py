"""ScanNet depth-assisted fit&merge entry point
(reference: runners/scannet/fitnmerge.py)."""

import argparse

import limap_tpu_torch.runners
from limap_tpu_torch.util.config import load_config, update_config
from limap_tpu_torch.runners.scannet.ScanNet import ScanNet
from limap_tpu_torch.runners.scannet.ScanNet import read_scene_scannet

SHORTCUTS = {"-nv": "--n_visible_views", "-nn": "--n_neighbors",
             "-sid": "--scene_id"}


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description="fit&merge 3D lines on a ScanNet scene")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/fitnmerge/scannet.yaml")
    parser.add_argument("--default_config_file", type=str,
                        default="cfgs/fitnmerge/default.yaml")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--scene_id", type=str, default=None)
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config_file,
                      default_path=args.default_config_file)
    cfg = update_config(cfg, unknown, SHORTCUTS)
    if args.data_dir:
        cfg["data_dir"] = args.data_dir
    if args.scene_id:
        cfg["scene_id"] = args.scene_id
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_config(argv)
    dataset = ScanNet(cfg["data_dir"],
                      max_image_dim=cfg.get("max_image_dim", -1))
    imagecols, depths = read_scene_scannet(cfg, dataset,
                                           cfg["scene_id"],
                                           load_depth=True)
    tracks = limap_tpu_torch.runners.line_fitnmerge(cfg, imagecols, depths,
                                                    device=device)
    print(f"fit&merged {len(tracks)} line tracks")
    return tracks


if __name__ == "__main__":
    main()
