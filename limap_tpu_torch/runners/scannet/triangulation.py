"""ScanNet triangulation entry point
(reference: runners/scannet/triangulation.py)."""

import argparse

import limap_tpu_torch.runners
from limap_tpu_torch.util.config import load_cli_config, update_config
from limap_tpu_torch.runners.scannet.ScanNet import ScanNet
from limap_tpu_torch.runners.scannet.ScanNet import read_scene_scannet


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines on a ScanNet scene")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/scannet.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="scene0678_01")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {"-nv": "--n_visible_views",
                                       "-nn": "--n_neighbors"})
    dataset = ScanNet(args.data_dir,
                      max_image_dim=cfg.get("max_image_dim", -1))
    imagecols = read_scene_scannet(cfg, dataset, args.scene_id)
    linetracks = limap_tpu_torch.runners.line_triangulation(
        cfg, imagecols, device=args.device)
    print(f"triangulated {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
