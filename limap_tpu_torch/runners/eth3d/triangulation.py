"""ETH3D line triangulation entry point
(reference: runners/eth3d/triangulation.py)."""

import argparse

import limap_tpu_torch.runners
from limap_tpu_torch.util.config import load_cli_config, update_config
from limap_tpu_torch.runners.eth3d.ETH3D import ETH3D


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene_id", type=str, default="terrains")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {})

    dataset = ETH3D(args.data_dir)
    imagecols = dataset.read_imagecols(args.scene_id)
    points3d = dataset.read_points3d(args.scene_id)
    tracks = limap_tpu_torch.runners.line_triangulation(
        cfg, imagecols, points3d=points3d, device=args.device)
    print(f"triangulated {len(tracks)} line tracks")
    return tracks


if __name__ == "__main__":
    main()
