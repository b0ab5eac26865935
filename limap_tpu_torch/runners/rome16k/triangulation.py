"""Rome16K triangulation (reference: runners/rome16k/triangulation.py):
bundler model restricted to one connected component."""

import argparse
import os

import limap_tpu_torch.runners
from limap_tpu_torch.pointsfm.readers import (ReadModelBundler,
                                              fill_principal_points)
from limap_tpu_torch.util.config import load_cli_config, update_config
from limap_tpu_torch.runners.rome16k.Rome16K import Rome16K


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines on a Rome16K component")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/rome16k.yaml")
    parser.add_argument("-a", "--bundler_path", type=str, required=True)
    parser.add_argument("-l", "--list_path", type=str,
                        default="bundle.list.txt")
    parser.add_argument("-m", "--model_path", type=str,
                        default="bundle/bundle.orig.out")
    parser.add_argument("--component_folder", type=str,
                        default="bundle/components")
    parser.add_argument("--component_id", type=int, default=0)
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {})

    imagecols, points3d = ReadModelBundler(args.bundler_path,
                                           args.list_path,
                                           args.model_path)
    dataset = Rome16K(os.path.join(args.bundler_path, args.list_path),
                      os.path.join(args.bundler_path,
                                   args.component_folder))
    keep = set(dataset.get_images_in_component(args.component_id))
    imagecols = imagecols.subset_by_image_ids(
        [i for i in imagecols.get_img_ids() if i in keep])
    # Bundler stores no principal point
    fill_principal_points(imagecols)
    linetracks = limap_tpu_torch.runners.line_triangulation(
        cfg, imagecols, points3d=points3d, device=args.device)
    print(f"triangulated {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
