"""Line triangulation from a VisualSfM model (NVM).

    python -m limap_tpu_torch.runners.visualsfm_triangulation \\
        -a VSFM_FOLDER [-m reconstruction.nvm] [-c CONFIG] [--device cpu] \\
        [--section.key value ...]

NVM stores no principal point: each camera's is the centre of its image
(``pointsfm.readers.fill_principal_points``).
"""

from __future__ import annotations

import argparse

from limap_tpu_torch.pointsfm.readers import (ReadModelVisualSfM,
                                              fill_principal_points)
from limap_tpu_torch.runners.line_triangulation import line_triangulation
from limap_tpu_torch.util.config import (default_triangulation_config,
                                         load_cli_config, update_config)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="triangulate 3D lines from a VisualSfM model")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/triangulation/default.yaml")
    parser.add_argument("-a", "--vsfm_path", type=str, required=True)
    parser.add_argument("-m", "--nvm_file", type=str,
                        default="reconstruction.nvm")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_triangulation_config)
    cfg = update_config(cfg, unknown, {})
    imagecols, points3d = ReadModelVisualSfM(args.vsfm_path,
                                             nvm_file=args.nvm_file)
    fill_principal_points(imagecols)
    linetracks = line_triangulation(cfg, imagecols, points3d=points3d,
                                    device=args.device)
    print(f"triangulated {len(linetracks)} line tracks")
    return linetracks


if __name__ == "__main__":
    main()
