"""Refine a saved line map with fixed cameras (kernel K).

    python -m limap_tpu_torch.runners.refinement -i FINALTRACKS_FOLDER \\
        [-o OUTPUT_FOLDER] [-c CONFIG] [--use_vp] [--device cpu] \\
        [--section.key value ...]

The config's ``refinement`` section gives the terms and weights; with
``use_vp`` the VPs of every image come from one launch of kernel J.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

from limap_tpu_torch.optimize.line_refinement import line_refinement
from limap_tpu_torch.util import io as limapio


def main(argv=None):
    from limap_tpu_torch.util.config import (default_refinement_config,
                                             load_config, update_config)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description="refine saved line tracks")
    parser.add_argument("-i", "--input_folder", type=str, required=True,
                        help="finaltracks folder")
    parser.add_argument("-o", "--output_folder", type=str, default=None)
    parser.add_argument("-c", "--config_file", type=str,
                        default=os.path.join(repo_root, "cfgs",
                                             "refinement", "default.yaml"))
    parser.add_argument("--use_vp", action="store_true")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = (load_config(args.config_file) if importlib.util.find_spec("yaml")
           else default_refinement_config())
    cfg = update_config(cfg, unknown, {})
    tracks, saved_cfg, imagecols, all_2d_segs = \
        limapio.read_folder_linetracks_with_info(args.input_folder)
    # the config saved with the tracks is a fallback; the config file and
    # the command line win
    refinement_cfg = dict((saved_cfg or {}).get("refinement", {}))
    refinement_cfg.update(cfg.get("refinement", {}))
    if args.use_vp:
        refinement_cfg["use_vp"] = True
    output_folder = args.output_folder or cfg.get("output_folder",
                                                  "refined_tracks")
    vpresults = None
    if refinement_cfg.get("use_vp") and all_2d_segs is not None:
        from limap_tpu_torch.vplib import get_vp_detector
        vpresults = get_vp_detector(
            refinement_cfg.get("vpdet", {"method": "jlinkage"}),
            device=args.device).detect_vp_all_images(all_2d_segs)
    new_tracks = line_refinement(refinement_cfg, tracks, imagecols,
                                 vpresults=vpresults, device=args.device)
    limapio.save_folder_linetracks_with_info(
        output_folder, new_tracks, config=cfg, imagecols=imagecols,
        all_2d_segs=all_2d_segs)
    print(f"refined {len(new_tracks)} tracks -> {output_folder}")


if __name__ == "__main__":
    main()
