"""InLoc hybrid localization (reference: runners/inloc/localization.py).

InLoc is RGB-D on the database side: the line map is built with
line_fitting_with_points3d over the per-cutout scans, queries localize
with hybrid PnPL.  Scans and query lists are taken as prepared npz/txt
inputs.  With the hloc toolbox installed, ``utils.run_hloc_inloc``
obtains them end-to-end (reference runners/inloc/utils.py flow);
``utils.InLocP3DReader`` reads the scan point maps for the
fit-from-point-cloud path.
"""

import argparse

import numpy as np

from limap_tpu_torch.pointsfm import ReadInfos
from limap_tpu_torch.runners import hybrid_localization
from limap_tpu_torch.runners.line_fitnmerge import line_fitting_with_points3d
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.config import load_cli_config, update_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hybrid point+line localization on InLoc")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/localization/inloc.yaml")
    parser.add_argument("--db_model", type=str, required=True,
                        help="COLMAP-format model of database cutouts")
    parser.add_argument("--query_model", type=str, required=True)
    parser.add_argument("--scans", type=str, default=None,
                        help="npz: p3d_<img_id> arrays of per-pixel "
                             "scan points (for RGB-D line fitting)")
    parser.add_argument("--linemap", type=str, default=None)
    parser.add_argument("--point_corresp", type=str, required=True)
    parser.add_argument("--retrieval", type=str, required=True)
    parser.add_argument("--results_path", type=str,
                        default="inloc_results.txt")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {})

    imagecols_db = ReadInfos(args.db_model)
    imagecols_q = ReadInfos(args.query_model)

    if args.linemap:
        linemap, _, _, _ = limapio.read_folder_linetracks_with_info(
            args.linemap)
    else:
        if args.scans is None:
            raise SystemExit("need --scans or --linemap")
        data = np.load(args.scans)
        p3d_readers = {int(k[4:]): data[k] for k in data.files
                       if k.startswith("p3d_")}
        linemap = line_fitting_with_points3d(dict(cfg), imagecols_db,
                                             p3d_readers, device=args.device)

    data = np.load(args.point_corresp)
    point_corresp = {}
    for key in data.files:
        if key.startswith("p3ds_"):
            qid = int(key[5:])
            point_corresp[qid] = (data[key], data[f"p2ds_{qid}"])
    retrieval = {}
    with open(args.retrieval) as f:
        for line in f:
            tok = line.split()
            if tok:
                retrieval[int(tok[0])] = [int(v) for v in tok[1:]]

    poses = hybrid_localization(dict(cfg), imagecols_db, imagecols_q,
                                point_corresp, linemap, retrieval,
                                results_path=args.results_path,
                                device=args.device)
    print(f"localized {len(poses)} queries -> {args.results_path}")


if __name__ == "__main__":
    main()
