"""Hybrid point-line localization of query images from files.

    python -m limap_tpu_torch.runners.localization --db_model MODEL \\
        --query_model MODEL --linemap FINALTRACKS --point_corresp NPZ \\
        --retrieval TXT [--results_path FILE] [-c CONFIG] [--device cpu] \\
        [--section.key value ...]

Any scene as: a COLMAP model of the database images, a COLMAP model of
the query cameras (poses optional, used as priors), a saved line map, the
queries' point correspondences (an npz with arrays ``p3ds_<qid>`` and
``p2ds_<qid>``) and a retrieval file (``query_id db_id db_id ...`` a
line).  The library is ``runners/hybrid_localization.py``.
"""

from __future__ import annotations

import argparse

import numpy as np

from limap_tpu_torch.pointsfm import ReadInfos
from limap_tpu_torch.runners.hybrid_localization import hybrid_localization
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.config import (default_localization_config,
                                         load_cli_config, update_config)


def read_point_corresp(fname):
    """{query id: (p3ds, p2ds)} of an npz with p3ds_<qid> / p2ds_<qid>."""
    data = np.load(fname)
    return {int(key[5:]): (data[key], data[f"p2ds_{key[5:]}"])
            for key in data.files if key.startswith("p3ds_")}


def read_retrieval(fname):
    """{query id: [db ids]} of a retrieval file."""
    retrieval = {}
    with open(fname) as f:
        for line in f:
            tok = line.split()
            if tok:
                retrieval[int(tok[0])] = [int(v) for v in tok[1:]]
    return retrieval


def main(argv=None):
    parser = argparse.ArgumentParser(description="hybrid PnPL localization")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/localization/default.yaml")
    parser.add_argument("--db_model", type=str, required=True,
                        help="COLMAP model of database images")
    parser.add_argument("--query_model", type=str, required=True,
                        help="COLMAP model holding query cameras (poses "
                             "optional, used as priors)")
    parser.add_argument("--linemap", type=str, required=True,
                        help="finaltracks folder of the db line map")
    parser.add_argument("--point_corresp", type=str, required=True)
    parser.add_argument("--retrieval", type=str, required=True)
    parser.add_argument("--results_path", type=str,
                        default="localization_results.txt")
    parser.add_argument("--image_path", type=str, default="",
                        help="folder the models' image names are in")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file, default_localization_config)
    cfg = update_config(cfg, unknown, {})
    cfg.setdefault("output_dir", "tmp_localization")

    imagecols_db = ReadInfos(args.db_model, args.image_path)
    imagecols_query = ReadInfos(args.query_model, args.image_path)
    linemap, _, _, _ = limapio.read_folder_linetracks_with_info(args.linemap)
    poses = hybrid_localization(cfg, imagecols_db, imagecols_query,
                                read_point_corresp(args.point_corresp),
                                linemap, read_retrieval(args.retrieval),
                                results_path=args.results_path,
                                device=args.device)
    print(f"localized {len(poses)} queries -> {args.results_path}")
    return poses


if __name__ == "__main__":
    main()
