"""Cambridge Landmarks hybrid localization
(reference: runners/cambridge/localization.py).

Scene layout: a VisualSfM reconstruction (reconstruction.nvm) +
dataset_train.txt / dataset_test.txt splits with per-image poses.

With the hloc toolbox installed, ``utils.run_hloc_cambridge`` drives
retrieval/features/known-pose SfM/point localization end-to-end
(reference runners/cambridge/utils.py flow); ``utils.evaluate``
reports the dataset's median-error + recall-table protocol.
"""

import argparse
import os

import numpy as np

from limap_tpu_torch.pointsfm.readers import ReadModelVisualSfM
from limap_tpu_torch.runners import hybrid_localization, line_triangulation
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.config import load_cli_config, update_config


def _read_split(scene_dir, fname):
    """dataset_{train,test}.txt: name qw qx qy qz tx ty tz (camera
    center convention per the dataset release)."""
    entries = {}
    path = os.path.join(scene_dir, fname)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 8 or not tok[0].endswith((".png", ".jpg")):
                continue
            name = tok[0]
            vals = np.array([float(v) for v in tok[1:8]])
            entries[name] = vals
    return entries


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hybrid point+line localization on Cambridge")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/localization/cambridge.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene", type=str, default="KingsCollege")
    parser.add_argument("--linemap", type=str, default=None)
    parser.add_argument("--point_corresp", type=str, default=None)
    parser.add_argument("--results_path", type=str,
                        default="cambridge_results.txt")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {})
    scene_dir = os.path.join(args.data_dir, args.scene)

    imagecols_all, _ = ReadModelVisualSfM(scene_dir)
    test_split = _read_split(scene_dir, "dataset_test.txt")
    name_of = {i: os.path.basename(imagecols_all.image_name(i))
               for i in imagecols_all.get_img_ids()}
    test_names = {os.path.basename(n) for n in test_split}
    q_ids = [i for i in imagecols_all.get_img_ids()
             if name_of[i] in test_names]
    db_ids = [i for i in imagecols_all.get_img_ids()
              if name_of[i] not in test_names]
    imagecols_db = imagecols_all.subset_by_image_ids(db_ids)
    imagecols_q = imagecols_all.subset_by_image_ids(q_ids)

    if args.linemap:
        linemap, _, _, _ = limapio.read_folder_linetracks_with_info(
            args.linemap)
    else:
        linemap = line_triangulation(dict(cfg), imagecols_db,
                                     device=args.device)

    point_corresp = {}
    if args.point_corresp:
        data = np.load(args.point_corresp)
        for key in data.files:
            if key.startswith("p3ds_"):
                qid = int(key[5:])
                point_corresp[qid] = (data[key], data[f"p2ds_{qid}"])

    retrieval = {}
    db_centers = np.stack([imagecols_db.campose(i).center()
                           for i in db_ids])
    for qid in q_ids:
        c = imagecols_q.campose(qid).center()
        order = np.argsort(np.linalg.norm(db_centers - c, axis=1))
        retrieval[qid] = [db_ids[j] for j in
                          order[:cfg.get("n_retrieval", 10)]]

    poses = hybrid_localization(dict(cfg), imagecols_db, imagecols_q,
                                point_corresp, linemap, retrieval,
                                results_path=args.results_path,
                                device=args.device)
    print(f"localized {len(poses)} queries -> {args.results_path}")


if __name__ == "__main__":
    main()
