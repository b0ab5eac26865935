"""7Scenes hybrid localization (reference: runners/7scenes/localization.py).

The reference drives hloc end-to-end (SfM, retrieval, point-only
localization) then LIMAP.  Here the dataset-agnostic machinery lives in
the library; this entry wires the 7Scenes conventions:

  - db/query split from the scene's TrainSplit.txt / TestSplit.txt
  - frames  seq-XX/frame-YYYYYY.color.png, poses *.pose.txt (cam2world)
  - the shared Kinect intrinsics (585, 585, 320, 240)
  - line map built on the db images with line_triangulation (or loaded)
  - point correspondences from an hloc log pickle
    (--hloc_log, parsed by get_hloc_keypoints_from_log) or an npz
"""

import argparse
import importlib
import os

import numpy as np

from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.runners import hybrid_localization, line_triangulation
from limap_tpu_torch.runners.hybrid_localization import \
    get_hloc_keypoints_from_log
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util.config import load_cli_config, update_config

K_7SCENES = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1.0]])


def _read_split(scene_dir, fname):
    seqs = []
    with open(os.path.join(scene_dir, fname)) as f:
        for line in f:
            line = line.strip()
            if line.startswith("sequence"):
                seqs.append(int(line[len("sequence"):]))
    return seqs


def read_scene_7scenes(scene_dir, seqs, start_id=0):
    """-> ImageCollection over the listed sequences."""
    cams = {0: Camera(K=K_7SCENES, hw=(480, 640), cam_id=0)}
    images = {}
    img_id = start_id
    names = {}
    for seq in seqs:
        seq_dir = os.path.join(scene_dir, f"seq-{seq:02d}")
        frames = sorted(f for f in os.listdir(seq_dir)
                        if f.endswith(".color.png"))
        for fr in frames:
            stem = fr[:-len(".color.png")]
            Twc = np.loadtxt(os.path.join(seq_dir, stem + ".pose.txt"))
            R = Twc[:3, :3].T
            t = -R @ Twc[:3, 3]
            images[img_id] = CameraImage(
                0, CameraPose(R=R, tvec=t),
                image_name=os.path.join(seq_dir, fr))
            names[img_id] = f"seq-{seq:02d}/{fr}"
            img_id += 1
    return ImageCollection(cams, images), names


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hybrid point+line localization on 7Scenes")
    parser.add_argument("-c", "--config_file", type=str,
                        default="cfgs/localization/7scenes.yaml")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scene", type=str, default="stairs")
    parser.add_argument("--linemap", type=str, default=None,
                        help="saved finaltracks folder (else triangulate)")
    parser.add_argument("--hloc_log", type=str, default=None,
                        help="hloc localization log pickle")
    parser.add_argument("--run_hloc", action="store_true",
                        help="drive hloc end-to-end (features, "
                             "covisibility SfM, point localization) — "
                             "requires the hloc toolbox installed; "
                             "mirrors the reference run_hloc_7scenes")
    parser.add_argument("--use_dense_depth", action="store_true",
                        help="with --run_hloc: correct the SfM points "
                             "with rendered GT depth")
    parser.add_argument("--point_corresp", type=str, default=None,
                        help="npz with p3ds_<qid>/p2ds_<qid> arrays")
    parser.add_argument("--results_path", type=str,
                        default="7scenes_results.txt")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = load_cli_config(args.config_file)
    cfg = update_config(cfg, unknown, {})
    scene_dir = os.path.join(args.data_dir, args.scene)

    db_seqs = _read_split(scene_dir, "TrainSplit.txt")
    q_seqs = _read_split(scene_dir, "TestSplit.txt")
    imagecols_db, _ = read_scene_7scenes(scene_dir, db_seqs)
    imagecols_q, qnames = read_scene_7scenes(
        scene_dir, q_seqs, start_id=10_000_000)

    if args.linemap:
        linemap, _, _, _ = limapio.read_folder_linetracks_with_info(
            args.linemap)
    else:
        linemap = line_triangulation(dict(cfg), imagecols_db,
                                     device=args.device)

    if args.run_hloc and not args.hloc_log:
        # end-to-end hloc driving (import-gated): produces the
        # point-only results + the localization log the rest of this
        # pipeline lifts 2D-3D point correspondences from
        _mod = importlib.import_module("limap_tpu_torch.runners.7scenes.utils")
        get_result_filenames = _mod.get_result_filenames
        run_hloc_7scenes = _mod.run_hloc_7scenes
        results_point, _ = get_result_filenames(
            cfg["localization"],
            use_dense_depth=args.use_dense_depth)
        out_dir = os.path.join(cfg.get("output_dir", "outputs"),
                               f"7scenes_{args.scene}")
        limapio.check_makedirs(out_dir)
        _, log_path, _, _, _, _ = run_hloc_7scenes(
            cfg, args.data_dir, args.scene,
            os.path.join(out_dir, results_point),
            os.path.join(scene_dir, "test_list.txt")
            if os.path.exists(os.path.join(scene_dir, "test_list.txt"))
            else None,
            use_dense_depth=args.use_dense_depth)
        args.hloc_log = log_path

    point_corresp = {}
    if args.point_corresp:
        data = np.load(args.point_corresp)
        for key in data.files:
            if key.startswith("p3ds_"):
                qid = int(key[5:])
                point_corresp[qid] = (data[key], data[f"p2ds_{qid}"])
    elif args.hloc_log:
        import pickle

        with open(args.hloc_log, "rb") as f:
            logs = pickle.load(f)
        for qid, name in qnames.items():
            try:
                p2ds, p3ds, _ = get_hloc_keypoints_from_log(logs, name)
                point_corresp[qid] = (p3ds, p2ds)
            except KeyError:
                continue

    # retrieval: nearest db poses (priors come from the dataset split)
    retrieval = {}
    db_ids = imagecols_db.get_img_ids()
    db_centers = np.stack([imagecols_db.campose(i).center()
                           for i in db_ids])
    for qid in imagecols_q.get_img_ids():
        c = imagecols_q.campose(qid).center()
        order = np.argsort(np.linalg.norm(db_centers - c, axis=1))
        retrieval[qid] = [db_ids[j] for j in
                          order[:cfg.get("n_retrieval", 10)]]

    poses = hybrid_localization(dict(cfg), imagecols_db, imagecols_q,
                                point_corresp, linemap, retrieval,
                                results_path=args.results_path,
                                device=args.device)
    # evaluation against the split's GT poses
    errs_t, errs_r = [], []
    for qid, pose in poses.items():
        gt = imagecols_q.campose(qid)
        errs_t.append(np.linalg.norm(pose.center() - gt.center()))
        cosq = min(abs(float(np.dot(pose.qvec, gt.qvec))), 1.0)
        errs_r.append(np.degrees(2 * np.arccos(cosq)))
    if errs_t:
        print(f"median errors: {np.median(errs_t) * 100:.2f} cm, "
              f"{np.median(errs_r):.3f} deg over {len(errs_t)} queries")


if __name__ == "__main__":
    main()
