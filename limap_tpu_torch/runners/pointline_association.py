"""Joint point-line(-VP) association on a saved line map.

Resume from a line map, build per-image point-line bipartites from the
SfM points, cluster VP tracks (VP detection in one launch of kernel J),
run the global associator (kernels L and M, iterating VP-track merging
to a fixpoint) and save the jointly refined tracks.

    python -m limap_tpu_torch.runners.pointline_association \\
        -i FINALTRACKS_FOLDER --colmap_model_path MODEL [-c CONFIG] \\
        [--no_vp] [--device cpu] [--section.key value ...]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from typing import Dict

import numpy as np

import limap_tpu_torch.runners.functions as runners
from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.functions import get_invert_idmap_from_linetracks
from limap_tpu_torch.base.linetrack import batch_to_tracks, tracks_to_batch
from limap_tpu_torch.optimize.global_pl_association import (
    GlobalAssociator, GlobalAssociatorConfig, construct_weights_pointline)
from limap_tpu_torch.structures import (PL_Bipartite2dConfig, PointTrack,
                                        compute_2d_bipartites_from_points)
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.vplib import (GlobalVPTrackConstructor, get_vp_detector,
                                   merge_vptracks_by_direction)


def _vpline_weights(vptracks, linetracks, vpresults):
    """(vp track, line track) -> the count of the line track's supports
    whose 2D line belongs to one of the VP track's per-image VPs."""
    weights = {}
    for v_id, track in enumerate(vptracks):
        vp_nodes = set(track.supports)
        for lt_id, ltrack in enumerate(linetracks):
            cnt = 0
            for img_id, line_id in zip(ltrack.image_id_list,
                                       ltrack.line_id_list):
                resu = vpresults.get(img_id)
                if resu is None or line_id >= resu.count_lines():
                    continue
                if resu.HasVP(line_id) and \
                        (img_id, resu.GetVPLabel(line_id)) in vp_nodes:
                    cnt += 1
            if cnt:
                weights[(v_id, lt_id)] = cnt
    return weights


def pointline_association(cfg: dict, imagecols, linetracks,
                          all_2d_segs: Dict[int, np.ndarray],
                          points3d: Dict[int, dict],
                          points2d: Dict[int, np.ndarray],
                          use_vp: bool = True, device=None,
                          return_associator: bool = False):
    """Jointly refine points and lines (and VPs).

    Args:
      cfg: config with "structures" / "global_pl_association" sections.
      imagecols: the scene's cameras.
      linetracks: the line map (e.g. read from finaltracks).
      all_2d_segs: per-image detections.
      points3d: {pid: {xyz, image_ids}}; points2d: {img_id: (P, 3) x, y,
        pid}.
    Returns (new_linetracks, refined_points [P, 3], vps [V, 3]), and the
    last GlobalAssociator with ``return_associator``.
    """
    device = resolve_device(device)
    cfg = runners.setup(cfg)
    id2idx = imagecols.img_id_to_index()

    # [1] 2D bipartites from the SfM points
    bpt_cfg = PL_Bipartite2dConfig.from_dict(
        cfg.get("structures", {}).get("bpt2d"))
    all_bpt2ds, _ = compute_2d_bipartites_from_points(
        points3d, points2d, all_2d_segs, bpt_cfg, device=device)

    # [2] point tracks from points3d and their 2D observations
    point_tracks = []
    pid_to_idx = {}
    slots = []   # per track: img_id -> its entries, in order
    for pid, rec in points3d.items():
        tr = PointTrack(np.asarray(rec["xyz"]))
        slot = {}
        for img_id in rec["image_ids"]:
            if img_id not in id2idx:
                continue
            slot.setdefault(img_id, []).append(len(tr.image_id_list))
            tr.image_id_list.append(img_id)
            tr.p2d_list.append(np.zeros(2))
        pid_to_idx[int(pid)] = len(point_tracks)
        point_tracks.append(tr)
        slots.append(slot)
    # each observation fills the first entry of its image still at zero
    for img_id, arr in points2d.items():
        for x, y, pid in np.asarray(arr):
            idx = pid_to_idx.get(int(pid))
            if idx is None:
                continue
            tr = point_tracks[idx]
            for k in slots[idx].get(img_id, ()):
                if not tr.p2d_list[k].any():
                    tr.p2d_list[k] = np.array([x, y])
                    break

    # [3] VP tracks
    vptracks = []
    vpresults = None
    if use_vp:
        vpdet = get_vp_detector(cfg.get("vpdet_config",
                                        {"method": "jlinkage"}),
                                device=device)
        vpresults = vpdet.detect_vp_all_images(all_2d_segs)
        constructor = GlobalVPTrackConstructor()
        constructor.Init(vpresults)
        vptracks = constructor.cluster_line_tracks(linetracks, imagecols)

    # [4] association weights from bipartite co-occurrence
    line2track = get_invert_idmap_from_linetracks(all_2d_segs, linetracks)
    point_track_of_2d = {}
    for img_id, bpt in all_bpt2ds.items():
        point_track_of_2d[img_id] = {
            pid2d: pid_to_idx.get(int(bpt.point(pid2d).point3D_id), -1)
            for pid2d in bpt.get_point_ids()}
    line_track_of_2d = {img_id: {i: int(t) for i, t in enumerate(arr)}
                        for img_id, arr in line2track.items()}
    pl_weights = construct_weights_pointline(all_bpt2ds, point_track_of_2d,
                                             line_track_of_2d)
    vpl_weights = {}
    if vpresults is not None:
        vpl_weights = _vpline_weights(vptracks, linetracks, vpresults)

    # [5] global association, merging VP tracks to a fixpoint (<= 5 rounds)
    assoc_cfg = GlobalAssociatorConfig.from_dict(
        cfg.get("global_pl_association"))
    n_vps = len(vptracks)
    batch = tracks_to_batch(linetracks, id2idx, device=device)
    for _ in range(5):
        assoc = GlobalAssociator(assoc_cfg, device=device)
        assoc.init_imagecols(imagecols)
        assoc.init_line_tracks(batch)
        assoc.init_point_tracks(point_tracks)
        assoc.init_vp_tracks(vptracks)
        assoc.set_pointline_weights(pl_weights)
        assoc.set_vpline_weights(vpl_weights)
        assoc.solve()
        if not vptracks:
            break
        for v_id, t in enumerate(vptracks):
            t.direction = assoc.get_output_vps()[v_id]
        vptracks = merge_vptracks_by_direction(vptracks)
        if len(vptracks) == n_vps:
            break
        n_vps = len(vptracks)
        vpl_weights = _vpline_weights(vptracks, linetracks, vpresults)

    new_tracks = batch_to_tracks(assoc.get_output_lines())
    refined_points = assoc.points_out.cpu().numpy()
    out_dir = os.path.join(cfg["dir_save"],
                           cfg.get("output_folder", "associated_tracks"))
    limapio.save_folder_linetracks_with_info(
        out_dir, new_tracks, config=cfg, imagecols=imagecols,
        all_2d_segs=all_2d_segs)
    out = (new_tracks, refined_points, assoc.get_output_vps())
    return out + (assoc,) if return_associator else out


def main(argv=None):
    from limap_tpu_torch import pointsfm
    from limap_tpu_torch.util.config import (default_pl_association_config,
                                             load_config, update_config)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(
        description="joint point-line-VP association")
    parser.add_argument("-i", "--input_folder", type=str, required=True,
                        help="finaltracks folder")
    parser.add_argument("--colmap_model_path", type=str, required=True)
    parser.add_argument("-c", "--config_file", type=str,
                        default=os.path.join(repo_root, "cfgs",
                                             "global_pl_association",
                                             "default.yaml"))
    parser.add_argument("--no_vp", action="store_true")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    cfg = (load_config(args.config_file) if importlib.util.find_spec("yaml")
           else default_pl_association_config())
    cfg = update_config(cfg, unknown, {})
    cfg.setdefault("output_dir", "tmp_pl_association")
    tracks, _, imagecols, all_2d_segs = \
        limapio.read_folder_linetracks_with_info(args.input_folder)
    _, _, points2d, points3d = pointsfm.read_model(args.colmap_model_path)
    new_tracks, points, vps = pointline_association(
        cfg, imagecols, tracks, all_2d_segs, points3d, points2d,
        use_vp=cfg.get("use_vp", True) and not args.no_vp,
        device=args.device)
    print(f"associated: {len(new_tracks)} tracks, {len(points)} points, "
          f"{len(vps)} vps")


if __name__ == "__main__":
    main()
