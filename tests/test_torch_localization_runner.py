"""The port's hybrid localization runner against the JAX package's, on
one query of a rendered 6-view scene at 240x320: both detect the same
PNG images with tpu_lsd, match the query's lines to the 5 database
images by epipolar IoU, lift them through a line map built from their
own detections and the true 3D lines, and estimate the pose from those
lines and 30 wall points.  Also: the epipolar IoU grid against the JAX
package's per-pair computation, and a database map with only some
detections in tracks."""

import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.base.image_collection import ImageCollection as JCols
from limap_tpu.base.linetrack import LineTrack as JTrack
from limap_tpu.util.evaluation import compute_pose_err as j_err
from limap_tpu_torch.base.camera import CameraPose
from limap_tpu_torch.base.linetrack import LineTrack
from limap_tpu_torch.ops.epipolar_iou import (epipolar_iou_grid,
                                              epipolar_iou_grid_plain)
from limap_tpu_torch.testing import pipeline
from limap_tpu_torch.util.config import default_localization_config
from limap_tpu_torch.util.evaluation import compute_pose_err

# the runner modules (their packages export the function of that name)
j_runner_mod = importlib.import_module("limap_tpu.runners.hybrid_localization")
t_runner_mod = importlib.import_module(
    "limap_tpu_torch.runners.hybrid_localization")
DB_IDS = [0, 1, 2, 3, 4]
Q_ID = 5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("loc_scene")
    cols, imgs, _, gt = pipeline.build_scene(n_views=6, n_lines=30,
                                             hw=(240, 320))
    for i, img in imgs.items():
        name = str(root / f"img_{i}.png")
        cv2.imwrite(name, img)
        cols.images[i].image_name = name
    return cols, gt, root


def linemap(segs, cols, gt, track_cls):
    """One track per GT line seen in >= 2 database images: in each, the
    longest detection whose endpoints lie within 1.5 px of the line's
    projection and whose midpoint lies on the projected segment."""
    tracks = []
    for line in gt:
        ids, lids, l2ds = [], [], []
        for i in DB_IDS:
            K, pose = cols.cam(0).K(), cols.campose(i)
            p = (K @ (line @ pose.R().T + pose.tvec).T).T
            a, b = p[0, :2] / p[0, 2], p[1, :2] / p[1, 2]
            d = (b - a) / np.linalg.norm(b - a)
            s = np.asarray(segs[i])[:, :4].reshape(-1, 2, 2)
            off = s - a
            perp = np.abs(off[..., 0] * d[1] - off[..., 1] * d[0]).max(1)
            along = (off.mean(1) @ d) / np.linalg.norm(b - a)
            ok = (perp < 1.5) & (along > 0) & (along < 1)
            if ok.any():
                k = int(np.flatnonzero(ok)[np.argmax(np.linalg.norm(
                    s[ok, 1] - s[ok, 0], axis=1))])
                ids.append(i)
                lids.append(k)
                l2ds.append(s[k])
        if len(ids) >= 2:
            tracks.append(track_cls(line=line, image_id_list=ids,
                                    line_id_list=lids, line2d_list=l2ds))
    return tracks


def query_inputs(cols):
    rng = np.random.default_rng(4)
    gt_pose = cols.campose(Q_ID)
    R, t = gt_pose.R().astype(np.float64), gt_pose.tvec
    p3ds = rng.uniform([-4, -3, pipeline.WALL_Z], [4, 3, pipeline.WALL_Z],
                       size=(30, 3))
    K = cols.cam(0).K()
    pc = p3ds @ R.T + t
    p2ds = (pc[:, :2] / pc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    p2ds += rng.normal(size=p2ds.shape) * 0.5
    prior_R = Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix() @ R
    return gt_pose, (p3ds, p2ds), prior_R, t + 0.05


def config(out, method=None):
    """The default config; the estimation's RANSAC method None (the
    direct solve from the prior, as the JAX runner does it when the query
    has a pose) unless given.  The RANSAC path is held against the JAX
    package in test_torch_localization_estimator.py, and runs through this
    runner in test_torch_localization_direct.py."""
    cfg = default_localization_config()
    cfg["output_dir"] = str(out)
    cfg["estimation"]["ransac"].update(method=method, thres_point=5.0,
                                       thres_line=5.0, n_hypotheses=256)
    return cfg


def test_hybrid_localization_matches_jax(scene, tmp_path):
    from limap_tpu.runners import functions as j_functions
    from limap_tpu_torch.runners import functions as t_functions
    cols, gt, _ = scene
    gt_pose, points, prior_R, prior_t = query_inputs(cols)

    # the port
    db, query = cols.subset_by_image_ids(DB_IDS), \
        copy.deepcopy(cols).subset_by_image_ids([Q_ID])
    query.set_camera_pose(Q_ID, CameraPose(R=prior_R, tvec=prior_t))
    cfg = config(tmp_path / "port")
    segs, _ = t_functions.compute_2d_segs(t_functions.setup(dict(cfg)), db,
                                          compute_descinfo=False,
                                          device="cpu")
    tracks = linemap(segs, cols, gt, LineTrack)
    stats = {}
    poses = t_runner_mod.hybrid_localization(
        cfg, db, query, {Q_ID: points}, tracks, {Q_ID: DB_IDS},
        results_path=str(tmp_path / "port_poses.txt"), device="cpu",
        stats=stats)

    # the JAX package, from the same images
    jcols = JCols.from_dict(cols.as_dict())
    jdb = jcols.subset_by_image_ids(DB_IDS)
    jquery = JCols.from_dict(cols.as_dict()).subset_by_image_ids([Q_ID])
    jquery.set_camera_pose(Q_ID, JPose(R=prior_R, tvec=prior_t))
    jcfg = config(tmp_path / "jax")
    jsegs, _ = j_functions.compute_2d_segs(j_functions.setup(dict(jcfg)),
                                           jdb, compute_descinfo=False)
    jtracks = linemap(jsegs, cols, gt, JTrack)
    jposes = j_runner_mod.hybrid_localization(
        jcfg, jdb, jquery, {Q_ID: points}, jtracks, {Q_ID: DB_IDS})

    assert len(tracks) == len(jtracks) >= 15
    n_lines = stats[Q_ID]["n_line_matches"]
    te, re = compute_pose_err(poses[Q_ID], gt_pose)
    te_j, re_j = j_err(jposes[Q_ID], JPose(gt_pose.qvec, gt_pose.tvec))
    print(f"{len(tracks)} tracks, {n_lines} line matches; port {te:.2e} m "
          f"{re:.2e} deg, JAX {te_j:.2e} m {re_j:.2e} deg")
    assert n_lines >= 10 and stats[Q_ID]["ransac"] is None
    assert te < 0.05 and re < 0.5 and te_j < 0.05 and re_j < 0.5
    # the same query pose to 1 cm / 0.1 deg
    d_t, d_r = compute_pose_err(poses[Q_ID],
                                CameraPose(jposes[Q_ID].qvec,
                                           jposes[Q_ID].tvec))
    assert d_t < 0.01 and d_r < 0.1
    with open(tmp_path / "port_poses.txt") as f:
        assert f.read().startswith(cols.image_name(Q_ID))


def test_epipolar_matching_matches_jax(scene):
    """The IoU grid of the plain version against the JAX package's
    per-pair compute_epipolar_iou, and the same match pairs."""
    from limap_tpu.base.lines import Segments as JSegs
    from limap_tpu.triangulation.functions import compute_epipolar_iou
    from limap_tpu.runners.hybrid_localization import _views_row
    cols, _, _ = scene
    rng = np.random.default_rng(6)
    ref = rng.uniform([0, 0, 0, 0], [320, 240, 320, 240], (70, 4))
    tgt = rng.uniform([0, 0, 0, 0], [320, 240, 320, 240], (90, 4))
    tgt[:5, 2:] = tgt[:5, :2]          # degenerate target segments
    args = (cols.cam(0), cols.campose(1), cols.cam(0), cols.campose(2))
    jcols = JCols.from_dict(cols.as_dict())
    jargs = (jcols.cam(0), jcols.campose(1), jcols.cam(0), jcols.campose(2))
    ii, jj = np.meshgrid(np.arange(70), np.arange(90), indexing="ij")
    r32, t32 = ref.astype(np.float32), tgt.astype(np.float32)
    iou_j = np.asarray(compute_epipolar_iou(
        JSegs(jnp.asarray(r32[ii.ravel(), :2]),
              jnp.asarray(r32[ii.ravel(), 2:])),
        _views_row(jargs[0], jargs[1], 70 * 90),
        JSegs(jnp.asarray(t32[jj.ravel(), :2]),
              jnp.asarray(t32[jj.ravel(), 2:])),
        _views_row(jargs[2], jargs[3], 70 * 90))).reshape(70, 90)
    ref_v = t_runner_mod._view(args[0], args[1], "cpu")
    tgt_v = t_runner_mod._view(args[2], args[3], "cpu")
    from limap_tpu_torch.ops.epipolar_iou import row_epipolar_lines
    ep_s, ep_e = row_epipolar_lines(torch.as_tensor(r32), ref_v, tgt_v)
    iou_t = epipolar_iou_grid(torch.as_tensor(t32), ep_s, ep_e).numpy()
    assert np.array_equal(np.isnan(iou_j), np.isnan(iou_t))
    fin = np.isfinite(iou_j)
    np.testing.assert_allclose(iou_t[fin], iou_j[fin], rtol=1e-4, atol=1e-5)
    assert np.array_equal(
        epipolar_iou_grid_plain(torch.as_tensor(t32), ep_s, ep_e).numpy(),
        iou_t, equal_nan=True)
    for th in (0.0, 0.2, 0.5):
        pj = j_runner_mod.match_line_2to2_epipolar_iou(ref, tgt, *jargs, th)
        pt = t_runner_mod.match_line_2to2_epipolar_iou(ref, tgt, *args, th,
                                                       device="cpu")
        near = np.abs(iou_j - th) < 1e-5
        sj = {tuple(p) for p in pj if not near[tuple(p)]}
        st = {tuple(p) for p in pt if not near[tuple(p)]}
        assert sj == st and len(sj) > 0
        assert np.array_equal(pt[np.lexsort(pt.T[::-1])], pt)   # row-major


def test_match_2to3_and_filter_match_jax(scene):
    cols, gt, _ = scene
    line2track = {1: np.array([-1, 0, 2, -1, 1])}
    pairs = np.array([[0, 1], [0, 2], [3, 0], [4, 4], [5, 2]])
    assert t_runner_mod.match_line_2to3(pairs, line2track, 1) \
        == j_runner_mod.match_line_2to3(pairs, line2track, 1)
    view = cols.camview(3)
    jview = JCols.from_dict(cols.as_dict()).camview(3)
    K, R, t = view.cam.K(), view.pose.R(), view.pose.tvec
    proj = [(K @ (ln @ R.T + t).T).T for ln in gt[:6]]
    ref = np.stack([np.r_[p[0, :2] / p[0, 2], p[1, :2] / p[1, 2]]
                    for p in proj])
    ref[1] += 4.0                         # within the 10 px distance
    ref[2, 2:] += [40.0, -60.0]           # turned: off the sine threshold
    cand = {0: [0, 1], 1: [1, 3, 1], 2: [2], 3: [4, 3], 5: [5, 0]}
    tt = [LineTrack(line=ln) for ln in gt[:6]]
    jt = [JTrack(line=ln) for ln in gt[:6]]
    a = t_runner_mod.reprojection_filter_matches_2to3(ref, view, cand, tt)
    b = j_runner_mod.reprojection_filter_matches_2to3(ref, jview, cand, jt)
    assert a == b and (0, 0) in a and (1, 1) in a
    assert all(r != 2 for r, _ in a)


def test_hloc_log_reader_matches_jax():
    logs = {"loc": {"q.png": {
        "keypoints_query": np.arange(8.0).reshape(4, 2),
        "points3D_ids": [3, 1, 3, 2],
        "PnP_ret": {"inlier_mask": np.array([1, 0, 1, 1], bool)}}}}
    sfm = {1: np.ones(3), 2: np.full(3, 2.0), 3: np.arange(3.0)}
    a = t_runner_mod.get_hloc_keypoints_from_log(
        logs, "q.png", sfm, resize_scales={"q.png": 2.0})
    b = j_runner_mod.get_hloc_keypoints_from_log(
        logs, "q.png", sfm, resize_scales={"q.png": 2.0})
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_superglue_matcher_is_not_ported(scene, tmp_path):
    cols, _, _ = scene
    cfg = config(tmp_path)
    cfg["localization"]["2d_matcher"] = "superglue_endpoints"
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        t_runner_mod.hybrid_localization(
            cfg, cols.subset_by_image_ids([0]), cols.subset_by_image_ids([1]),
            {}, [], {1: [0]}, device="cpu")


@pytest.mark.parametrize("method", [None, "hybrid"])
def test_nn_endpoints_matcher_matches_jax(scene, tmp_path, monkeypatch,
                                          method):
    """The descriptor matcher (patch endpoints, nearest neighbours, top 3)
    in place of the epipolar IoU, direct and hybrid: the same number of
    line matches as JAX, centres within 0.5 mm and rotations within 0.01
    deg of JAX's.  Both miss the 5 cm gate on this path (7.4 cm), so the
    port is held to JAX and not to GT."""
    from limap_tpu.runners import functions as j_functions
    from limap_tpu_torch.runners import functions as t_functions
    cols, gt, _ = scene
    gt_pose, points, prior_R, prior_t = query_inputs(cols)

    def nn_config(out):
        cfg = config(out, method)
        cfg["localization"].update({"2d_matcher": "nn_endpoints",
                                    "matcher_options": {"topk": 3}})
        return cfg

    db, query = cols.subset_by_image_ids(DB_IDS), \
        copy.deepcopy(cols).subset_by_image_ids([Q_ID])
    query.set_camera_pose(Q_ID, CameraPose(R=prior_R, tvec=prior_t))
    cfg = nn_config(tmp_path / "port")
    segs, _ = t_functions.compute_2d_segs(t_functions.setup(dict(cfg)), db,
                                          compute_descinfo=False,
                                          device="cpu")
    stats = {}
    poses = t_runner_mod.hybrid_localization(
        cfg, db, query, {Q_ID: points}, linemap(segs, cols, gt, LineTrack),
        {Q_ID: DB_IDS}, device="cpu", stats=stats)

    jcols = JCols.from_dict(cols.as_dict())
    jdb = jcols.subset_by_image_ids(DB_IDS)
    jquery = JCols.from_dict(cols.as_dict()).subset_by_image_ids([Q_ID])
    jquery.set_camera_pose(Q_ID, JPose(R=prior_R, tvec=prior_t))
    jcfg = nn_config(tmp_path / "jax")
    jsegs, _ = j_functions.compute_2d_segs(j_functions.setup(dict(jcfg)),
                                           jdb, compute_descinfo=False)
    n_matches = []
    estimate = j_runner_mod.pl_estimate_absolute_pose

    def counted(cfg_, l3ds, l3d_ids, *args, **kwargs):
        n_matches.append(len(l3d_ids))
        return estimate(cfg_, l3ds, l3d_ids, *args, **kwargs)

    monkeypatch.setattr(j_runner_mod, "pl_estimate_absolute_pose", counted)
    jposes = j_runner_mod.hybrid_localization(
        jcfg, jdb, jquery, {Q_ID: points}, linemap(jsegs, cols, gt, JTrack),
        {Q_ID: DB_IDS})

    n_lines = stats[Q_ID]["n_line_matches"]
    te, re = compute_pose_err(poses[Q_ID], gt_pose)
    te_j, re_j = j_err(jposes[Q_ID], JPose(gt_pose.qvec, gt_pose.tvec))
    # apart, in f64 from the quaternions: f32 rotation matrices read an
    # angle under ~0.03 deg as 0 or 0.028
    ra, rb = (Rotation.from_quat(np.roll(np.asarray(p.qvec, np.float64), -1))
              for p in (poses[Q_ID], jposes[Q_ID]))
    d_r = float(np.degrees((ra.inv() * rb).magnitude()))
    d_t = float(np.linalg.norm(poses[Q_ID].center()
                               - np.asarray(jposes[Q_ID].center())))
    print(f"{method}: {n_lines} / {n_matches} line matches; port {te:.4e} m "
          f"{re:.4e} deg, JAX {te_j:.4e} m {re_j:.4e} deg; apart {d_t:.2e} m "
          f"{d_r:.2e} deg")
    assert n_matches == [n_lines] and n_lines >= 5
    assert d_t < 5e-4 and d_r < 0.01
