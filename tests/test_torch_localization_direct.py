"""The port's PnPL estimator in direct mode (no sampling: the pose held
to the JAX package's at 1e-4), its determinism and input checks, and the
port's localization runner with RANSAC estimation on the CPU."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.estimators import pl_estimate_absolute_pose as j_estimate
from limap_tpu_torch.base.camera import Camera as TCamera
from limap_tpu_torch.base.camera import CameraPose as TPose
from limap_tpu_torch.base.image_collection import ImageCollection as TCols
from limap_tpu_torch.estimators import pl_estimate_absolute_pose
from limap_tpu_torch.util.evaluation import compute_pose_err
from tests.test_localization import make_problem
from torch_threads import two_torch_threads  # noqa: F401


def test_direct_mode_matches_jax():
    rng = np.random.default_rng(5)
    camera, pose_gt, p3ds, p2ds, l3ds, l3d_ids, l2ds = make_problem(
        rng, outlier_ratio=0.0, noise=0.2)
    # lines with an endpoint near the camera plane project thousands of
    # pixels off; from such a start the LM walks a long flat valley and
    # two roundings of it stop 50 iterations apart
    depth = (l3ds @ pose_gt.R().T + pose_gt.tvec)[..., 2].min(1)
    l3d_ids = l3d_ids[depth > 2.0]
    l2ds = l2ds[depth > 2.0]
    dq = Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix()
    pose0 = JPose(R=dq @ pose_gt.R(), tvec=pose_gt.tvec + 0.03)
    cfg = {"ransac": {"method": None},
           "optimize": {"loss": "huber", "loss_scale": 2.0},
           "line_cost_func": "PerpendicularDist"}
    keep = np.arange(len(p3ds)) % 5 != 0
    pj, sj = j_estimate(cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds, camera,
                        campose=pose0, inliers_point=keep)
    pt, st = pl_estimate_absolute_pose(
        cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds,
        TCamera(K=camera.K(), hw=(480, 640)),
        campose=TPose(pose0.qvec, pose0.tvec), inliers_point=keep,
        device="cpu")
    assert sj is None and st is None
    np.testing.assert_allclose(pt.qvec, pj.qvec, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.tvec, pj.tvec,
                               atol=1e-4 * np.abs(pj.tvec).max())
    assert compute_pose_err(pt, TPose(pose_gt.qvec, pose_gt.tvec))[0] < 0.01


def test_same_seed_same_hypotheses_and_pose():
    rng = np.random.default_rng(12)
    camera, _, p3ds, p2ds, l3ds, l3d_ids, l2ds = make_problem(
        rng, n_points=10, n_lines=6)
    cam = TCamera(K=camera.K(), hw=(480, 640))
    cfg = {"ransac": {"method": "hybrid", "n_hypotheses": 64,
                      "final_least_squares": False}}
    a, _ = pl_estimate_absolute_pose(cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds,
                                     cam, seed=3, device="cpu")
    b, _ = pl_estimate_absolute_pose(cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds,
                                     cam, seed=3, device="cpu")
    assert np.array_equal(a.qvec, b.qvec) and np.array_equal(a.tvec, b.tvec)
    with pytest.raises(ValueError, match=">= 3 correspondences"):
        pl_estimate_absolute_pose(cfg, l3ds[:0], [], l2ds[:0], p3ds[:2],
                                  p2ds[:2], cam, device="cpu")


def test_runner_hybrid_mode_on_cpu(tmp_path):
    """The port's runner with the default RANSAC estimation (H = 256),
    on the CPU: the query under 5 cm / 0.5 deg, most line matches
    inliers, and the stage seconds of every stage."""
    import cv2
    import importlib
    from limap_tpu_torch.runners import functions as t_functions
    from limap_tpu_torch.base.linetrack import LineTrack
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.profiler import StageProfiler
    from tests.test_torch_localization_runner import (DB_IDS, Q_ID, config,
                                                      linemap, query_inputs)
    runner = importlib.import_module(
        "limap_tpu_torch.runners.hybrid_localization")
    cols, imgs, _, gt = pipeline.build_scene(n_views=6, n_lines=30,
                                             hw=(240, 320))
    for i, img in imgs.items():
        cols.images[i].image_name = str(tmp_path / f"img_{i}.png")
        cv2.imwrite(cols.images[i].image_name, img)
    gt_pose, points, prior_R, prior_t = query_inputs(cols)
    db = cols.subset_by_image_ids(DB_IDS)
    query = TCols.from_dict(cols.as_dict()).subset_by_image_ids([Q_ID])
    query.set_camera_pose(Q_ID, TPose(R=prior_R, tvec=prior_t))
    cfg = config(tmp_path / "out", method="hybrid")
    segs, _ = t_functions.compute_2d_segs(t_functions.setup(dict(cfg)), db,
                                          compute_descinfo=False,
                                          device="cpu")
    prof, stats = StageProfiler(), {}
    poses = runner.hybrid_localization(
        cfg, db, query, {Q_ID: points}, linemap(segs, cols, gt, LineTrack),
        {Q_ID: DB_IDS}, device="cpu", prof=prof, stats=stats)
    te, re = compute_pose_err(poses[Q_ID], gt_pose)
    n_lines = stats[Q_ID]["n_line_matches"]
    print(f"hybrid: {te:.2e} m {re:.2e} deg, {n_lines} line matches, "
          f"stages {prof.times}")
    assert te < 0.05 and re < 0.5
    assert n_lines >= 10
    assert stats[Q_ID]["ransac"]["line_inliers"].sum() >= 0.6 * n_lines
    assert set(prof.times) == {"detect", "match_2d2d", "reprojection_filter",
                               "pnpl_sample_solve", "pnpl_score",
                               "pnpl_lo_polish"}
