"""The port's pose optimization and pose scoring against the JAX
package's, on the same numpy inputs: the line localization residuals
(6 costs x 5 weights), the joint point+line solve, the MSAC scores and
squared errors of candidate poses (the plain version of the pose_score
kernel), and the host helpers of the localization runner."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.lines import Segments as JSegs
from limap_tpu.estimators.absolute_pose import _pose_sq_errors, _score_poses
from limap_tpu.optimize import hybrid_localization as jhl
from limap_tpu_torch.base.camera import CameraPose as TPose
from limap_tpu_torch.base.camera import CameraViewsBatch as TViews
from limap_tpu_torch.base.lines import Segments as TSegs
from limap_tpu_torch.base.pose import rotmat_to_quat
from limap_tpu_torch.ops.pose_score import (ScoreParams, pose_score,
                                            pose_sq_errors_plain)
from limap_tpu_torch.optimize import hybrid_localization as thl
from limap_tpu_torch.testing import lm_checks
from tests.test_localization import make_problem


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def problem():
    return make_problem(np.random.default_rng(0))


@pytest.mark.parametrize("weight", thl.COST_WEIGHTS)
@pytest.mark.parametrize("cost", thl.COST_FUNCTIONS)
def test_line_loc_residuals_match_jax(problem, cost, weight):
    camera, pose, _, _, l3ds, _, l2ds = problem
    kv, q, tv = camera.kvec(), pose.qvec, pose.tvec
    cfg = dict(cost_function=cost, cost_function_weight=weight)
    rj = np.asarray(jhl.line_loc_residuals(
        JSegs(j(l3ds[:, 0]), j(l3ds[:, 1])), JSegs(j(l2ds[:, 0]),
                                                  j(l2ds[:, 1])),
        JViews(j(kv), j(q), j(tv)), jhl.LineLocConfig(**cfg)))
    rt = thl.line_loc_residuals(
        TSegs(t(l3ds[:, 0]), t(l3ds[:, 1])), TSegs(t(l2ds[:, 0]),
                                                  t(l2ds[:, 1])),
        TViews(t(kv), t(q), t(tv)), thl.LineLocConfig(**cfg)).numpy()
    assert rj.shape == rt.shape
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-5)


def test_cost_aliases_and_config_match_jax():
    assert thl._COST_ALIASES == jhl._COST_ALIASES
    d = {"cost_function": "E3DPlaneLineDist2",
         "cost_function_weight": "ECosineWeight", "loss": "huber"}
    assert dataclasses.asdict(thl.LineLocConfig.from_dict(d)) \
        == dataclasses.asdict(jhl.LineLocConfig.from_dict(d))
    p = thl.pack_pose(np.ones((3, 4)), np.zeros((3, 3)))
    assert p.shape == (3, 7) and p.dtype == torch.float32
    np.testing.assert_array_equal(
        thl.pack_pose([1.0, 0, 0, 0], [1.0, 2, 3]),
        jhl.pack_pose([1.0, 0, 0, 0], [1.0, 2, 3]))


# every cost function, 2D weight and robust loss at least once; the ids
# of the first three cases name their (loss, cost) alone
JOINTLOC_CASES = [
    pytest.param("trivial", "2d_perpendicular_dist2", "none",
                 id="trivial-2d_perpendicular_dist2"),
    pytest.param("huber", "2d_midpoint_dist2", "none",
                 id="huber-2d_midpoint_dist2"),
    pytest.param("cauchy", "3d_plane_line_dist2", "none",
                 id="cauchy-3d_plane_line_dist2"),
    ("cauchy", "2d_midpoint_angle_dist3", "cosine"),
    ("huber", "2d_perpendicular_dist4", "line3dpp"),
    ("trivial", "3d_line_line_dist2", "length"),
    ("huber", "2d_perpendicular_dist2", "invlength"),
]


@pytest.mark.parametrize("loss,cost,weight", JOINTLOC_CASES)
def test_solve_jointloc_matches_jax(loss, cost, weight):
    """The same start, 50 LM iterations: the final pose within 1e-4
    relative (f32 rounding in another order moves the accept tests only
    where the cost is flat)."""
    rng = np.random.default_rng(1)
    camera, pose_gt, p3ds, p2ds, l3ds, _, l2ds = make_problem(
        rng, outlier_ratio=0.0, noise=0.2)
    dq = Rotation.from_rotvec(rng.normal(size=3) * 0.02).as_matrix()
    pose0 = JPose(R=dq @ pose_gt.R(), tvec=pose_gt.tvec + 0.05)
    args = (l3ds[:, 0], l3ds[:, 1], l2ds[:, 0], l2ds[:, 1], p3ds, p2ds,
            camera.kvec(), pose0.qvec, pose0.tvec)
    mask = np.arange(len(l3ds)) % 4 != 0
    cfg = dict(loss=loss, loss_scale=2.0, cost_function=cost,
               cost_function_weight=weight)
    qj, tj, cj = jhl.solve_jointloc(*args, jhl.LineLocConfig(**cfg),
                                    line_mask=mask)
    qt, tt, ct = thl.solve_jointloc(*args, thl.LineLocConfig(**cfg),
                                    line_mask=mask, device="cpu")
    close = (np.allclose(qt, qj, rtol=1e-4, atol=1e-5)
             and np.allclose(tt, tj, rtol=1e-4, atol=1e-4 * np.abs(tj).max())
             and abs(ct - cj) <= 1e-3 * max(cj, 1.0))
    if weight == "line3dpp" and not close:
        # In float32 both packages' Jacobians turn NaN once a masked
        # line's |cos| rounds to 1 (arccos' = -1 / sqrt(1 - c^2)) and the
        # solve stops there; which one reaches that point first is
        # rounding.  The one with the higher cost must have stopped so.
        q, tv = (qt, tt) if ct > cj else (qj, tj)
        data = [t(x) for x in args[:4]] + [None] * 4 + [t(args[6])]
        c = lm_checks.line_cosines(data, [0], np.concatenate([q, tv])[None],
                                   torch.float64)[0][mask]
        assert 1 - float(c.max()) <= lm_checks.COS_TOL, (ct, cj)
        return
    np.testing.assert_allclose(qt, qj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt, tj, rtol=1e-4,
                               atol=1e-4 * np.abs(tj).max())
    assert abs(ct - cj) <= 1e-3 * max(cj, 1.0)


def test_solve_jointloc_batch_rows_are_independent():
    rng = np.random.default_rng(2)
    camera, pose_gt, p3ds, p2ds, l3ds, _, l2ds = make_problem(
        rng, n_points=15, n_lines=8, outlier_ratio=0.0, noise=0.2)
    starts = [TPose(R=Rotation.from_rotvec(rng.normal(size=3) * 0.02)
                    .as_matrix() @ pose_gt.R(), tvec=pose_gt.tvec + 0.05 * k)
              for k in range(3)]
    masks = rng.random((3, len(p3ds))) > 0.3
    data = (l3ds[:, 0], l3ds[:, 1], l2ds[:, 0], l2ds[:, 1], p3ds, p2ds,
            camera.kvec())
    q, tv, cost = thl.solve_jointloc_batch(
        *data, np.stack([p.qvec for p in starts]),
        np.stack([p.tvec for p in starts]), point_masks=masks,
        num_iterations=20, device="cpu")
    for k, p in enumerate(starts):
        qk, tk, ck = thl.solve_jointloc(*data, p.qvec, p.tvec,
                                        point_mask=masks[k],
                                        num_iterations=20, device="cpu")
        np.testing.assert_allclose(q[k].numpy(), qk, atol=1e-5)
        np.testing.assert_allclose(tv[k].numpy(), tk, atol=1e-4)


def _hypotheses(rng, pose_gt, H):
    """H poses around the truth, some far off, a few behind the camera."""
    R = Rotation.from_rotvec(rng.normal(size=(H, 3)) * 0.05).as_matrix() \
        @ pose_gt.R()
    tv = pose_gt.tvec + rng.normal(size=(H, 3)) * 0.2
    tv[: H // 8] -= [0.0, 0.0, 30.0]          # the scene behind the camera
    return R.astype(np.float32), tv.astype(np.float32)


def test_pose_score_plain_matches_jax(problem):
    """Scores at rtol 1e-5; inlier masks equal except where an error
    lies within 1e-4 th^2 of the threshold; errors equal where finite
    and infinite at the same places."""
    camera, pose_gt, p3ds, p2ds, l3ds, _, l2ds = problem
    rng = np.random.default_rng(3)
    Rs, ts = _hypotheses(rng, pose_gt, 256)
    kv = camera.kvec()
    data = (p3ds, p2ds, l3ds[:, 0], l3ds[:, 1], l2ds[:, 0], l2ds[:, 1])
    th_p, th_l = 5.0, 7.0
    sj, pj, lj = (np.asarray(x) for x in _score_poses(
        j(Rs), j(ts), j(kv), *map(j, data), th_p, th_l, 1.0, 0.5))
    epj, elj = (np.asarray(x) for x in _pose_sq_errors(
        j(Rs), j(ts), j(kv), *map(j, data)))

    qt = rotmat_to_quat(t(Rs))
    params = ScoreParams.from_thresholds(th_p, th_l, 1.0, 0.5)
    st, pt, lt = (x.numpy() for x in pose_score(
        qt, t(ts), t(kv), *map(t, data), params))
    ept, elt = (x.numpy() for x in pose_score(
        qt, t(ts), t(kv), *map(t, data), params, errors=True))

    np.testing.assert_allclose(st, sj, rtol=1e-5)
    for ej, et in ((epj, ept), (elj, elt)):
        assert np.array_equal(np.isinf(ej), np.isinf(et))
        fin = np.isfinite(ej)
        np.testing.assert_allclose(et[fin], ej[fin], rtol=1e-4, atol=1e-4)
    assert np.isinf(epj).any() and np.isinf(elj).any()
    for mj, mt, e, th in ((pj, pt, epj, th_p), (lj, lt, elj, th_l)):
        near = np.abs(e - th * th) < 1e-4 * th * th
        assert np.array_equal(mj[~near], mt[~near])
        print(f"{near.sum()} errors within 1e-4 th^2 of the threshold")
        assert mj.sum() > 0


def test_pose_sq_errors_plain_is_the_scoring_errors(problem):
    camera, pose_gt, p3ds, p2ds, l3ds, _, l2ds = problem
    q = t(pose_gt.qvec)[None]
    e_p, e_l = pose_sq_errors_plain(
        q, t(pose_gt.tvec)[None], t(camera.kvec()), t(p3ds), t(p2ds),
        t(l3ds[:, 0]), t(l3ds[:, 1]), t(l2ds[:, 0]), t(l2ds[:, 1]))
    assert e_p.shape == (1, len(p3ds)) and e_l.shape == (1, len(l3ds))
    # the inliers of the true pose sit within the noise
    assert (e_p[0, 12:] < 4.0).all() and (e_l[0, 6:] < 8.0).all()


def test_runner_host_helpers_match_jax(tmp_path):
    from limap_tpu.base.functions import get_all_lines_2d as j_lines
    from limap_tpu.base.functions import \
        get_invert_idmap_from_linetracks as j_inv
    from limap_tpu.base.image_collection import ImageCollection as JCols
    from limap_tpu.base.linetrack import LineTrack as JTrack
    from limap_tpu.util import evaluation as jev
    from limap_tpu_torch.base.functions import get_all_lines_2d as t_lines
    from limap_tpu_torch.base.functions import \
        get_invert_idmap_from_linetracks as t_inv
    from limap_tpu_torch.base.image_collection import \
        ImageCollection as TCols
    from limap_tpu_torch.base.linetrack import LineTrack as TTrack
    from limap_tpu_torch.testing.pipeline import build_scene
    from limap_tpu_torch.util import evaluation as tev

    segs = {0: np.zeros((5, 4)), 1: np.zeros((3, 5)), 7: np.zeros((0, 4))}
    tracks = [dict(line=np.zeros((2, 3)), image_id_list=[0, 1],
                   line_id_list=[4, 2]),
              dict(line=np.ones((2, 3)), image_id_list=[0, 9, 1],
                   line_id_list=[1, 0, 7])]
    a = j_inv(segs, [JTrack(**d) for d in tracks])
    b = t_inv(segs, [TTrack(**d) for d in tracks])
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    segs[1][:, 4] = 1.0
    a, b = j_lines(segs), t_lines(segs)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) and b[k].shape[1] == 4 for k in a)

    cols, _, _, _ = build_scene(n_views=5, n_lines=4, hw=(40, 60))
    jcols = JCols.from_dict(cols.as_dict())
    # a subset shares its images, as in the JAX package: keep the truth
    gt_t = TCols.from_dict(cols.as_dict()).subset_by_image_ids([1, 3])
    gt_j = JCols.from_dict(cols.as_dict()).subset_by_image_ids([1, 3])
    sub_t, sub_j = cols.subset_by_image_ids([1, 3]), \
        jcols.subset_by_image_ids([1, 3])
    assert sub_t.get_img_ids() == sub_j.get_img_ids() == [1, 3]
    np.testing.assert_allclose(np.asarray(sub_t.get_locations()),
                               np.asarray(sub_j.get_locations()), atol=1e-6)
    prior = TPose(R=Rotation.from_rotvec([0.01, 0.0, -0.02]).as_matrix()
                  @ cols.campose(3).R(), tvec=cols.campose(3).tvec + 0.05)
    sub_t.set_camera_pose(3, prior)
    sub_j.set_camera_pose(3, JPose(prior.qvec, prior.tvec))
    assert sub_t.get_camera_pose(3) is prior
    assert sub_t.cam(0).kvec().tolist() == sub_j.cam(0).kvec().tolist()
    assert cols.campose(3) is prior
    np.testing.assert_allclose(tev.eval_imagecols(sub_t, gt_t),
                               jev.eval_imagecols(sub_j, gt_j), atol=1e-6)
    te, re = tev.compute_pose_err(prior, gt_t.campose(3))
    assert 0.04 < te < 0.15 and 1.0 < re < 1.5


def test_default_localization_config_is_the_yaml():
    yaml = pytest.importorskip("yaml")
    from limap_tpu_torch.util.config import default_localization_config
    with open("cfgs/localization/default.yaml") as f:
        assert default_localization_config() == yaml.safe_load(f)
    a = default_localization_config()
    a["localization"]["ransac"]["thres"] = 0.0
    assert default_localization_config()["localization"]["ransac"][
        "thres"] == 10.0
