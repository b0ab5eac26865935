"""The port's PnPL estimator against the JAX package's on the same
problems.  The hypothesis samples cannot be the same (JAX's random
stream is not reproduced; the port draws with a CPU torch.Generator), so
the hybrid mode is held on outcomes: both under the JAX test's gates and
the same inlier sets on a noise-free problem (the direct mode is in
test_torch_localization_direct.py)."""

import numpy as np
import pytest
import torch

from limap_tpu.estimators import pl_estimate_absolute_pose as j_estimate
from limap_tpu.util.evaluation import compute_pose_err as j_err
from limap_tpu_torch.base.camera import Camera as TCamera
from limap_tpu_torch.base.camera import CameraPose as TPose
from limap_tpu_torch.estimators import pl_estimate_absolute_pose
from limap_tpu_torch.util.evaluation import compute_pose_err
from limap_tpu_torch.util.profiler import StageProfiler
from tests.test_localization import make_problem
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture()
def one_thread():
    """The port's LO is thousands of tiny eager ops: intra-op threads
    only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hybrid_mode_outcomes_match_jax(one_thread):
    """H = 128 hypotheses, 30 % outliers, no noise: both packages under
    5 cm / 0.5 deg (the JAX test's gates), within 1 mm of each other,
    and the same inlier sets (the true ones)."""
    noise = 0.0
    rng = np.random.default_rng(11)
    camera, pose_gt, p3ds, p2ds, l3ds, l3d_ids, l2ds = make_problem(
        rng, noise=noise)
    cfg = {"ransac": {"method": "hybrid", "thres_point": 5.0,
                      "thres_line": 5.0, "n_hypotheses": 128},
           "optimize": {"loss": "huber", "loss_scale": 2.0}}
    pj, sj = j_estimate(cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds, camera)
    prof = StageProfiler()
    pt, st = pl_estimate_absolute_pose(
        cfg, l3ds, l3d_ids, l2ds, p3ds, p2ds,
        TCamera(K=camera.K(), hw=(480, 640)), device="cpu", prof=prof)
    assert set(prof.times) == {"pnpl_sample_solve", "pnpl_score",
                               "pnpl_lo_polish"}
    gt = TPose(pose_gt.qvec, pose_gt.tvec)
    te_j, re_j = j_err(pj, pose_gt)
    te_t, re_t = compute_pose_err(pt, gt)
    print(f"noise {noise}: JAX {te_j:.2e} m {re_j:.2e} deg, port "
          f"{te_t:.2e} m {re_t:.2e} deg, inliers {sj['best_num_inliers']} "
          f"and {st['best_num_inliers']}")
    for te, re in ((te_j, re_j), (te_t, re_t)):
        assert te < 0.05 and re < 0.5
    assert np.linalg.norm(pt.center() - np.asarray(pj.center())) < 1e-3
    assert st["point_inliers"].sum() >= 0.6 * len(p3ds)
    assert np.array_equal(st["point_inliers"], sj["point_inliers"])
    assert np.array_equal(st["line_inliers"], sj["line_inliers"])
    n_out_p, n_out_l = int(len(p3ds) * 0.3), int(len(l2ds) * 0.3)
    assert not st["point_inliers"][:n_out_p].any()
    assert st["point_inliers"][n_out_p:].all()
    assert st["line_inliers"][n_out_l:].all()
