"""The hybrid BA driver (``solve_hybrid_bundle_adjustment``): the JAX
package on a one-device CPU mesh against the port on the CPU, on
``tests/test_hybrid_ba_driver.py``'s scene (6 views, 24 lines, 40 points,
two exact poses), 5 LM iterations."""

import numpy as np
import pytest

from limap_tpu.parallel import HybridBAOptions as JaxOptions
from limap_tpu.parallel import make_mesh
from limap_tpu.parallel import solve_hybrid_bundle_adjustment as jax_solve
from limap_tpu.util.evaluation import eval_imagecols as jax_eval
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.base.linetrack import LineTrack
from limap_tpu_torch.parallel import (HybridBAOptions,
                                      solve_hybrid_bundle_adjustment)
from limap_tpu_torch.structures.pl_bipartite import PointTrack
from limap_tpu_torch.util.evaluation import eval_imagecols
from tests.test_hybrid_ba_driver import _scene
from torch_threads import two_torch_threads  # noqa: F401

N_ITER = 5
# a cost below this share of the first is at float32's resolution of the
# residuals (pixel coordinates of ~500 rounded at 3e-5 px each), where an
# accept or reject is rounding noise
FLOOR = 1e-6


def _decisions(costs):
    return [b < a for a, b in zip(costs, costs[1:])]


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    gt_ic, noisy_ic, pts, lts, gt_pts = _scene(rng)
    jax_out = jax_solve(noisy_ic, pts, lts, JaxOptions(n_fixed_poses=2),
                        mesh=make_mesh(1), n_iterations=N_ITER)
    p_noisy = ImageCollection.from_dict(noisy_ic.as_dict())
    p_gt = ImageCollection.from_dict(gt_ic.as_dict())
    p_pts = [PointTrack(np.asarray(t.p), list(t.image_id_list),
                        list(t.p2d_id_list),
                        [np.asarray(x) for x in t.p2d_list]) for t in pts]
    p_lts = [LineTrack(line=np.asarray(t.line),
                       image_id_list=list(t.image_id_list),
                       line_id_list=list(t.line_id_list),
                       line2d_list=[np.asarray(x) for x in t.line2d_list])
             for t in lts]
    port_out = solve_hybrid_bundle_adjustment(
        p_noisy, p_pts, p_lts, HybridBAOptions(n_fixed_poses=2),
        n_iterations=N_ITER, device="cpu")
    return gt_ic, p_gt, p_noisy, jax_out, port_out


def test_same_accept_reject_sequence(runs):
    *_, jax_out, port_out = runs
    jc, pc = jax_out[3], port_out[3]
    assert len(jc) == len(pc) == N_ITER + 1
    assert abs(pc[0] - jc[0]) <= 1e-5 * jc[0]
    for i, (dj, dp) in enumerate(zip(_decisions(jc), _decisions(pc))):
        clear = max(abs(jc[i + 1] - jc[i]) / jc[i],
                    abs(pc[i + 1] - pc[i]) / pc[i]) > 1e-4 \
            and min(jc[i], pc[i]) > FLOOR * jc[0]
        if dj != dp:
            # a near tie parts the two runs; nothing after it compares
            assert not clear, (i, jc, pc)
            break
    assert _decisions(jc)[0] and _decisions(pc)[0]


def test_same_pose_errors_points_and_lines(runs):
    gt_ic, p_gt, p_noisy, jax_out, port_out = runs
    je = np.asarray(jax_eval(jax_out[0], gt_ic))
    pe = np.asarray(eval_imagecols(port_out[0], p_gt))
    assert np.abs(pe - je).max() <= 1e-3
    # the BA improved the poses it was given
    before = np.asarray(eval_imagecols(p_noisy, p_gt))
    assert np.median(pe[0]) < 0.5 * np.median(before[0])
    assert np.median(pe[1]) < 0.7 * np.median(before[1])
    assert np.abs(port_out[1] - jax_out[1]).max() <= 1e-3
    assert len(port_out[2]) == len(jax_out[2])
    for a, b in zip(port_out[2], jax_out[2]):
        assert np.abs(np.asarray(a.line) - np.asarray(b.line)).max() <= 1e-3
        assert list(a.image_id_list) == list(b.image_id_list)


def test_one_device_mesh_is_accepted_and_more_raise(runs):
    gt_ic, p_gt, *_ = runs
    with pytest.raises(NotImplementedError, match="item 13"):
        solve_hybrid_bundle_adjustment(p_gt, [], [], mesh=4, device="cpu")
    out = solve_hybrid_bundle_adjustment(p_gt, [], [], mesh=1,
                                         n_iterations=1, device="cpu")
    assert len(out[3]) == 2 and out[1].shape == (0, 3)
