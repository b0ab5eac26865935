"""The comparisons that hold the localization kernels to their plain
versions (limap_tpu_torch/testing/kernel_checks.py), checked on the CPU:
they accept a result that differs from the plain one by rounding (the
plain version on inputs moved by one ulp, the degenerate inputs
included) and refuse one with a real fault."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops.epipolar_iou import epipolar_iou_grid_plain
from limap_tpu_torch.ops.pose_score import ScoreParams, pose_score_plain
from limap_tpu_torch.ops.trace_roots import alpha_grid, trace_roots_plain
from limap_tpu_torch.testing import kernel_checks as kc


@pytest.fixture(autouse=True)
def one_thread():
    """Small eager ops: intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roots(arrays):
    args = [torch.as_tensor(x) for x in arrays]
    grid = torch.as_tensor(alpha_grid(256))
    return trace_roots_plain(*args, grid, 48, 4), args, grid


def _scores(arrays, params):
    args = [torch.as_tensor(x) for x in arrays]
    return (pose_score_plain(*args, params),
            pose_score_plain(*args, params, errors=True), args)


def _path_like_scoring_inputs(seed):
    """Hypotheses from random minimal samples of a synthetic problem, as
    the estimator scores them (wild poses among them)."""
    from limap_tpu_torch.base.pose import rotmat_to_quat
    from limap_tpu_torch.estimators.absolute_pose import minimal_hypotheses
    from limap_tpu_torch.testing.localization import synthetic_problem
    cam, _, p3, p2, l3, l3_ids, l2 = synthetic_problem(
        np.random.default_rng(seed), n_points=300, n_lines=60)
    l3 = l3[l3_ids]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).contiguous()

    kv, p3d, p2d = t(cam.kvec()), t(p3), t(p2)
    l3s, l3e, l2s, l2e = t(l3[:, 0]), t(l3[:, 1]), t(l2[:, 0]), t(l2[:, 1])
    Rs, ts, _ = minimal_hypotheses(kv, p3d, p2d, l3, l2s, l2e, 512, seed)
    return [x.numpy() for x in (rotmat_to_quat(Rs).contiguous(),
                                ts.contiguous(), kv, p3d, p2d, l3s, l3e,
                                l2s, l2e)]


@pytest.mark.parametrize("seed,degenerate", kc.SEEDS)
def test_root_comparison_accepts_rounding_and_refuses_faults(seed,
                                                             degenerate):
    inputs = kc.trace_roots_inputs(seed, B=512, degenerate=degenerate)
    ref, args, grid = _roots(inputs)
    deficient = kc.rank_deficient(*args, grid)
    # the degenerate third of the instances, and no other, is rank-deficient
    assert deficient.sum() == (512 // 3 if degenerate else 0)
    moved, _, _ = _roots(kc.one_ulp(inputs, seed))
    res = kc.compare_trace_roots(moved, ref, 4, deficient)
    assert res["ok"], res
    # without the rank test the degenerate instances' double roots differ
    if degenerate:
        assert not kc.compare_trace_roots(moved, ref, 4,
                                          np.zeros(512, bool))["ok"]
    # a fault: the simple roots' rotations transposed
    R, ok = ref
    bad = R.clone()
    bad[:, :4] = bad[:, :4].transpose(-1, -2)
    assert not kc.compare_trace_roots((bad, ok), ref, 4, deficient)["ok"]
    # the float64 witness admits no fault either
    assert not kc.compare_trace_roots((bad, ok), ref, 4, deficient,
                                      args + [grid])["ok"]
    assert kc.compare_trace_roots(moved, ref, 4, deficient,
                                  args + [grid])["ok"]


# instances of trace_roots_inputs(12, B=16384) where two roots lie close
# (1450, 12835: the float32 plain root is 1.5e-3 and 3.1e-3 rad off the
# float64 one, its rotation 2.8e-3 off), among well-conditioned ones
CLOSE_ROOTS = [1450, 12835] + list(range(0, 62))


def _close_roots():
    inputs = [x[CLOSE_ROOTS] for x in kc.trace_roots_inputs(12, B=16384)]
    ref, args, grid = _roots(inputs)
    R64, ok64 = trace_roots_plain(*[a.double() for a in args],
                                  grid.double(), 60, 4)
    return ref, (R64.float(), ok64), args + [grid]


def test_root_witness_accepts_the_float64_roots():
    """The float64 roots against the float32 plain version: where two
    roots lie close the plain one is off by more than ROOTS_SIMPLE_TOL,
    and the float64 witness, alone, accepts the true root."""
    ref, exact, args = _close_roots()
    deficient = kc.rank_deficient(*args)
    assert not kc.compare_trace_roots(exact, ref, 4, deficient)["ok"]
    res = kc.compare_trace_roots(exact, ref, 4, deficient, args)
    assert res["simple_beyond_tol"] == res["simple_witnessed"] == 2, res
    assert res["ok"], res


@pytest.mark.parametrize("instance", [0, 2])
def test_root_witness_refuses_a_wrong_root(instance):
    """Off the root (0.01 rad along the family), the root's rotation
    transposed or turned by 5e-3 rad about its axis, or the rotation of
    the next grid cell: refused, at a root close to another one
    (instance 0) and at a well-conditioned one (instance 2)."""
    ref, exact, args = _close_roots()
    deficient = kc.rank_deficient(*args)
    R, ok = exact
    from limap_tpu_torch.ops.trace_roots import family_eval, rot_axis_angle
    n = instance
    data = [a[n:n + 1].double() for a in args[:4]]
    alpha = kc.root_alpha(R[n, :1].double(), data[0], data[1])
    for fault in ("off the root", "transposed", "turned", "next cell"):
        bad = R.clone()
        if fault == "transposed":
            bad[n, 0] = R[n, 0].T.clone()
        elif fault == "turned":
            _, beta, _, d, R0 = family_eval(alpha, *data)
            bad[n, 0] = (rot_axis_angle(d, beta + 5e-3) @ R0)[0].float()
        else:
            step = 0.01 if fault == "off the root" else 2 * np.pi / 256
            bad[n, 0] = kc.family_rotation(alpha + step, *data)[0].float()
        res = kc.compare_trace_roots((bad, ok), ref, 4, deficient, args)
        assert res["simple_beyond_tol"] > res["simple_witnessed"], fault
        assert not res["ok"], fault


@pytest.mark.parametrize("inputs", ["seeded-0", "seeded-1",
                                    "seeded-2-degenerate", "path-like"])
def test_score_comparison_accepts_rounding_and_refuses_faults(inputs):
    params = ScoreParams.from_thresholds(10.0, 10.0)
    if inputs == "path-like":
        arrays = _path_like_scoring_inputs(3)
    else:
        arrays = kc.pose_score_inputs(int(inputs.split("-")[1]), H=256,
                                      Np=300, Nl=60,
                                      degenerate=inputs.endswith("ate"))
    ref, ref_err, args = _scores(arrays, params)
    spread = kc.pose_score_spread(args, params)
    for k in range(2):
        moved, moved_err, _ = _scores(kc.one_ulp(arrays, 100 + k), params)
        res = kc.compare_pose_score(moved, ref, moved_err, ref_err, params,
                                    spread)
        assert res["ok"], res
    # faults: scores off by 1e-4; point errors off by 0.01 px; masks
    # that are not the errors against th^2
    s, p, l = ref
    fin = torch.isfinite(s)
    bad = torch.where(fin, s * (1 + 1e-4), s)
    assert not kc.compare_pose_score((bad, p, l), ref, ref_err, ref_err,
                                     params, spread)["ok"]
    e_bad = ((ref_err[0].sqrt() + 0.01) ** 2, ref_err[1])
    assert not kc.compare_pose_score(ref, ref, e_bad, ref_err, params,
                                     spread)["ok"]
    assert not kc.compare_pose_score((s, ~p, l), ref, ref_err, ref_err,
                                     params, spread)["ok"]


@pytest.mark.parametrize("seed,degenerate", kc.SEEDS)
def test_iou_comparison_accepts_rounding_and_refuses_faults(seed,
                                                            degenerate):
    inputs = kc.epipolar_inputs(seed, Nr=120, Nt=150, degenerate=degenerate)
    ref = epipolar_iou_grid_plain(*(torch.as_tensor(x) for x in inputs))
    # the epipolar lines move, not the segments: a zero-length segment
    # moved by one ulp is another problem, not the same one rounded
    moved = epipolar_iou_grid_plain(*(torch.as_tensor(x) for x in (
        inputs[0], *kc.one_ulp(inputs[1:], seed))))
    res = kc.compare_epipolar(moved, ref)
    assert res["ok"], res
    bad = ref.clone()
    bad.view(-1)[::100] += 1e-3
    assert not kc.compare_epipolar(bad, ref)["ok"]
