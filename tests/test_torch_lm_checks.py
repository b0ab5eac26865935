"""The comparisons of ``limap_tpu_torch/testing/lm_checks.py`` on the CPU:
the plain LM against itself, against itself from a start one ulp away
(its partings must be witnessed), and against faults (which must be
refused); the normal-equation tolerance, the damping replay, the corner
inputs and the operation counts.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import lm_jointloc, lm_line_ba
from limap_tpu_torch.optimize import lm
from limap_tpu_torch.optimize.line_ba import LineBAConfig, ba_residual
from limap_tpu_torch.testing import lm_checks as C


@pytest.fixture(scope="module")
def ba():
    return C.seeded_line_ba(seed=5, T=32, S=12, device="cpu")


@pytest.fixture(scope="module")
def loc():
    return C.seeded_jointloc(seed=6, T=4, device="cpu")


def one_ulp_up(params):
    return torch.nextafter(params, torch.full_like(params, 2.0))


def test_plain_against_itself(ba, loc):
    params0, aux = ba
    ne, sol = C.check_line_ba(params0, aux, LineBAConfig(), kernels=False)
    assert ne["ok"] and sol["ok"] and sol["parted"] == 0, (ne, sol)
    assert sol["accepted"] > 0
    params0, data = loc
    ne, sol = C.check_jointloc(params0, data,
                               C.loc_config(*C.JOINTLOC_CONFIGS[-1]),
                               num_iterations=20, kernels=False)
    assert ne["ok"] and sol["ok"] and sol["parted"] == 0, (ne, sol)


def _solve_pair(params_k, params_p, aux, residual, retract, D, n_iter):
    rk, rp = [], []
    res_k = lm.lm_solve(params_k, residual, retract, D, aux, n_iter, trace=rk)
    res_p = lm.lm_solve(params_p, residual, retract, D, aux, n_iter, trace=rp)
    return res_k, torch.stack(rk, 1), res_p, torch.stack(rp, 1)


def test_rounding_partings_are_witnessed(ba, loc):
    """A start one ulp away stands for a kernel that rounds otherwise:
    rows part, and each parting is witnessed."""
    params0, aux = ba
    cfg = LineBAConfig(loss="huber")
    out = _solve_pair(one_ulp_up(params0), params0, aux, ba_residual(cfg),
                      lm.retract_quat_so2, 4, 20)
    res = C.compare_solve(*out, C.line_ba_problem(aux, cfg),
                          2 * aux[-1].sum(1).numpy())
    assert res["ok"] and res["parted"] > 0, res
    params0, data = loc
    cfg = C.loc_config(*C.JOINTLOC_CONFIGS[-1])
    prob = C.jointloc_problem(data, cfg)
    out = _solve_pair(one_ulp_up(params0), params0, prob.aux, prob.f,
                      lm.retract_pose, 6, 30)
    res = C.compare_solve(*out, prob, C.jointloc_residual_count(data, cfg))
    assert res["ok"], res


def test_faulty_kernels_are_refused(ba):
    params0, aux = ba
    cfg = LineBAConfig()
    R = 2 * aux[-1].sum(1).numpy()
    prob = C.line_ba_problem(aux, cfg)
    rp = []
    res_p = lm.lm_solve(params0, ba_residual(cfg), lm.retract_quat_so2, 4,
                        aux, 20, trace=rp)
    tr_p = torch.stack(rp, 1)
    # an accept test that takes a step float64 rejects
    tr_k = tr_p.clone()
    rej = ~C.accepts(tr_p) & (tr_p[..., 0] > 0)
    row, it = (int(x) for x in rej.nonzero()[0])
    tr_k[row, it, 1] = tr_k[row, it, 0] - 1.0
    res = C.compare_solve(res_p, tr_k, res_p, tr_p, prob, R)
    assert not res["ok"] and res["unwitnessed"] == 1, res
    # a residual off by 1 %: the costs differ from the start
    off = lambda p, *a: 1.01 * ba_residual(cfg)(p, *a)
    rk = []
    res_k = lm.lm_solve(params0, off, lm.retract_quat_so2, 4, aux, 20,
                        trace=rk)
    res = C.compare_solve(res_k, torch.stack(rk, 1), res_p, tr_p, prob, R)
    assert not res["ok"] and res["max_cost0_err_over_tol"] > 1, res
    # a Jacobian off by a factor shows in the normal equations
    double = lambda p, d: lm.retract_quat_so2(p, 2.0 * d)
    ne_k = lm.normal_equations(params0, ba_residual(cfg), double, 4, aux)
    ne_p = lm.normal_equations(params0, ba_residual(cfg),
                               lm.retract_quat_so2, 4, aux)
    assert not C.compare_normal_equations(ne_k, ne_p, ne_p)["ok"]


def test_normal_equation_tolerance(ba):
    params0, aux = ba
    cfg = LineBAConfig()
    ne_p = lm_line_ba.normal_equations(params0, *aux, cfg)
    ne_64 = lm_line_ba.normal_equations_plain(
        params0.double(), [x if x.dtype == torch.bool else x.double()
                           for x in aux], cfg)
    assert C.compare_normal_equations(ne_p, ne_p, ne_64)["ok"]
    row = int(torch.argmax(ne_p[0][:, 0, 0]))
    off = [x.clone() for x in ne_p]
    off[0][row, 1, 2] += 2 * C.NE_RTOL * float(
        torch.sqrt(ne_p[0][row, 1, 1] * ne_p[0][row, 2, 2]))
    res = C.compare_normal_equations(off, ne_p, ne_64)
    assert not res["ok"] and res["max_err_over_tol"] > 1, res
    nan = [x.clone() for x in ne_p]
    nan[1][row, 0] = float("nan")
    assert not C.compare_normal_equations(nan, ne_p, ne_64)["pattern_equal"]
    # a raised row tolerance admits the same error on that row only
    rtol = np.full(params0.shape[0], C.NE_RTOL)
    rtol[row] = 10 * C.NE_RTOL
    assert C.compare_normal_equations(off, ne_p, ne_64, rtol)["ok"]


def test_line3dpp_row_tolerance_and_singular_witness():
    params0, data = C.seeded_jointloc(seed=2, T=3, device="cpu",
                                      corners=True)
    cfg = C.loc_config("2d_perpendicular_dist2", "line3dpp", "huber", 1, 1)
    # row 0 sees its horizontal line at |cos| = 1 exactly in float32
    c32 = C.line_cosines(data, [0], params0[:1].numpy(), torch.float32)
    assert float(c32[0, -2]) == 1.0
    margins = C.jointloc_singular(data, cfg)(np.arange(3), params0.numpy())
    assert margins[0] <= 1 and margins[-1] == np.inf   # all masked out
    assert C.jointloc_singular(
        data, C.loc_config("2d_perpendicular_dist2", "cosine", "huber", 1,
                           1)) is None
    rtol = C.jointloc_ne_rtol(data, cfg, params0)
    assert rtol[0] > C.NE_RTOL and rtol[-1] == 0
    # its Jacobian is not finite, the solve stalls there
    ne = lm_jointloc.normal_equations(params0, *data, cfg)
    assert not torch.isfinite(ne[0][0]).all()
    res = lm_jointloc.solve(params0, *data, cfg, num_iterations=5)
    assert int(res.n_accepted[0]) == 0
    assert torch.equal(res.params[0], params0[0])


def test_parallel_ray_corner():
    """The optical-axis line's 2D start is the principal point: its ray
    is the line's direction, the cross product vanishes and
    3d_line_line_dist2 takes its parallel branch."""
    params0, data = C.seeded_jointloc(seed=2, T=1, device="cpu",
                                      corners=True)
    l3s, l3e, l2s = data[0][-1], data[1][-1], data[2][-1]
    kv = data[8]
    assert torch.equal(l2s, kv[2:])
    d = l3e - l3s
    assert d[0] == 0 and d[1] == 0
    assert torch.equal(params0[0], torch.tensor([1.0, 0, 0, 0, 0, 0, 0]))


def test_zero_weight_rows_do_not_move(ba):
    params0, aux = ba
    res = lm_line_ba.solve(params0, *aux, LineBAConfig(), num_iterations=5)
    zero = aux[5].sum(1) == 0
    assert zero.any()
    assert torch.equal(res.params[zero], params0[zero])
    assert (res.cost[zero] == 0).all() and (res.n_accepted[zero] == 0).all()


def test_lambdas_replay():
    acc = np.array([[True] * 40, [False] * 40])
    lam = C.lambdas(acc)
    assert lam.dtype == np.float32 and lam[0, 0] == np.float32(1e-3)
    assert lam[0, 1] == np.float32(np.float32(1e-3) * np.float32(0.5))
    assert lam[0, -1] == np.float32(1e-9) and lam[1, -1] == np.float32(1e6)


def test_tie_margin():
    m = C.tie_margin(np.array([1.0, 1.0]), np.array([1.0, 2.0]),
                     np.array([1.0, 1.0]), np.array([1.0 + 1e-9, 2.0]),
                     np.array([10.0, 10.0]))
    assert m[0] == 0 and m[1] > 1


def test_operation_counts():
    a = C.ops_line_ba(100, 10, 20, 120)
    assert C.ops_line_ba(200, 10, 20, 120) > a
    assert C.ops_line_ba(100, 10, 40, 120) - C.ops_line_ba(100, 10, 20, 120) \
        == a - C.ops_line_ba(100, 10, 0, 120)
    per_row = C.ops_line_ba(0, 1, 1, 0)
    assert per_row == 6 * (C.OPS["ba_retract"] + C.OPS["ba_plucker"]) \
        + C.OPS["solve4"]
    assert C.accumulate_ops(4) == 30 and C.accumulate_ops(6) == 56
    cfgs = [C.loc_config(*c) for c in C.JOINTLOC_CONFIGS]
    ops = [C.ops_jointloc(c, 100, 500, 8, 50) for c in cfgs]
    assert all(x > 0 for x in ops)
    # a 3D cost does more work a line than a 2D midpoint
    assert ops[4] > ops[0]
    assert C.bytes_line_ba(10, 4) == 10 * 4 * 68 + 10 * 60
    assert C.bytes_jointloc(1, 2, 3) == 80 + 60 + 5 + 28 + 16 + 40


@pytest.mark.parametrize("which", ["line_ba", "jointloc"])
def test_wrappers_refuse_bad_inputs(which, ba, loc):
    if which == "line_ba":
        params0, aux = ba
        call = lambda p, a: lm_line_ba.solve(p, *a, LineBAConfig(),
                                             num_iterations=1)
        data = list(aux)
        mask = 6
    else:
        params0, data = loc
        data = list(data)
        call = lambda p, a: lm_jointloc.solve(
            p, *a, C.loc_config(*C.JOINTLOC_CONFIGS[0]), num_iterations=1)
        mask = 4
    with pytest.raises(ValueError):
        call(params0.double(), data)
    with pytest.raises(ValueError):
        call(params0[:, :-1], data)
    bad = list(data)
    bad[1] = bad[1].to("meta")
    with pytest.raises(ValueError):
        call(params0, bad)
    bad = list(data)
    bad[mask] = bad[mask].float()        # a mask that is not bool
    with pytest.raises(ValueError):
        call(params0, bad)


# ----------------------------------------------- kernels K, L and M
@pytest.fixture(scope="module")
def refine():
    return C.seeded_refine(seed=7, T=12, S=8, F=4, device="cpu")


@pytest.fixture(scope="module")
def assoc():
    return C.seeded_assoc(seed=8, T=16, S=8, n_points=40, device="cpu")


@pytest.mark.parametrize("which", C.REFINE_CASES)
def test_refine_plain_against_itself(refine, which):
    params0, data = refine
    d, terms = C.refine_case(params0, data, which)
    ne, sol = C.check_refine(params0, d, terms, num_iterations=8,
                             kernels=False)
    assert ne["ok"] and sol["ok"] and sol["parted"] == 0, (ne, sol)
    assert sol["accepted"] > 0


def test_refine_rounding_partings_are_witnessed(refine):
    """A start one ulp away stands for a kernel that rounds otherwise:
    rows part or walk apart, each witnessed (at texel edges the corner
    witness, and its first costs are not compared there)."""
    from limap_tpu_torch.ops import lm_line_refine as K
    params0, data = refine
    d, terms = C.refine_case(params0, data, "all")
    out = _solve_pair(one_ulp_up(params0), params0, K.plain_aux(d),
                      K.refine_residual(terms), lm.retract_quat_so2, 4, 12)
    problem = C.RowProblem(K.refine_residual(terms), lm.retract_quat_so2, 4,
                           K.plain_aux(d), K.SHARED)
    R = K.refine_residual(terms)(params0, *K.plain_aux(d)).shape[1]
    res = C.compare_solve(*out, problem, R, rules=C.Rules(
        corner=C.ResidualCorners(d, terms, params0)))
    assert res["ok"], res


def test_refine_refuses_a_fault(refine):
    """A kernel whose heatmap term is off by a few percent is refused, and
    so is each planted fault through ``check_refine`` itself, with its
    corner rules (on the CPU the wrappers run plain on the faulty
    input)."""
    from limap_tpu_torch.ops import lm_line_refine as K
    params0, data = refine
    d, terms = C.refine_case(params0, data, "heatmap")
    bad = d._replace(hm_patch=d.hm_patch * 1.05)
    ne_k = K.normal_equations_plain(params0, bad, terms)
    ne_p = K.normal_equations_plain(params0, d, terms)
    d64 = K.RefineData(*(x.double() if x.is_floating_point() else x
                         for x in d))
    ne_64 = K.normal_equations_plain(params0.double(), d64, terms)
    assert not C.compare_normal_equations(ne_k, ne_p, ne_64)["ok"]
    d, terms = C.refine_case(params0, data, "all")
    ne, sol = C.check_refine(params0, d, terms, 8)
    assert ne["ok"] and sol["ok"], (ne, sol)
    controls = ne["fault_controls"]
    assert list(controls) == list(C.REFINE_FAULTS)
    assert all(c["refused"] for c in controls.values()), controls


def test_assoc_plain_against_itself_and_faults(assoc):
    from limap_tpu_torch.ops import lm_assoc as LA
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    lp, ldata, pp, pdata = assoc
    for use_vps in (True, False):
        ne, sol = C.check_assoc_lines(lp, ldata, AssocTerms(use_vps=use_vps),
                                      kernels=False)
        assert ne["ok"] and sol["ok"] and sol["parted"] == 0, (ne, sol)
    ne, sol = C.check_assoc_points(pp, pdata, AssocTerms(), kernels=False)
    assert ne["ok"] and sol["ok"] and sol["parted"] == 0, (ne, sol)
    # a point step that drops the reprojection's weight is refused
    terms = AssocTerms()
    bad = LA.normal_equations_points_plain(
        pp, pdata, AssocTerms(lw_point=0.12))
    ne_p = LA.normal_equations_points_plain(pp, pdata, terms)
    d64 = type(pdata)(*(x.double() if x.is_floating_point() else x
                        for x in pdata))
    ne_64 = LA.normal_equations_points_plain(pp.double(), d64, terms)
    assert not C.compare_normal_equations(bad, ne_p, ne_64)["ok"]


def test_assoc_corner_is_found(assoc):
    """The seeded VP 0 is its track's direction exactly, as the host VP
    step leaves a VP with a single member line: that row is a corner, and
    the sine's Jacobian row there is rounding noise."""
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    lp, ldata, _, _ = assoc
    m = C.assoc_corner_lines(ldata, AssocTerms())(np.arange(16),
                                                  lp.numpy())
    assert m[0] <= 1 and (m[1:] > 1).sum() >= 12


def test_klm_operation_counts():
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    params0, data = C.seeded_refine(seed=7, T=4, S=5, F=2, device="cpu")
    d, terms = C.refine_case(params0, data, "all")
    counts = C.refine_counts(d, terms)
    assert counts["anchors"] == counts["geometric"] * 16
    base = C.ops_line_refine(dict(counts, vp=0, anchors=0, fconsis_terms=0),
                             4, 10)
    assert C.ops_line_refine(counts, 4, 10) > base > 0
    lp, ldata, pp, pdata = C.seeded_assoc(seed=8, T=8, S=5, n_points=10,
                                          device="cpu")
    lc = C.assoc_line_counts(ldata, AssocTerms())
    assert lc["vp_slots"] > 0 and lc["point_slots"] > 0
    assert C.ops_assoc_lines(lc, 8, 10) > C.ops_assoc_lines(
        dict(lc, vp_slots=0), 8, 10)
    pc = C.assoc_point_counts(pdata)
    assert C.ops_assoc_points(pc, 10, 10) > 0
    # bytes: only weighted items and the texels sampled at params0, well
    # under every slot of every input; the heatmap and feature texels add
    full = lambda x: sum(t.numel() * t.element_size() for t in x)
    nk = C.bytes_line_refine(params0, d, terms)
    geo = C.bytes_line_refine(params0, d, C.refine_terms("geometric"))
    assert full(d) > nk > geo > 0
    assert 0 < C.bytes_assoc_lines(ldata, AssocTerms(use_vps=False)) \
        < C.bytes_assoc_lines(ldata, AssocTerms()) < full(ldata)
    assert 0 < C.bytes_assoc_points(pdata) < full(pdata)
