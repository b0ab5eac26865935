"""The checks that hold kernels O, P and Q to their plain versions
(limap_tpu_torch/testing/hybrid_checks.py), run on the CPU with the plain
versions standing in for the kernels: they pass the plain version, read
the slots of weight 0 as 0 whatever the kernel leaves there, refuse a
planted fault, and count the bytes of the weighted slots only.  Imports
no JAX."""

import pytest
import torch

from limap_tpu_torch.ops import hybrid_ba as O
from limap_tpu_torch.parallel.sharded_ba import HybridBAOptions
from limap_tpu_torch.testing import hybrid_checks as HC
from torch_threads import two_torch_threads  # noqa: F401

CASES = [c[0] for c in HC.cases()]


def _problem(case):
    i, (_, prob, okw) = next((i, c) for i, c in enumerate(HC.cases())
                             if c[0] == case)
    state, ld, pd, I, C = HC.seeded_problem(seed=10 + i, device="cpu",
                                            **prob)
    return state, ld, pd, I, C, HybridBAOptions(**okw)


def _check(kind, case, terms=O.hybrid_terms_plain):
    state, ld, pd, I, C, opts = _problem(case)
    data = ld if kind == "line" else pd
    res, _ = HC.check_terms(kind, state, data, opts, opts.damping, I, C,
                            opts.solver != "cg", terms, O.hybrid_apply_plain)
    return res


@pytest.mark.parametrize("case", CASES)
def test_checks_pass_the_plain_version(case):
    # the plain version's dense matrix is not bit-repeatable on the CPU
    # (its scatters), so the repeat test is left to the card
    for kind in ("line", "point"):
        res = _check(kind, case)
        assert "failed" not in res, (kind, res)
        assert set(HC.OWN_TERMS + HC.ELIMINATED[:-1]) <= set(res)
        assert "g_c" in res
    state, ld, pd, _, _, opts = _problem(case)
    assert HC.check_cost(state, ld, pd, opts, O.hybrid_cost_plain)["ok"]


def _planted(fault):
    def terms(*args):
        t = O.hybrid_terms_plain(*args)
        w = t.weight > 0
        if fault == "unwritten":
            return t._replace(**{
                n: torch.where(w.reshape(w.shape + (1,) * (
                    getattr(t, n).dim() - 2)), getattr(t, n), float("nan"))
                for n in HC.PER_SUPPORT})
        tt, ss = map(int, torch.nonzero(w)[len(torch.nonzero(w)) // 2])
        name = {"H_cl": "H_cl", "g_c": "g_red"}[fault]
        x = getattr(t, name).clone()
        x[tt, ss] = x[tt, ss] * 1.01 + 1e-3 * x.abs().max()
        return t._replace(**{name: x})
    return terms


def test_checks_read_unweighted_slots_as_zero():
    for kind in ("line", "point"):
        res = _check(kind, "huber, ragged S 40", _planted("unwritten"))
        assert "failed" not in res, (kind, res)


@pytest.mark.parametrize("fault", ["H_cl", "g_c"])
def test_checks_refuse_a_planted_fault(fault):
    for kind in ("line", "point"):
        res = _check(kind, "dense", _planted(fault))
        assert fault in res.get("failed", []), (kind, res)


def test_byte_counts_take_the_weighted_slots():
    """Every slot's weight, then only what a weighted slot names: two
    tracks of three slots, two weighted, on images 0 and 1 of camera 0."""
    weight = torch.tensor([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0]])
    img = torch.tensor([[0, 1, 1], [2, 2, 2]])
    cam = torch.zeros_like(img)
    L, Dc, D = 3, 6, 18
    _, nbytes = HC.terms_work("point", weight, img, cam, L, Dc, D, True,
                              3, 2)
    inputs = 6 + 2 * (2 + 1 + 1 + 2) + 1 * 3 + 2 * 7 + 1 * 2
    outputs = 2 * L * L + 2 * L + 2 * Dc * (L + Dc) + 1 + 2 * D + D * D
    assert nbytes == 4 * (inputs + outputs)
    _, nbytes = HC.apply_work(weight, img, cam, L, Dc, D, backsub=False)
    assert nbytes == 4 * (6 + 2 * (1 + Dc * L) + L * L + D
                          + 2 * Dc * Dc + D)
    _, nbytes = HC.apply_work(weight, img, cam, L, Dc, D, backsub=True)
    assert nbytes == 4 * (6 + 2 * (1 + Dc * L) + L * L + D + L + 2 * L)
    _, nbytes = HC.cost_work({"point": (weight, img, cam, 3, 2),
                              "line": (weight[:1], img[:1] + 1, cam[:1],
                                       6, 4)})
    assert nbytes == 4 * (1 + 6 + 2 * 6 + 3 + 3 + 2 * 8 + 6
                          + 7 * 3 + 2)
