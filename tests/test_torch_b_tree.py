"""Kernel B's Hopper design replayed in torch on the CPU
(limap_tpu_torch/testing/replays.py): the roots' cells by warp votes and
arg-min butterflies against the first design's serial scans, the roots'
steps walked as the kernel's trees against the first design's serial
loops, bit for bit, and the whole root finder against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limap_tpu.estimators.pnl_solvers as jpnl
import limap_tpu_torch.estimators.pnl_solvers as tpnl
from limap_tpu_torch.ops.trace_roots import (alpha_grid, family_eval, plan,
                                             trace_roots_plain)
from limap_tpu_torch.testing import kernel_checks as kc
from limap_tpu_torch.testing import replays
from tests.test_torch_localization_solvers import _solver_inputs
from torch_threads import two_torch_threads  # noqa: F401


def _grid_G(G):
    return torch.as_tensor(np.asarray(G, np.float32))


def _stable_cells(G, n_roots):
    """trace_roots_plain's selection (stable argsorts), for the same G."""
    sc = G[:, :-1] * G[:, 1:] < 0.0
    idx = torch.argsort((~sc).to(torch.int8), dim=1, stable=True)[:, :n_roots]
    idx = torch.where(torch.gather(sc, 1, idx), idx, torch.zeros_like(idx))
    absG = torch.abs(G)
    ext = (absG[:, 1:-1] <= absG[:, :-2]) & (absG[:, 1:-1] <= absG[:, 2:])
    cand = torch.where(ext, absG[:, 1:-1], torch.full_like(absG[:, 1:-1],
                                                           float("inf")))
    eidx = torch.argsort(cand, dim=1, stable=True)[:, :n_roots]
    return idx, torch.gather(sc, 1, idx), eidx, torch.gather(ext, 1, eidx)


def edge_case(kind, rng, n_grid=256):
    """G on a grid of n_grid intervals with one edge of the selection."""
    x = np.linspace(-np.pi, np.pi, n_grid + 1)
    if kind == "no sign change":
        G = 1.5 + np.cos(3 * x)
    elif kind == "fewer sign changes than roots":
        G = np.cos(x) - 0.2
    elif kind == "nan in G":
        G = np.sin(5 * x)
        G[rng.choice(n_grid + 1, 12, replace=False)] = np.nan
    elif kind == "fewer minima than roots":
        G = x + 4.0                       # monotonic: no interior minimum
    elif kind == "ties in |G|":
        G = np.round(np.abs(np.sin(6 * x)), 1) + 0.05
    else:
        G = rng.normal(size=n_grid + 1)
    return np.stack([G, -G, G * 2.0 ** -20])


EDGE_CASES = ("no sign change", "fewer sign changes than roots", "nan in G",
              "fewer minima than roots", "ties in |G|", "random")


@pytest.mark.parametrize("n_roots", [1, 4, 8])
@pytest.mark.parametrize("kind", EDGE_CASES)
def test_cells_by_votes_are_the_serial_scans(kind, n_roots):
    """Sign changes by ballots and minima by butterflies pick the first
    design's cells and flags (its serial scans) and the plain version's
    (stable argsorts), the index-0 filler with cell 0's flag included."""
    G = _grid_G(edge_case(kind, np.random.default_rng(7)))
    cells, flags = replays.sign_change_cells(G, n_roots)
    mcells, ext = replays.minima_cells(G, n_roots)
    s_cells, s_flags, s_mcells, s_ext = replays.serial_cells(G.numpy(),
                                                             n_roots)
    assert torch.equal(cells, s_cells) and torch.equal(flags, s_flags)
    assert torch.equal(mcells, s_mcells) and torch.equal(ext, s_ext)
    p_cells, p_flags, p_mcells, p_ext = _stable_cells(G, n_roots)
    assert torch.equal(cells, p_cells) and torch.equal(flags, p_flags)
    assert torch.equal(mcells, p_mcells) and torch.equal(ext, p_ext)
    if kind == "no sign change":
        assert not flags.any() and not cells.any()
    if kind == "fewer minima than roots":
        assert not ext.any()
        assert torch.equal(mcells[0], torch.arange(n_roots))


PLANS = {"planned": None, "one level": "one", "deep first": "deep"}


def deep_plan(n_roots, n_bisect):
    """The double roots alone as deep as fits, then the simple ones."""
    def deepest(w):
        return max(d for d in range(1, 6)
                   if n_roots * w * ((1 << d) - 1) <= 32)
    dd, ds = deepest(2), deepest(1)
    return [(0, dd, -(-n_bisect // dd)), (ds, 0, -(-n_bisect // ds))]


@pytest.mark.parametrize("which", list(PLANS))
@pytest.mark.parametrize("n_roots", [3, 4, 8])
@pytest.mark.parametrize("seed,degenerate", kc.SEEDS)
def test_tree_walk_is_the_serial_loops_bit_for_bit(seed, degenerate,
                                                   n_roots, which):
    """The trees of a plan against the first design's loops on seeded
    instances (a third rank-deficient under ``degenerate``): every root
    bit for bit, so the rotations and flags too; both equal the plain
    version's."""
    args = [torch.as_tensor(x) for x in
            kc.trace_roots_inputs(seed, B=40, degenerate=degenerate)]
    grid = torch.as_tensor(alpha_grid(256))
    phases = {None: None, "one": [(1, 1, 48)],
              "deep": deep_plan(n_roots, 48)}[PLANS[which]]
    R, ok, roots = replays.trace_roots_replay(*args, grid, 48, n_roots,
                                              phases)
    Rs, oks, roots_s = replays.trace_roots_replay(*args, grid, 48, n_roots,
                                                  serial=True)
    assert torch.equal(roots.view(torch.int32), roots_s.view(torch.int32))
    assert torch.equal(R, Rs) and torch.equal(ok, oks)
    Rp, okp = trace_roots_plain(*args, grid, 48, n_roots)
    assert torch.equal(ok, okp)
    assert float((R - Rp).abs().max()) <= 1e-6
    if degenerate:
        assert kc.rank_deficient(*args, grid).sum() > 0


def test_plan_fits_a_warp_and_takes_every_step():
    for n_roots in range(1, 9):
        for n_bisect in (0, 1, 3, 48):
            phases = plan(n_roots, n_bisect)
            assert 1 <= len(phases) <= 2
            done = [0, 0]
            for ds, dd, rounds in phases:
                assert n_roots * ((1 << ds) - 1 + 2 * ((1 << dd) - 1)) <= 32
                done[0] += min(n_bisect - done[0], ds * rounds)
                done[1] += min(n_bisect - done[1], dd * rounds)
            assert done == [n_bisect, n_bisect], (n_roots, n_bisect, phases)
    assert plan(4, 48) == ((1, 2, 24), (3, 0, 8))
    assert plan(8, 48) == ((1, 1, 48),)
    assert plan(4, 48) is plan(4, 48)                # built once a shape


@pytest.mark.parametrize("kind,n_roots", [("p3ll", 4), ("p1p2ll", 4),
                                          ("p2p1ll", 4), ("p3ll", 8)])
def test_tree_replay_matches_jax(monkeypatch, kind, n_roots):
    """The point-line solvers with the replay in place of the root finder
    against the JAX package's, on test_torch_localization_solvers.py's
    inputs and with its tolerance (flags equal; a bisected root's
    rotation within 1e-4, a double root's within 2e-3, at most 5 % of
    those beyond 1e-4)."""
    calls = []

    def replay(*a):
        calls.append(a[0].shape[0])
        return replays.trace_roots_replay(*a)[:2]

    monkeypatch.setattr(tpnl, "trace_roots", replay)
    inputs = _solver_inputs(kind, 48, seed={"p3ll": 0, "p1p2ll": 1,
                                            "p2p1ll": 2}[kind])
    Rj, _, okj = (np.asarray(x) for x in getattr(jpnl, kind)(
        *(jnp.asarray(np.asarray(x, np.float32)) for x in inputs),
        n_roots=n_roots))
    Rt, _, okt = (x.numpy() for x in getattr(tpnl, kind)(
        *(torch.as_tensor(np.asarray(x, np.float32)) for x in inputs),
        n_roots=n_roots))
    assert calls and np.array_equal(okj, okt) and okj.sum() > 48
    double = (np.arange(okj.shape[1]) % (2 * n_roots) >= n_roots)[None]
    err = np.abs(Rj - Rt).max((-1, -2))
    assert err[okj & ~double].max() <= 1e-4
    assert err[okj & double].max() <= 2e-3
    assert (err[okj & double] > 1e-4).sum() <= 0.05 * (okj & double).sum()


def test_lane_evaluation_is_the_grid_evaluation():
    """G of a lane at alpha equals G of the grid at the same alpha, the
    ground the bit-for-bit holds stand on."""
    args = [torch.as_tensor(x) for x in kc.trace_roots_inputs(4, B=8)]
    grid = torch.as_tensor(alpha_grid(256))
    data = [a[:, None] for a in args]
    G = family_eval(grid.expand(8, -1), *data)[0]
    lanes = replays.lane_eval(*args)(grid[:32].expand(8, -1).contiguous())
    assert torch.equal(lanes, G[:, :32])
