"""Kernel I's Hopper design replayed in torch on the CPU
(limap_tpu_torch/testing/replays.py): the compaction of a chain's active
matches over a team (csrc/lm_jointloc.cu lays them out so), and the
fused loop (one pass an iteration at the trial parameters, the normal
equations kept on a rejected step) on each chain's compacted matches,
held to lm_solve bit for bit and to the JAX package's solve."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.optimize import hybrid_localization as jhl
from limap_tpu_torch.ops import lm_jointloc as I
from limap_tpu_torch.optimize import hybrid_localization as thl
from limap_tpu_torch.testing import lm_checks, replays
from tests.test_localization import make_problem
from torch_threads import two_torch_threads  # noqa: F401

MASKS = ("nothing", "only lines", "only points", "every match", "random")


@pytest.fixture(autouse=True)
def one_thread():
    """lm_solve's sums in one order: the bit-for-bit holds need it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masks_of(kind, nl, npt, rng):
    lmask, pmask = np.ones(nl, bool), np.ones(npt, bool)
    if kind == "nothing":
        lmask[:], pmask[:] = False, False
    elif kind == "only lines":
        pmask[:] = False
    elif kind == "only points":
        lmask[:] = False
    elif kind == "random":
        lmask, pmask = rng.random(nl) < 0.6, rng.random(npt) < 0.6
    return lmask, pmask


@pytest.mark.parametrize("order", [I.OWNER, I.BALANCED])
@pytest.mark.parametrize("kind", MASKS)
def test_team_items_are_the_active_matches_in_the_kernels_order(kind,
                                                                order):
    rng = np.random.default_rng(3)
    nl, npt = 70, 300
    lmask, pmask = masks_of(kind, nl, npt, rng)
    active = list(np.flatnonzero(lmask)) + list(nl + np.flatnonzero(pmask))
    for S in (32, 64, 256):
        items = replays.team_items(lmask, pmask, S, order)
        assert sorted(i for t in items for i in t) == active
        for t, mine in enumerate(items):
            assert mine == sorted(mine)      # lines, then points, ascending
            if order == I.OWNER:             # the first design's, unmasked
                assert mine == [i for i in range(t, nl + npt, S)
                                if i in set(active)]
        if order == I.OWNER:
            continue
        nla, npa = int(lmask.sum()), int(pmask.sum())
        sl = 32 * replays.line_warps(nla, npa, S, 3)
        if sl:                               # lines and points apart
            lines = [len([i for i in t if i < nl]) for t in items]
            points = [len([i for i in t if i >= nl]) for t in items]
            assert not any(lines[sl:]) and not any(points[:sl])
            assert max(lines[:sl]) - min(lines[:sl]) <= 1
            assert max(points[sl:]) - min(points[sl:]) <= 1
        else:                                # dealt round robin
            assert [len(t) for t in items] == [
                len(range(t, len(active), S)) for t in range(S)]


def test_lines_take_warps_of_their_own_where_that_is_cheaper():
    """Phase 8's typical chain (42 lines, 700 points, 256 threads, a line
    3 points' cost): 2 warps of lines (1 a lane, cost 3) and 6 of points
    (at most 4 a lane), against 6 for both dealt over the team."""
    assert replays.line_warps(42, 700, 256, 3) == 2
    assert replays.line_warps(21, 42, 256, 3) == 1
    assert replays.line_warps(0, 700, 256, 3) == 0
    assert replays.line_warps(42, 0, 256, 3) == 0
    assert replays.line_warps(42, 700, 32, 3) == 0   # one warp: no split


def seeded_rows(seed=2):
    """seeded_jointloc's problem with one chain a kind of mask."""
    params0, data = lm_checks.seeded_jointloc(seed=seed, T=len(MASKS),
                                              device="cpu")
    rng = np.random.default_rng(seed)
    nl, npt = data[0].shape[0], data[5].shape[0]
    lm_, pm_ = zip(*(masks_of(k, nl, npt, rng) for k in MASKS))
    data = list(data)
    data[4], data[7] = torch.as_tensor(np.stack(lm_)), \
        torch.as_tensor(np.stack(pm_))
    return params0, tuple(data)


@pytest.mark.parametrize("config", lm_checks.JOINTLOC_CONFIGS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_fused_loop_is_lm_solve_bit_for_bit(config):
    """Each chain's fused loop on its compacted matches against lm_solve
    on the same matches (on its masked matches where it keeps none):
    every trace row, params, costs and accepts bit for bit; rejected
    steps among them, so the kept normal equations are exercised."""
    params0, data = seeded_rows()
    cfg = lm_checks.loc_config(*config)
    n_iter = 12
    rows = []
    res = replays.fused_solve(params0, data, cfg, n_iter, rows)
    rejected = 0
    for r in range(params0.shape[0]):
        d = replays.compact_row(data, r)
        if not (d[0].shape[0] or d[5].shape[0]):
            d = tuple(x[r:r + 1] if k in (4, 7) else x
                      for k, x in enumerate(data))
        rows_p = []
        ref = I.solve_plain(params0[r:r + 1], d, cfg, n_iter, rows_p)
        for a, b in zip(res, ref):
            assert torch.equal(a[r:r + 1], b), (MASKS[r], a[r], b)
        for a, b in zip(rows, rows_p):
            assert torch.equal(a[r:r + 1], b), MASKS[r]
        rejected += sum(int(x[0, 1] >= x[0, 0]) for x in rows_p)
    assert rejected > 0
    # the chain that keeps nothing stays where it started, at cost 0
    assert torch.equal(res.params[0], params0[0])
    assert float(res.cost[0]) == 0.0 and int(res.n_accepted[0]) == 0


@pytest.mark.parametrize("cost", thl.COST_FUNCTIONS)
def test_fused_loop_matches_jax(cost):
    """The fused loop on the compacted matches against the JAX package's
    solve on the masked matches, for each kind of mask: the tolerance of
    test_torch_localization_optimize.py's joint solve."""
    rng = np.random.default_rng(1)
    camera, pose_gt, p3ds, p2ds, l3ds, _, l2ds = make_problem(
        rng, outlier_ratio=0.0, noise=0.2)
    dq = Rotation.from_rotvec(rng.normal(size=3) * 0.02).as_matrix()
    pose0 = JPose(R=dq @ pose_gt.R(), tvec=pose_gt.tvec + 0.05)
    args = (l3ds[:, 0], l3ds[:, 1], l2ds[:, 0], l2ds[:, 1], p3ds, p2ds,
            camera.kvec(), pose0.qvec, pose0.tvec)
    loss = ("trivial", "cauchy", "huber")[thl.COST_FUNCTIONS.index(cost) % 3]
    cfg = dict(loss=loss, loss_scale=2.0, cost_function=cost,
               cost_function_weight="none")

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt)

    for kind in MASKS:
        lmask, pmask = masks_of(kind, len(l3ds), len(p3ds), rng)
        qj, tj, cj = jhl.solve_jointloc(*args, jhl.LineLocConfig(**cfg),
                                        line_mask=lmask, point_mask=pmask)
        data = (t(args[0]), t(args[1]), t(args[2]), t(args[3]),
                t(lmask[None], torch.bool), t(args[4]), t(args[5]),
                t(pmask[None], torch.bool), t(args[6]))
        params0 = thl.pack_pose(pose0.qvec, pose0.tvec)[None]
        res = replays.fused_solve(params0, data, thl.LineLocConfig(**cfg))
        q, tv, c = res.params[0, :4].numpy(), res.params[0, 4:].numpy(), \
            float(res.cost[0])
        np.testing.assert_allclose(q, qj, rtol=1e-4, atol=1e-5, err_msg=kind)
        np.testing.assert_allclose(tv, tj, rtol=1e-4,
                                   atol=1e-4 * np.abs(tj).max(),
                                   err_msg=kind)
        assert abs(c - cj) <= 1e-3 * max(cj, 1.0), (kind, c, cj)


def test_team_is_chosen_from_the_most_active_chain():
    """A warp while it holds 4 active matches a lane, else 4 warps while
    they hold 2 a lane, else 8 (never 2: they would take what one warp
    takes); the data staged while it fits in a block's shared memory,
    else the indices there, else the indices in a global scratch."""
    assert I.team_for(10, 100)["warps"] == 1
    assert I.team_for(28, 100)["warps"] == 1         # 128: 4 a lane
    assert I.team_for(29, 100)["warps"] == 4         # 2 warps would hold 4
    assert I.team_for(100, 156)["warps"] == 4        # 256: 2 a lane
    assert I.team_for(100, 157)["warps"] == 8
    assert I.team_for(100, 412)["warps"] == 8
    assert sorted({I.chain_team(n) for n in range(2000)}) == [1, 4, 8]
    assert I.team_for(164, 1000)["staged"]
    wide = I.team_for(2000, 12000)
    assert wide["matches_in"] == "indices in shared memory"
    assert not wide["staged"] and wide["warps"] == I.MAX_WARPS
    assert wide["smem_bytes"] <= I.SMEM_MAX
    huge = I.team_for(30000, 30000)
    assert huge["matches_in"] == "indices in global memory"
    assert huge["smem_bytes"] == 4 * (I.MAX_WARPS * I.NS + 2 * I.MAX_WARPS)
    assert I.team_for(5, 5, warps=8)["warps"] == 8
    with pytest.raises(ValueError):
        I.team_for(5, 5, warps=3)
    lmask = torch.zeros((3, 100), dtype=torch.bool)
    pmask = torch.zeros((3, 1000), dtype=torch.bool)
    lmask[1, :7], pmask[2, :600], lmask[2, :40] = True, True, True
    assert I.team_for(100, 1000)["warps"] == 8       # the block: the shapes'
    assert I.chain_warps(lmask, pmask) == [1, 1, 8]  # each chain its own
    assert I.chain_warps(lmask[:, :10], pmask[:, :100]) == [1, 1, 1]
