"""Kernel O's pair lists (ops/hybrid_ba.py build_index), on the CPU: they
enumerate exactly the (s, u) pairs that the first design's stage 2 met,
block by block and in its order (held to a brute-force walk with focal
groups, weights of 0, empty tracks and a track that sees an image
twice); the reduced system assembled from them in float64 (the torch
replay of the kernel's stage 2) equals the plain version's; and
``hybrid_terms`` given a prebuilt index equals ``hybrid_terms`` without
one.  Imports no JAX."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import hybrid_ba as O
from limap_tpu_torch.parallel.sharded_ba import HybridBAOptions
from limap_tpu_torch.testing import hybrid_checks as HC
from torch_threads import two_torch_threads  # noqa: F401


def _supports(seed, T=9, S=7, I=5, C=2, long_track=False):
    """img, cam [T, S] int32 and weight [T, S]: ragged weights of 0, an
    empty track, a track seeing image 1 in two slots and (with
    ``long_track``) four tracks of 100 supports on two images, so that a
    block holds more than one chunk of shares of pairs."""
    rng = np.random.default_rng(seed)
    if long_track:
        S = 100
    img = rng.integers(0, I, (T, S))
    cam_of = rng.integers(0, C, I)
    w = rng.uniform(0.5, 2.0, (T, S))
    w[rng.random((T, S)) < 0.3] = 0.0
    w[2] = 0.0                               # an empty track
    img[3, 1] = img[3, 4] = 1                # one image seen twice
    w[3, 1] = w[3, 4] = 1.0
    if long_track:
        img[:4] = rng.integers(0, 2, (4, S))
        w[:4] = 1.0
    t = lambda a: torch.as_tensor(a)
    return (t(img.astype(np.int32)), t(cam_of[img].astype(np.int32)),
            t(w.astype(np.float32)), I, C)


def _walk(img, cam, w, I, C, focal, dense):
    """The first design's stage 2, pair by pair: for each block (g, h)
    (row-major; the diagonal alone without ``dense``) each weighted
    support s of group g in track-major order, then each weighted u of
    its track in group h by slot (u = s alone without ``dense``)."""
    T, S = img.shape
    G = I + (C if focal else 0)

    # each track's weighted slots with their groups, in slot order
    slots = [[(s, {int(img[t, s])} | ({I + int(cam[t, s])} if focal
                                      else set()))
              for s in range(S) if w[t, s] > 0] for t in range(T)]
    blocks = ([(g, h) for g in range(G) for h in range(G)] if dense
              else [(g, g) for g in range(G)])
    out = []
    for g, h in blocks:
        pairs = []
        for t in range(T):
            us = [u for u, gu in slots[t] if h in gu]
            for s, gs in slots[t]:
                if g in gs:
                    pairs += [(t * S + s, t * S + u)
                              for u in (us if dense else [s])]
        out.append(pairs)
    return out


CASES = [(seed, focal, dense, long_track)
         for seed, long_track in ((0, False), (1, True))
         for focal in (False, True) for dense in (True, False)]


@pytest.mark.parametrize("seed,focal,dense,long_track", CASES)
def test_pairs_are_the_first_designs_walk(seed, focal, dense, long_track):
    img, cam, w, I, C = _supports(seed, long_track=long_track)
    ix = O.build_index(img, cam, w, I, C, focal, dense)
    walk = _walk(img, cam, w, I, C, focal, dense)
    ptr = ix.pair_ptr.tolist()
    assert len(ptr) == len(walk) + 1
    for b, pairs in enumerate(walk):
        got = list(zip(ix.pair_s[ptr[b]:ptr[b + 1]].tolist(),
                       ix.pair_u[ptr[b]:ptr[b + 1]].tolist()))
        assert got == pairs, b
    # each block's pairs cut into shares of SHARE consecutive pairs, or
    # one share a block without the dense matrix
    n = np.diff(ptr)
    size = O.SHARE if dense else max(1, n.max())
    n_sh = (n + size - 1) // size
    assert np.diff(ix.share_ptr.tolist()).tolist() == n_sh.tolist()
    assert ix.share_block.tolist() == np.repeat(np.arange(len(n)),
                                                n_sh).tolist()
    first = [p for b in range(len(n))
             for p in range(ptr[b], ptr[b + 1], size)] + [ptr[-1]]
    assert ix.share_first.tolist() == first
    # and each block's shares into chunks of CHUNK consecutive shares
    n_ch = (n_sh + O.CHUNK - 1) // O.CHUNK
    assert np.diff(ix.chunk_ptr.tolist()).tolist() == n_ch.tolist()
    assert ix.chunk_block.tolist() == np.repeat(np.arange(len(n)),
                                                n_ch).tolist()
    if long_track and dense:
        assert n_sh.max() > O.CHUNK
    assert ix.dense == dense


@pytest.mark.parametrize("case", [c[0] for c in HC.cases()])
@pytest.mark.parametrize("kind", ["line", "point"])
def test_float64_assembly_from_the_pairs_is_the_plain_system(case, kind):
    i, (_, prob, okw) = next((i, c) for i, c in enumerate(HC.cases())
                             if c[0] == case)
    state, ld, pd, I, C = HC.seeded_problem(seed=10 + i, device="cpu",
                                            **prob)
    opts = HybridBAOptions(**okw)
    dense = opts.solver != "cg"
    data = tuple(x.double() if x.is_floating_point() else x
                 for x in (ld if kind == "line" else pd))
    land = (state.line_params if kind == "line"
            else state.point_params).double()
    obs = data[3:-1]
    terms = O.hybrid_terms_plain(
        kind, land, state.pose_params.double(), state.cam_fxfy.double(),
        *data[:3], obs, data[-1], opts, torch.tensor(opts.damping,
                                                     dtype=torch.float64),
        I, C, dense)
    ix = O.build_index(data[2], data[1], data[-1], I, C, opts.optimize_focal,
                       dense)
    g, diag0, Hp = O.assemble_from_pairs(terms, ix)
    for got, want in ((g, terms.g), (diag0, terms.diag0), (Hp, terms.Hp)):
        if want is None:
            assert got is None
            continue
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dense", [True, False])
def test_hybrid_terms_with_a_prebuilt_index_is_without_one(dense):
    state, ld, pd, I, C = HC.seeded_problem(seed=5, device="cpu")
    opts = HybridBAOptions(optimize_focal=True)
    lam = torch.tensor(opts.damping)
    for kind, data in (("line", ld), ("point", pd)):
        land = state.line_params if kind == "line" else state.point_params
        args = (kind, land, state.pose_params, state.cam_fxfy, *data[:3],
                tuple(data[3:-1]), data[-1], opts, lam, I, C, dense)
        ix = O.build_index(data[2], data[1], data[-1], I, C, True, dense)
        a, b = O.hybrid_terms(*args), O.hybrid_terms(*args, index=ix)
        for name in ("Hinv", "b_l", "H_cl", "H_cc", "cost", "H_ll", "A",
                     "g_red"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        # the plain version scatters g, diag0 and the matrix with
        # accumulating index ops, whose order varies between threads on
        # the CPU: equal up to that order's rounding
        assert (a.Hp is None) == (not dense)
        for name in ("g", "diag0") + (("Hp",) if dense else ()):
            x, y = getattr(a, name), getattr(b, name)
            torch.testing.assert_close(
                x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()))
        # an index built for the other path, or other supports, is refused
        with pytest.raises(ValueError):
            O.hybrid_terms(*args, index=O.build_index(
                data[2], data[1], data[-1], I, C, True, not dense))
        with pytest.raises(ValueError):
            O.hybrid_terms(*args, index=O.build_index(
                data[2][:, :-1], data[1][:, :-1], data[-1][:, :-1], I, C,
                True, dense))


def test_the_step_builds_its_index_once_a_solve_on_the_card_only():
    """The step's index builder gives None on the CPU (the plain version
    reads none), and the step takes ``index=None`` as before."""
    from limap_tpu_torch.parallel import make_hybrid_ba_step
    state, ld, pd, I, C = HC.seeded_problem(seed=6, device="cpu")
    step = make_hybrid_ba_step(None, I, C, HybridBAOptions(), device="cpu")
    assert step.index(ld, pd) is None
    # (the float32 step is ill-conditioned and the CPU's scatters sum in
    # a thread-dependent order, so two steps agree only on the cost)
    a, ca = step(state, ld, pd)
    b, cb = step(state, ld, pd, index=None)
    assert torch.equal(ca, cb)
    assert all(torch.isfinite(x).all() for x in (*a, *b))


@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_grouping_index_is_the_grouping_alone(focal, dense):
    """What the first design's path built on every call: the grouping of
    the full index, and no pair lists."""
    img, cam, w, I, C = _supports(4)
    full = O.build_index(img, cam, w, I, C, focal, dense)
    alone = O.grouping_index(img, cam, w, I, C, focal, dense)
    for name in ("grp_ptr", "inc", "sorted_img", "sorted_pos"):
        assert torch.equal(getattr(alone, name), getattr(full, name)), name
    for name in ("pair_ptr", "pair_s", "pair_u", "share_ptr", "share_block",
                 "chunk_ptr", "chunk_block", "share_first"):
        t = getattr(alone, name)
        assert t.dtype == torch.int32 and t.numel() == 0, name
    assert alone.dense == dense
    # the yardstick's check takes it; O's, which walks the pairs, does not
    O.check_index(alone, *img.shape, I, C, focal, dense, img.device,
                  grouping_only=True)
    O.check_index(full, *img.shape, I, C, focal, dense, img.device,
                  grouping_only=True)
    with pytest.raises(ValueError, match="pair_ptr"):
        O.check_index(alone, *img.shape, I, C, focal, dense, img.device)


@pytest.mark.parametrize("share", [1, 3, 50])
@pytest.mark.parametrize("dense", [True, False])
def test_float64_sums_in_shares_of_any_size_are_the_plain_system(share,
                                                                  dense):
    """``summed_in_shares`` (the card's order with the share size free,
    for the multi-rank witness): g, diag0 and the matrix within 1e-9 of
    the plain float64 system, the other terms the plain version's own,
    and ``hybrid_terms`` restored afterwards."""
    state, ld, pd, I, C = HC.seeded_problem(seed=21, device="cpu")
    opts = HybridBAOptions(solver="dense" if dense else "cg")
    data = tuple(x.double() if x.is_floating_point() else x for x in pd)
    args = ("point", state.point_params.double(), state.pose_params.double(),
            state.cam_fxfy.double(), *data[:3], data[3:-1], data[-1], opts,
            torch.tensor(opts.damping, dtype=torch.float64), I, C, dense)
    before = O.hybrid_terms
    plain = O.hybrid_terms(*args)
    with HC.summed_in_shares(share):
        assert O.hybrid_terms is not before
        shares = O.hybrid_terms(*args)
    assert O.hybrid_terms is before
    for name in ("g", "diag0", "Hp"):
        got, want = getattr(shares, name), getattr(plain, name)
        if want is None:
            assert got is None
            continue
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert torch.equal(shares.H_cl, plain.H_cl)
    ix = O.pair_index(O._i32(data[2]), O._i32(data[1]), data[-1], I, C,
                      False, dense, *O.group_index(
                          O._i32(data[2]), O._i32(data[1]), data[-1], I, C,
                          False)[:2], share=share)
    sizes = (ix[7][1:] - ix[7][:-1])
    assert int(sizes.max()) <= share and int(sizes.min()) >= 1
