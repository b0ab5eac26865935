"""Kernel W's both-directions form on the CPU: the key that carries a
best score and its index (``ops/ncc_argmax.py::pack_keys``, the kernel's
map shifted into int64) against torch.max on ties, -0.0 and negative
scores; ``ncc_argmax_both_plain`` against JAX's jitted ``_ncc_flow`` in
both directions (rows: equal indices; columns, which JAX computes as
f2 @ f1.T in its own summation order: equal indices or a near tie within
``zoo_checks.NCC_TIE`` in float64; scores 1e-6); and the correlation
flow taking both directions from one call a pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import dense as J
from limap_tpu_torch.line2d import dense as P
from limap_tpu_torch.ops import ncc_argmax as W
from limap_tpu_torch.testing import zoo_checks
from torch_threads import two_torch_threads  # noqa: F401

LEVELS = np.array([-3.5, -1.0, -0.25, -0.0, 0.0, 1e-30, 0.25, 1.0, 3.5],
                  np.float32)


def _keyed_max(c: torch.Tensor, dim: int):
    """(index, score) of c's max along ``dim`` through the kernel's keys:
    the largest key of the scores and their indices along ``dim``."""
    n = c.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    idx = torch.arange(n).reshape(shape).expand_as(c)
    return W.unpack_keys(W.pack_keys(c, idx).amax(dim))


@pytest.mark.parametrize("seed", range(4))
def test_keys_pick_torch_max_on_ties(seed):
    """Scores drawn from a few levels (ties everywhere, -0.0 beside +0.0,
    negative rows): the largest key gives torch.max's first index and
    its value, by rows and by columns."""
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(LEVELS[rng.integers(0, len(LEVELS), (37, 53))])
    c[:5] = torch.as_tensor(LEVELS[:4][rng.integers(0, 4, (5, 53))])
    c[5] = -0.0
    c[6, ::2] = 0.0
    c[6, 1::2] = -0.0
    for dim in (0, 1):
        ref_s, ref_i = c.max(dim)
        got_i, got_s = _keyed_max(c, dim)
        assert torch.equal(got_i, ref_i), dim
        assert torch.equal(got_s, ref_s), dim     # -0.0 == +0.0


def test_keys_order_scores_and_reverse_indices():
    """The key is monotone in the score over the whole float line (signs,
    zeros, subnormals, infinities) and, among equal scores, decreasing in
    the index; unpacking gives the index and the score back, -0.0 as
    +0.0."""
    s = torch.tensor([-np.inf, -3e38, -1.0, -1e-40, -0.0, 0.0, 1e-45,
                      1e-40, 1.0, 3e38, np.inf], dtype=torch.float32)
    k = W.pack_keys(s, torch.zeros(len(s), dtype=torch.int64))
    assert bool((k[1:] >= k[:-1]).all())
    assert int((k[1:] == k[:-1]).sum()) == 1       # -0.0 and +0.0 only
    idx = torch.tensor([0, 1, 7, 2 ** 31, 2 ** 32 - 1])
    ki = W.pack_keys(torch.full((5,), 0.5), idx)
    assert bool((ki[1:] < ki[:-1]).all())
    rng = np.random.default_rng(0)
    v = torch.as_tensor((rng.normal(size=1000)
                         * 10.0 ** rng.integers(-30, 30, 1000))
                        .astype(np.float32))
    v[:3] = torch.tensor([-0.0, 0.0, -np.inf])
    i = torch.as_tensor(rng.integers(0, 2 ** 32, 1000))
    gi, gs = W.unpack_keys(W.pack_keys(v, i))
    assert torch.equal(gi, i)
    assert torch.equal(gs.view(torch.int32),
                       torch.where(v == 0, 0.0, v).view(torch.int32))


@pytest.mark.parametrize("case", range(len(zoo_checks.ncc_cases())))
def test_both_directions_match_jax(case):
    _, f1, f2 = zoo_checks.ncc_cases()[case]
    i12, s12, i21, s21 = W.ncc_argmax_both_plain(torch.as_tensor(f1),
                                                 torch.as_tensor(f2))
    ri, rs = J._ncc_flow(jnp.asarray(f1), jnp.asarray(f2))
    assert np.array_equal(np.asarray(ri), i12.numpy())
    np.testing.assert_allclose(s12.numpy(), np.asarray(rs), atol=1e-6)
    ci, cs = J._ncc_flow(jnp.asarray(f2), jnp.asarray(f1))
    cols, bad, serr = zoo_checks.ncc_witness(
        f2, f1, i21, s21, torch.as_tensor(np.array(ci)),
        torch.as_tensor(np.array(cs)))
    assert not bad, (len(cols), bad[:5])
    assert serr <= 1e-6
    # the CPU wrapper is the plain version
    got = W.ncc_argmax_both(torch.as_tensor(f1), torch.as_tensor(f2))
    assert all(torch.equal(a, b) for a, b in zip(
        got, (i12, s12, i21, s21)))


def test_duplicated_rows_keep_the_first_index_both_ways():
    name, f1, f2 = zoo_checks.ncc_cases()[4]
    assert name.startswith("duplicates in both")
    i12, _, i21, _ = W.ncc_argmax_both_plain(torch.as_tensor(f1),
                                             torch.as_tensor(f2))
    assert np.array_equal(i12[:20].numpy(),
                          zoo_checks.first_indices(f1, f2, 20))
    assert np.array_equal(i21[:20].numpy(),
                          zoo_checks.first_indices(f2, f1, 20))
    assert np.array_equal(i21[:20].numpy(), np.arange(20))


def test_correlation_flow_calls_the_kernel_once_a_pair(monkeypatch):
    """get_warping_symmetric takes both warps from one call of kernel W's
    wrapper, and they are the two directions' single-direction warps."""
    calls = []
    orig = P.ncc_argmax_both

    def counted(a, b):
        calls.append((a.shape[0], b.shape[0]))
        return orig(a, b)

    monkeypatch.setattr(P, "ncc_argmax_both", counted)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (48, 64)).astype(np.uint8) for _ in (0, 1)]
    cp = P.CorrelationFlowMatcher(device="cpu")
    w12, c12, w21, c21 = cp.get_warping_symmetric(*imgs)
    assert calls == [(48, 48)]
    f1, g1, s1 = cp._features(imgs[0])
    f2, g2, s2 = cp._features(imgs[1])
    i12, s12, i21, s21 = W.ncc_argmax_both_plain(f1, f2)
    for (idx, score, ga, gb, sa, sb), (w, c) in (
            ((i12, s12, g1, g2, s1, s2), (w12, c12)),
            ((i21, s21, g2, g1, s2, s1), (w21, c21))):
        rw, rc = cp._one_direction(idx, score, ga, gb, sa, sb)
        assert torch.equal(rw, w) and torch.equal(rc, c)
