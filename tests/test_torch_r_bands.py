"""Kernel R's band design replayed in torch on the CPU
(``ops/log_sinkhorn.py::bands_replay``): the coupling's rows cut into
bands, each band's partial of every column (its raw maximum and its sum
of exps from that maximum, or from 0 where it is not finite), and the
merge of the partials in band order.  The replay is held to the JAX
package's ``log_sinkhorn`` and to the port's plain version, on seeded
scores and on the edge cases the merge must get right: rows and columns
of -inf scores, a band whose entries are all -inf, a band holding only
the dustbin row, uneven and empty bands, M = 0 and N = 0.

Tolerance: both sides are float32 and add in different orders (and the
merge rescales each band once more), so within ``ATOL + RTOL * |Z|`` of
the reference, the kernel's own tolerance against plain
(``testing/learned_checks.py``); the positions of the infinities and
NaNs must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.point2d import matching as ref_matching
from limap_tpu_torch.ops import log_sinkhorn as R
from limap_tpu_torch.testing.learned_checks import (SINKHORN_ATOL,
                                                    SINKHORN_RTOL)
from torch_threads import two_torch_threads  # noqa: F401


def scores(M, N, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(M, N))
            * scale).astype(np.float32)


def assert_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], ref[~fin], equal_nan=True)
    if fin.any():
        tol = SINKHORN_ATOL + SINKHORN_RTOL * np.abs(ref[fin]).max()
        assert np.abs(got[fin] - ref[fin]).max() <= tol


def jax_z(s, b, iters):
    return np.asarray(ref_matching.log_sinkhorn(jnp.asarray(s),
                                                jnp.float32(b), iters))




def even(n):
    return lambda rows: R.band_firsts(rows, n)


CASES = [
    ("1 band", 40, 33, 20, 0.5, even(1)),
    ("2 bands", 40, 33, 20, 0.5, even(2)),
    ("5 bands", 57, 64, 50, 1.0, even(5)),
    ("16 bands", 130, 70, 50, -0.3, even(16)),
    ("uneven", 30, 41, 30, 0.5, lambda rows: [0, 1, 2, 17, 25]),
    ("empty band", 30, 41, 30, 0.5, lambda rows: [0, 9, 9, 20]),
    ("dustbin row alone", 30, 41, 30, 0.5, lambda rows: [0, 12, rows - 1]),
    ("more bands than columns", 40, 3, 20, 0.5, even(16)),
]


@pytest.mark.parametrize("name,M,N,iters,b,cut", CASES,
                         ids=[c[0] for c in CASES])
def test_bands_replay_matches_jax_and_plain(name, M, N, iters, b, cut):
    s = scores(M, N, seed=len(name))
    firsts = cut(M + 1)
    got = R.bands_replay(torch.as_tensor(s), b, iters, firsts)
    assert_close(got, jax_z(s, b, iters))
    assert_close(got, R.log_sinkhorn_plain(torch.as_tensor(s), b, iters))


def _inf_scores():
    s = scores(24, 31, seed=5)
    s[3, :] = -np.inf          # a row of -inf scores
    s[:, 7] = -np.inf          # a column of -inf scores
    s[10:16, :] = -np.inf      # rows that fill a band of the cut below
    return s


@pytest.mark.parametrize("cut", [[0, 10, 16], [0, 4, 10, 16, 24], [0]],
                         ids=["band of -inf", "narrow bands", "one band"])
def test_bands_replay_with_infinite_scores(cut):
    s = _inf_scores()
    got = R.bands_replay(torch.as_tensor(s), 0.5, 30, cut)
    assert_close(got, jax_z(s, 0.5, 30))
    assert_close(got, R.log_sinkhorn_plain(torch.as_tensor(s), 0.5, 30))


def test_bands_replay_with_a_whole_band_and_column_of_minus_inf():
    """Every score -inf in the band's rows and in one column: the band's
    partials are (-inf, 0), skipped by the merge, and the column's only
    finite entries are the dustbin's."""
    s = scores(20, 12, seed=9)
    s[:8] = -np.inf
    s[:, 4] = -np.inf
    for cut in ([0, 8], [0, 4, 8, 14], R.band_firsts(21, 5)):
        got = R.bands_replay(torch.as_tensor(s), 1.0, 25, cut)
        assert_close(got, jax_z(s, 1.0, 25))


@pytest.mark.parametrize("M,N", [(0, 17), (17, 0), (0, 1), (1, 0)])
def test_bands_replay_with_an_empty_side(M, N):
    s = scores(M, N, seed=3)
    for bands in (1, 2, 5):
        got = R.bands_replay(torch.as_tensor(s), 0.5, 10,
                             R.band_firsts(M + 1, min(bands, M + 1)))
        assert_close(got, jax_z(s, 0.5, 10))
        assert_close(got, R.log_sinkhorn_plain(torch.as_tensor(s), 0.5, 10))


def test_merge_is_the_single_max_then_sum():
    """The merge of any cut of a column equals one logsumexp over it
    within a few ulp, including columns with large and -inf entries."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.normal(size=(50, 9)) * 30).astype(np.float32))
    x[:, 0] = float("-inf")
    x[:20, 1] = float("-inf")
    x[5, 2] = 80.0
    ref = torch.logsumexp(x.double(), 0)
    for firsts in ([0], [0, 1], [0, 20, 21, 49], R.band_firsts(50, 16)):
        bounds = firsts + [50]
        pm, ps = [], []
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            band = x[r0:r1]
            mx = band.max(0).values
            m = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
            pm.append(mx)
            ps.append(torch.exp(band - m).sum(0))
        got = R.merge_bands(torch.stack(pm), torch.stack(ps))
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        assert torch.allclose(got[fin].double(), ref[fin], rtol=0,
                              atol=1e-5 * float(ref[fin].abs().max()))


def test_band_firsts_cover_the_rows_in_order():
    for rows, bands in ((557, 16), (2049, 132), (5, 5), (1, 1), (7, 3)):
        f = R.band_firsts(rows, bands)
        assert f[0] == 0 and len(f) == bands
        sizes = np.diff(f + [rows])
        assert sizes.min() >= rows // bands and sizes.max() <= -(-rows // bands)


def test_work_counts_the_exps():
    ops, nbytes, exps = R.work(556, 565, 50)
    assert exps == 2 * 50 * 557 * 566
    assert ops == R.OPS_ELEMENT_PASS * exps
    assert nbytes == 4 * (556 * 565 + 557 * 566)
    # 16 exps a clock an SM: 3.15e7 exps on 16 SMs at 1.98 GHz take 62 us
    assert abs(R.exp_ms(exps, 16, 1.98e9) - 0.0622) < 1e-3
