"""The comparisons that hold the fit-and-merge kernels to their plain
versions (limap_tpu_torch/testing/fitnmerge_checks.py), run on the CPU:
they accept the plain version's own output and flips that sit within
rounding of a threshold, and refuse faults."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops.line_ransac import line_ransac_plain
from limap_tpu_torch.ops.linker_edges import (linker_edges_plain, pack_bits,
                                              unpack_bits)
from limap_tpu_torch.testing import fitnmerge_checks as fc


@pytest.mark.parametrize("case", fc.RANSAC_CASES)
def test_line_ransac_comparison_accepts_plain(case):
    res = fc.check_line_ransac(*case, device="cpu")
    assert res["ok"] and res["rows_differ"] == 0, res


def test_line_ransac_inputs_put_points_on_the_threshold():
    """Every fifth row's threshold is the exact distance of one point to
    hypothesis 0's line, so `<=` is exercised at equality."""
    points, valid, th, idx_a, idx_b = fc.ransac_inputs(2, 1000, 64, 32)
    p = torch.as_tensor(points)
    r = torch.arange(len(p))
    from limap_tpu_torch.ops.line_ransac import point_line_dist
    d = point_line_dist(p, p[r, torch.as_tensor(idx_a[:, 0]).long()],
                        p[r, torch.as_tensor(idx_b[:, 0]).long()])
    on = (d == torch.as_tensor(th)[:, None]).any(1)
    assert int(on[::5].sum()) > 150
    assert np.isnan(points).any() and (~valid).all(1).any()


def test_line_ransac_comparison_refuses_a_fault():
    args = fc.ransac_inputs(2, 1000, 64, 32)
    on = [torch.as_tensor(x) for x in args]
    ref = line_ransac_plain(*on)
    bad = [x.clone() for x in ref]
    row = int(torch.nonzero(ref[1] > 10)[0, 0])
    col = int(torch.nonzero(ref[0][row])[0, 0])
    bad[0][row, col] = False
    bad[1][row] -= 1
    assert not fc.compare_line_ransac(bad, ref, args)["ok"]
    bad = [x.clone() for x in ref]
    bad[3][row] = (bad[3][row] + 1) % 32
    assert not fc.compare_line_ransac(bad, ref, args)["ok"]


@pytest.mark.parametrize("config", fc.LINKER_CONFIGS)
@pytest.mark.parametrize("case", fc.LINKER_CASES)
def test_linker_comparison_accepts_plain(case, config):
    res = fc.check_linker_edges(*case, config, device="cpu")
    assert res["ok"] and res["flips"] == 0, res
    assert res["edges"] > 5
    assert res["near_threshold_pairs"] >= 10


def _flip(bits, slot, i, a, b):
    self_bits, cross_bits = (x.clone() for x in bits)
    L = self_bits.shape[1]
    target = self_bits[i] if slot == 0 else cross_bits[i, slot - 1]
    dense = unpack_bits(target, L)
    dense[a, b] = ~dense[a, b]
    target.copy_(pack_bits(dense))
    return self_bits, cross_bits


def test_linker_comparison_accepts_a_rounding_flip_and_refuses_a_fault():
    linker = fc.linker_config("fitnmerge")
    arrays = fc.linker_inputs(1, 5, 70, 3, linker)
    args = fc.linker_tensors(arrays, "cpu") + (
        linker.linker_2d, linker.linker_3d.to_spatial_merging())
    ref = linker_edges_plain(*args)
    mask = arrays[5]
    pairs = np.array([(0, i, a, a + 1) for i in range(5) for a in range(69)
                      if mask[i, a] and mask[i, a + 1]])
    margins = fc.pair_margins(pairs, arrays, linker)
    near = pairs[np.argmin(margins)]
    assert margins.min() < 1e-5
    res = fc.compare_linker_edges(_flip(ref, *near), ref, arrays, linker)
    assert res["ok"] and res["flips"] == 1, res
    far = pairs[np.argmax(np.where(np.isfinite(margins), margins, 0))]
    assert margins.max() > 0.1
    res = fc.compare_linker_edges(_flip(ref, *far), ref, arrays, linker)
    assert not res["ok"], res
    # a cross pair far from every threshold
    s, c = ref
    hit = torch.nonzero(unpack_bits(c, 70))
    i, k, a, b = (int(x) for x in hit[0])
    m = fc.pair_margins(np.array([(k + 1, i, a, b)]), arrays, linker)
    res = fc.compare_linker_edges(_flip(ref, k + 1, i, a, b), ref, arrays,
                                  linker)
    assert res["ok"] == bool(m[0] <= fc.FLIP_TOL)


@pytest.mark.parametrize("config", fc.LINKER_CONFIGS)
def test_pair_bits_repeat_the_plain_version(config):
    """The per-pair float32 evaluation the spread check uses gives the
    plain version's bit on every pair, set or not."""
    linker = fc.linker_config(config)
    arrays = fc.linker_inputs(2, 4, 130, 4, linker)
    args = fc.linker_tensors(arrays, "cpu") + (
        linker.linker_2d, linker.linker_3d.to_spatial_merging())
    s, c = linker_edges_plain(*args)
    dense_s, dense_c = unpack_bits(s, 130), unpack_bits(c, 130)
    rng = np.random.default_rng(0)
    pairs = np.concatenate([
        np.c_[np.zeros((300, 1), int), rng.integers(0, 4, (300, 1)),
              rng.integers(0, 130, (300, 2))],
        np.c_[rng.integers(1, 5, (300, 1)), rng.integers(0, 4, (300, 1)),
              rng.integers(0, 130, (300, 2))],
        np.c_[np.zeros((len(torch.nonzero(dense_s)), 1), int),
              torch.nonzero(dense_s).numpy()]])
    mask, nmask = arrays[5], arrays[10]
    # the masks are the kernel's and the plain version's, not the
    # per-pair test's: keep the pairs of two valid lines
    keep = [k for k, (sl, i, a, b) in enumerate(pairs)
            if mask[i, a] and (mask[i, b] and b > a if sl == 0 else (
                nmask[i, sl - 1] and mask[arrays[9][i, sl - 1], b]))]
    pairs = pairs[keep]
    ref = np.array([bool(dense_s[i, a, b]) if sl == 0
                    else bool(dense_c[i, sl - 1, a, b])
                    for sl, i, a, b in pairs])
    assert ref.sum() > 10 and (~ref).sum() > 10
    assert np.array_equal(fc.pair_bits_f32(pairs, arrays, linker), ref)


def _valid_pairs(arrays):
    """(slot, i, a, b) of every pair of valid lines the edge test
    evaluates: self pairs a < b (slot 0), then the live neighbour slots."""
    mask, nbrs, nmask = arrays[5], arrays[9], arrays[10]
    L = mask.shape[1]
    i, a, b = np.nonzero(mask[:, :, None] & mask[:, None, :]
                         & np.triu(np.ones((L, L), bool), 1))
    self_pairs = np.c_[np.zeros_like(i), i, a, b]
    i, k, a, b = np.nonzero(mask[:, None, :, None] & mask[nbrs][:, :, None]
                            & nmask[:, :, None, None])
    return np.concatenate([self_pairs, np.c_[k + 1, i, a, b]])


def _flip_all(bits, pairs, L):
    dense_s, dense_c = unpack_bits(bits[0], L), unpack_bits(bits[1], L)
    for slot, i, a, b in pairs:
        if slot == 0:
            dense_s[i, a, b] = ~dense_s[i, a, b]
        else:
            dense_c[i, slot - 1, a, b] = ~dense_c[i, slot - 1, a, b]
    return pack_bits(dense_s), pack_bits(dense_c)


def test_linker_comparison_caps_the_flips_at_the_plain_spread():
    """Flips that each lie in the plain version's one-ulp spread pass
    while there are no more of them than the plain version itself changes
    under one-ulp moves of all its inputs (plus one), and fail beyond."""
    linker = fc.linker_config("jax_defaults")
    arrays = fc.linker_inputs(1, 5, 70, 3, linker)
    args = fc.linker_tensors(arrays, "cpu") + (
        linker.linker_2d, linker.linker_3d.to_spatial_merging())
    ref = linker_edges_plain(*args)
    pairs = _valid_pairs(arrays)
    base = fc.pair_bits_f32(pairs, arrays, linker)
    noisy = np.zeros(len(pairs), bool)
    for seed in range(fc.SPREAD_DRAWS):
        noisy |= fc.pair_bits_f32(pairs, arrays, linker, seed) != base
    cap = max(fc.plain_spread(ref, arrays, linker)) + 1
    noisy_pairs = pairs[noisy]
    assert len(noisy_pairs) > cap > 5
    few = fc.compare_linker_edges(_flip_all(ref, noisy_pairs[:cap], 70), ref,
                                  arrays, linker)
    assert few["ok"] and few["flips"] == few["flip_cap"] == cap, few
    many = fc.compare_linker_edges(_flip_all(ref, noisy_pairs, 70), ref,
                                   arrays, linker)
    assert many["flips"] == len(noisy_pairs) > many["flip_cap"]
    assert many["flips_near_threshold"] + many["flips_in_spread"] \
        == many["flips"]
    assert not many["ok"], many
