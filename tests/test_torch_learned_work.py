"""The byte counts behind kernels S's and T's bounds, on the CPU: the
corner rows and heatmap texels they count are exactly those the plain
versions read (every other one may change without moving the result),
each counted once and never more than the input holds."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import sample_descriptors as S
from limap_tpu_torch.ops import sold2_lines as TU
from limap_tpu_torch.testing import learned_checks as LC
from torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("mode", ["clamp", "zero"])
def test_corner_cells_are_the_rows_the_sampler_reads(mode):
    grid, pts, scale = LC.sample_inputs(mode)
    g, p = torch.as_tensor(grid), torch.as_tensor(pts)
    plain = S.sample_clamp_plain if mode == "clamp" else S.sample_zero_plain
    cells = S.corner_cells(g.shape, p, mode, scale)
    Hc, Wc, D = g.shape
    assert len(torch.unique(cells)) == len(cells) <= Hc * Wc
    # rows outside the set do not move the result
    other = torch.ones(Hc * Wc, dtype=torch.bool)
    other[cells] = False
    g2 = g.clone().reshape(-1, D)
    g2[other] = 1e3
    assert torch.equal(plain(g, p, scale), plain(g2.reshape(g.shape), p,
                                                 scale))
    # each row in it does (the points' weights are nonzero somewhere)
    for c in cells[:: max(len(cells) // 25, 1)].tolist():
        g3 = g.clone().reshape(-1, D)
        g3[c] += 1.0
        assert not torch.equal(plain(g, p, scale),
                               plain(g3.reshape(g.shape), p, scale))


@pytest.mark.parametrize("mode", ["clamp", "zero"])
def test_sample_work_counts_each_row_once(mode):
    grid, pts, scale = LC.sample_inputs(mode)
    g, p = torch.as_tensor(grid), torch.as_tensor(pts)
    # every point again: the same rows, so only the points and outputs grow
    p2 = torch.cat([p, p])
    ops, nbytes = S.work(g, p, mode, scale)
    ops2, nbytes2 = S.work(g, p2, mode, scale)
    P, D = p.shape[0], g.shape[2]
    assert ops2 == 2 * ops
    assert nbytes2 - nbytes == P * (2 * p.element_size() + 4 * D)
    assert nbytes <= g.numel() * 4 + P * (2 * p.element_size() + 4 * D)


@pytest.mark.parametrize("case", [0, 2])
def test_candidate_texels_are_those_the_samples_read(case):
    name, hm, junc, prm = list(LC.candidate_cases())[case]
    h, j = torch.as_tensor(hm), torch.as_tensor(junc)
    si, ei = LC.pairs(len(junc), "cpu")
    out = TU.candidates_plain(h, j, si, ei, 64, prm)
    live = ~out[1].isnan()
    seen = TU.candidate_texels(h, j, si, ei, live, 64, prm)
    assert seen.shape == h.shape and 0 < int(seen.sum()) < h.numel()
    rng = np.random.default_rng(0)
    h2 = h.clone()
    h2[~seen] = torch.as_tensor(rng.random(int((~seen).sum())))
    out2 = TU.candidates_plain(h2, j, si, ei, 64, prm)
    for a, b in zip(out, out2):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and \
            torch.equal(a[~a.isnan()], b[~b.isnan()]), name
    ops, nbytes = TU.candidates_work(
        len(si), int(live.sum()), len(junc), 64,
        TU.patch_offsets(prm.patch_radius).shape[0], prm.bilinear,
        prm.use_candidate_suppression, int(seen.sum()))
    ops0, nbytes0 = TU.candidates_work(
        len(si), int(live.sum()), len(junc), 64,
        TU.patch_offsets(prm.patch_radius).shape[0], prm.bilinear,
        prm.use_candidate_suppression)
    assert ops == ops0
    assert nbytes - nbytes0 == int(seen.sum()) * (8 if prm.bilinear else 4)
