"""Kernels V, W, X and Y on the CPU: the seeded comparisons of
testing/zoo_checks (both sides the plain version here; the card runs
them in tests/test_torch_cuda.py and chip_smoke), the wrappers' input
checks, and the operation and byte counts behind their bounds, each
against a count made another way."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import l2d2_patches as Y
from limap_tpu_torch.ops import lbd_describe as V
from limap_tpu_torch.ops import ncc_argmax as W
from limap_tpu_torch.ops import tplsd_decode as X
from limap_tpu_torch.testing import zoo_checks
from torch_threads import two_torch_threads  # noqa: F401


def _cases():
    return [(n, c) for n, c, _ in zoo_checks.check_all("cpu")]


@pytest.fixture(scope="module")
def results():
    return {(n, c): r for n, c, r in zoo_checks.check_all("cpu")}


@pytest.mark.parametrize("name,case", _cases())
def test_seeded_case_holds_on_the_cpu(results, name, case):
    assert results[(name, case)]["ok"], results[(name, case)]


def test_x_counts_peaks_and_rows():
    """The function's work, not the kernel's: a separable window maximum
    (2r compares along a row and 2r along a column) and the peak test a
    pixel, one compare a peak for the top-K selection, K log2 K to order
    the K rows."""
    c = np.zeros((20, 30), np.float32)
    c[5, 5] = c[10, 20] = c[15, 3] = 0.9
    n_peaks = int((X.peak_scores(torch.as_tensor(c), 0.25, 4) > 0).sum())
    assert n_peaks == 3
    ops, nbytes = X.work(20, 30, 8, 4, n_peaks)
    assert ops == 600 * (16 + 2) + 3 + 8 * 3
    assert nbytes == 600 * 4 + 8 * 36 + 4
    ops, _ = X.work(600, 800, 512, 4, 2940)
    assert ops == 480000 * 18 + 2940 + 512 * 9


@pytest.mark.parametrize("r", [1, 4])
def test_x_window_maximum_is_separable(r):
    """The maximum over rows, then over columns, each 2r + 1 wide and
    padded with -inf, is the (2r+1)^2 window's maximum that the peak test
    takes (ties included), so the separable count is of the same
    function."""
    rng = np.random.default_rng(r)
    c = torch.as_tensor(np.round(rng.random((23, 31)), 1).astype(np.float32))
    k = 2 * r + 1
    rows = torch.nn.functional.max_pool2d(c[None, None], (1, k), 1, (0, r))
    sep = torch.nn.functional.max_pool2d(rows, (k, 1), 1, (r, 0))
    full = torch.nn.functional.max_pool2d(c[None, None], k, 1, r)
    assert torch.equal(sep, full)


def test_w_and_v_counts():
    ops, nbytes = W.work(7500, 7500, 64)
    assert ops == 2 * 7500 * 7500 * 64
    # both directions: the product once, an index and a score a row and
    # a column
    assert nbytes == 4 * 64 * 15000 + 12 * 15000
    ops, nbytes = V.work(600, 800, 640)
    samples = 640 * 63 * 32
    assert ops > samples * 70 and nbytes == 600 * 800 * 4 + 640 * 305


def test_y_boxes_follow_the_reference_affine():
    """A vertical line through the image centre needs no rotation: its
    inverse map is a translation and its box is length x 2/3 length."""
    minv, boxes = Y.line_boxes(np.array([[[40.0, 10.0], [40.0, 50.0]]]),
                               (60, 80))
    np.testing.assert_allclose(minv[0], [1, 0, 0, 0, 1, 0], atol=1e-6)
    assert boxes[0].tolist() == [10, 27, 40, 26]    # 40 - 26 // 2 = 27
    ops, nbytes = Y.work((60, 80), torch.as_tensor(minv),
                         torch.as_tensor(boxes))
    # the identity map samples whole texels: the box's rows 10..49 and
    # columns 27..52, each with its neighbour below and to the right
    assert nbytes == 41 * 27 * 4 + 40 + 48 * 32 * 4
    assert ops == 48 * 32 * (4 * 23 + 9)


def test_y_reads_only_the_counted_texels():
    """Image texels outside image_texels do not move the plain patches
    (lines inside the image, across its edge and longer than it), the
    counted ones do, and the bytes count each of them once."""
    rng = np.random.default_rng(3)
    hw = (60, 80)
    lines = np.array([[[40.0, 10.0], [40.0, 50.0]],
                      [[3.0, 2.0], [30.0, 45.0]],
                      [[70.0, 55.0], [78.0, 20.0]],
                      [[5.0, 1.0], [75.0, 58.0]],      # longer than H
                      [[10.0, 30.0], [70.0, 31.0]]])
    minv, boxes = (torch.as_tensor(a) for a in Y.line_boxes(lines, hw))
    img = torch.as_tensor(rng.random(hw).astype(np.float32))
    texels = Y.image_texels(hw, minv, boxes)
    assert 0 < texels.numel() < hw[0] * hw[1]
    ref = Y.l2d2_patches_plain(img, minv, boxes)
    other = img.clone().reshape(-1)
    outside = torch.ones(other.numel(), dtype=torch.bool)
    outside[texels] = False
    other[outside] = torch.as_tensor(
        rng.random(int(outside.sum())).astype(np.float32)) + 5.0
    assert torch.equal(Y.l2d2_patches_plain(other.reshape(hw), minv, boxes),
                       ref)
    inside = img.clone().reshape(-1)
    inside[texels] += 5.0
    assert not torch.equal(Y.l2d2_patches_plain(inside.reshape(hw), minv,
                                                boxes), ref)
    _, nbytes = Y.work(hw, minv, boxes)
    assert nbytes == texels.numel() * 4 + 5 * 40 + 5 * 48 * 32 * 4


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        X.tplsd_decode(torch.zeros(4, 5), torch.zeros(4, 5, 3), 2)
    with pytest.raises(ValueError):
        X.tplsd_decode(torch.zeros(4, 5), torch.zeros(4, 5, 4), 21)
    with pytest.raises(ValueError):
        W.ncc_argmax_both(torch.zeros(3, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        W.ncc_argmax_both(torch.zeros(3, 4), torch.zeros(0, 4))
    with pytest.raises(ValueError):
        W.ncc_argmax_both(torch.zeros(0, 4), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        W.ncc_argmax_rowscan(torch.zeros(3, 4), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        V.lbd_describe(torch.zeros(4, 5), torch.zeros(2, 4),
                       torch.ones(2))
    with pytest.raises(ValueError):
        Y.l2d2_patches(torch.zeros(4, 5), torch.zeros(1, 6),
                       torch.zeros(1, 4, dtype=torch.int64))
