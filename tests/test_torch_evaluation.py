"""The port's evaluators against the JAX package's on the same numpy
inputs, on the CPU: ``point_segment_distance`` (zero-length segments
included), ``RefLineEvaluator``, ``PointCloudEvaluator.ComputeDistPoint``
and ``ComputeInlierRatioOneLine``; and the float64 reference that
chip_smoke's phase 13 holds ``RefLineEvaluator`` to.  Distances within
1e-5 m (fp32 on both sides, rounding order alone differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.evaluation import evaluator as jev
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.evaluation import (PointCloudEvaluator,
                                        RefLineEvaluator,
                                        point_segment_distance)
from limap_tpu_torch.evaluation import evaluator as pev
from limap_tpu_torch.testing.evaluation import refline_f64
from torch_threads import two_torch_threads  # noqa: F401

TOL = 1e-5


def _lines(rng, n, scale=3.0):
    s = rng.normal(size=(n, 3)) * scale
    return np.stack([s, s + rng.normal(size=(n, 3))], 1).astype(np.float32)


def test_point_segment_distance_with_zero_length_segments():
    """Segments of zero length (the 1e-12 clamp of the squared length)
    and ordinary ones, points on, beside and beyond them."""
    rng = np.random.default_rng(0)
    seg = _lines(rng, 12)
    seg[::4, 1] = seg[::4, 0]                    # zero length
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 3
    pts[:6] = seg[:6, 0]                         # on an endpoint
    got = point_segment_distance(
        torch.as_tensor(pts), Segments(torch.as_tensor(seg[:, 0]),
                                       torch.as_tensor(seg[:, 1]))).numpy()
    ref = np.asarray(jev.point_segment_distance(
        jnp.asarray(pts), JSegments(jnp.asarray(seg[:, 0]),
                                    jnp.asarray(seg[:, 1]))))
    assert got.shape == (50, 12)
    np.testing.assert_allclose(got, ref, atol=TOL)
    # a zero-length segment is its point
    np.testing.assert_allclose(
        got[:, ::4], np.linalg.norm(pts[:, None] - seg[None, ::4, 0], axis=-1),
        atol=TOL)


def test_refline_evaluator_as_the_jax_test():
    """The case of tests/test_evaluation.py: two unit reference lines,
    a prediction on the first."""
    ref = np.array([[[0, 0, 0], [1, 0, 0]], [[0, 1, 0], [1, 1, 0]]])
    ev = RefLineEvaluator(ref, device="cpu")
    assert abs(ev.SumLength() - 2.0) < 1e-5
    pred = np.array([[[0, 0.0, 0], [1, 0.0, 0]]])
    rec = ev.ComputeRecallRef(pred, 0.05, n_samples=100)
    assert abs(rec - 1.0) < 0.05
    assert abs(rec - jev.RefLineEvaluator(ref).ComputeRecallRef(
        pred, 0.05, n_samples=100)) < TOL


@pytest.mark.parametrize("budget", [None, 257])
def test_refline_evaluator_against_jax_and_float64(monkeypatch, budget):
    """Noisy predictions of 30 reference lines, one of them zero-length;
    recall at three taus against JAX (1e-5 m of recall a tau: a sample
    within rounding of tau would move it by 1/n_samples of a line's
    length, and none is) and the float64 reference (1e-3 relative, as
    phase 13); with a small chunk budget the reduction runs in many
    chunks and gives the same numbers."""
    if budget:
        monkeypatch.setattr(pev, "REF_PAIR_BUDGET", budget)
    rng = np.random.default_rng(1)
    ref = _lines(rng, 30)
    pred = (ref[:25] + rng.normal(0, 0.03, (25, 2, 3))).astype(np.float32)
    pred[3, 1] = pred[3, 0]
    ev, jv = RefLineEvaluator(ref, device="cpu"), jev.RefLineEvaluator(ref)
    length, rec64 = refline_f64(ref, pred, (0.01, 0.05, 0.1), 200)
    assert abs(ev.SumLength() - jv.SumLength()) < 1e-4
    assert abs(ev.SumLength() - length) < 1e-3 * length
    for tau in (0.01, 0.05, 0.1):
        got = ev.ComputeRecallRef(pred, tau, 200)
        assert abs(got - jv.ComputeRecallRef(pred, tau, 200)) < TOL
        assert abs(got - rec64[tau]) <= 1e-3 * rec64[tau]
    assert ev.ComputeRecallRef(pred[:0], 0.05) == 0.0


def test_compute_dist_point_and_inlier_ratio_one_line():
    rng = np.random.default_rng(2)
    cloud = (rng.normal(size=(3000, 3)) * 2).astype(np.float32)
    ev = PointCloudEvaluator(cloud, device="cpu")
    jv = jev.PointCloudEvaluator(cloud)
    for p in rng.normal(size=(5, 3)).astype(np.float32):
        assert abs(ev.ComputeDistPoint(p) - jv.ComputeDistPoint(p)) < TOL
    # the same samples within tau; the float32 mean may round one ulp
    # apart (JAX divides by the count otherwise than torch)
    lines = _lines(rng, 6, 1.0)
    for line in lines:
        for tau in (0.05, 0.2):
            got = ev.ComputeInlierRatioOneLine(line, tau, 300)
            ref = jv.ComputeInlierRatioOneLine(line, tau, 300)
            assert round(got * 300) == round(ref * 300)
            assert abs(got - ref) < 1e-6


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("which", ["cloud", "reflines"])
def test_evaluators_raise_without_gpu_unless_asked(no_gpu, which):
    make = {"cloud": PointCloudEvaluator, "reflines": RefLineEvaluator}[which]
    arr = np.zeros((2, 2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(arr.reshape(-1, 3) if which == "cloud" else arr)
    assert make(arr.reshape(-1, 3) if which == "cloud" else arr,
                device="cpu").device.type == "cpu"
