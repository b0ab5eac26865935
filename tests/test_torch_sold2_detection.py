"""The port's SOLD2 post-processing and line matcher against the JAX
package on the CPU, on synthetic heatmaps with controlled junctions (the
reference's full detect on a random network takes ~40 s here).

The junction conversion, the NMS and the heatmap normalization are host
numpy in both: equal.  The detector's candidates (kernel T's plain
version) and junction refinement (kernel U's) repeat the reference's
float64 numpy and float32 sampler operation for operation, numpy's
pairwise sums included: segments equal, bit for bit.  The Wunsch
matcher's descriptors are float64 rounded to float32 in both (within
1e-6); its scores are a float32 product in another order, so its match
lists are held equal where no two candidate line scores of a row tie
within 1e-6, and compared as sets per line for the top-k."""

import numpy as np
import pytest
import torch

from limap_tpu.line2d import get_extractor as ref_get_extractor
from limap_tpu.line2d import get_matcher as ref_get_matcher
from limap_tpu.line2d.sold2 import detection as ref_det
from limap_tpu.line2d.sold2 import sold2 as ref_sold2
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.line2d.sold2 import detection as det
from limap_tpu_torch.line2d.sold2 import sold2
from limap_tpu_torch.ops import sold2_lines as TU
from limap_tpu_torch.testing import learned, pipeline
from limap_tpu_torch.testing.learned_checks import line_heatmap
from torch_threads import two_torch_threads  # noqa: F401

DESC_TOL = 1e-6


def test_junctions_nms_and_heatmap_equal_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1.0, (1, 12, 16, 65)).astype(np.float32)
    logits[0, 2, 3, 9] = 12.0
    logits[0, 7, 7, 40] = 12.0
    for topk in (0, 5, 300):
        a = ref_det.junctions_from_predictions(logits, 8, 1 / 65, topk)
        b = det.junctions_from_predictions(logits, 8, 1 / 65, topk)
        assert np.array_equal(a, b)
    assert [17, 25] in b.astype(int).tolist()
    hl = rng.normal(size=(1, 40, 50, 2))
    assert np.array_equal(ref_det.heatmap_from_logits(hl),
                          det.heatmap_from_logits(hl))
    prob = rng.random((40, 50))
    for th in (3, 8):
        assert np.array_equal(ref_det.super_nms(prob, th, 0.5, 10),
                              det.super_nms(prob, th, 0.5, 10))
    heat = rng.random((70, 90)) ** 3
    assert np.array_equal(ref_det.refine_heatmap(heat, 0.2, 0.01),
                          det.refine_heatmap(heat, 0.2, 0.01))
    assert np.array_equal(
        ref_det.refine_heatmap_local(heat, 20, 0.5, 0.2, 0.001),
        det.refine_heatmap_local(heat, 20, 0.5, 0.2, 0.001))


@pytest.mark.parametrize("kw", [
    {},
    {"sampling_method": "bilinear", "detect_thresh": 0.2,
     "inlier_thresh": 0.5},
    {"use_candidate_suppression": False, "use_heatmap_refinement": False},
    {"use_junction_refinement": False,
     "heatmap_refine_cfg": {"mode": "global", "ratio": 0.2,
                            "valid_thresh": 0.001}},
])
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_equals_jax_on_synthetic_heatmaps(seed, kw):
    hm, junc = line_heatmap(72, 96, 8, seed)
    a = ref_det.LineSegmentDetector(**kw).detect(junc, hm)
    b = det.LineSegmentDetector(device="cpu", **kw).detect(junc, hm)
    assert len(b) > 0
    assert np.array_equal(a, b)


def test_candidates_equal_the_reference_pieces():
    """T's plain version against the reference's _suppressed,
    _sample_candidates and decision: the suppression, every candidate's
    mean and the flags equal."""
    hm, junc = line_heatmap(64, 80, 7, 3)
    ref = ref_det.LineSegmentDetector(use_heatmap_refinement=False)
    si, ei = np.triu_indices(len(junc), 1)
    sup = ref._suppressed(junc, si, ei)
    feat = ref._sample_candidates(hm, junc[si[~sup]], junc[ei[~sup]])
    want = (feat.mean(-1) > 0.5) & ((feat > 0.5).mean(-1) >= 0.99)
    d, m, inl = TU.sold2_candidates(
        torch.as_tensor(hm), torch.as_tensor(junc),
        torch.as_tensor(si.astype(np.int32)),
        torch.as_tensor(ei.astype(np.int32)))
    assert np.array_equal(np.isnan(m.numpy()), sup)
    assert np.array_equal(m.numpy()[~sup], feat.mean(-1).astype(np.float64))
    assert np.array_equal(inl.numpy()[~sup], (feat > 0.5).sum(-1))
    assert np.array_equal(d.numpy()[~sup], want) and want.any()


def test_refine_junctions_equal_on_integer_junctions():
    """U on integer junctions (their first and last samples are 0: the
    reference's bilinear weights vanish at integer coordinates) and on
    half-pixel ones, with the full 9^4 grid: equal bit for bit."""
    hm, junc = line_heatmap(72, 96, 8, 4)
    rng = np.random.default_rng(5)
    segs = junc[rng.integers(0, len(junc), (5, 2))]
    segs = np.concatenate([segs, segs[:2] + 0.5])
    ref = ref_det.LineSegmentDetector()._refine_junctions(segs, hm, 72, 96)
    got = det.LineSegmentDetector(device="cpu")._refine_junctions(
        segs, hm, 72, 96)
    assert np.array_equal(ref, got)
    zero = TU.bilinear_plain(torch.as_tensor(hm), torch.tensor([3.0]),
                             torch.tensor([4.0]))
    assert float(zero) == 0.0


def test_gt_heatmap_recall_equals_jax():
    scene = pipeline.build_scene(n_views=1, hw=(300, 400))
    (heat, junc, segs), = learned.gt_heatmap_views(scene, [0]).values()
    a = ref_det.LineSegmentDetector().detect(junc, heat)
    b = det.LineSegmentDetector(device="cpu").detect(junc, heat)
    assert np.array_equal(a, b)
    assert learned.segment_recall(b, segs) > 0.5


def _line_descinfos(seed, n1=20, n2=17):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(1, 24, 32, 128)).astype(np.float32)
    s1 = rng.uniform(0, [95, 127], (n1, 2, 2))
    s2 = np.concatenate([s1[:12] + rng.normal(0, 0.5, (12, 2, 2)),
                         rng.uniform(0, [95, 127], (n2 - 12, 2, 2))])
    return grid, s1, s2


def test_wunsch_descriptors_equal_jax():
    grid, s1, _ = _line_descinfos(0)
    s1 = np.concatenate([s1, [[[-3, 2], [100, 130]], [[0, 0], [95, 127]]]])
    a = ref_sold2.WunschLineMatcher().compute_descriptors(s1, grid, 4)
    b = sold2.WunschLineMatcher(device="cpu").compute_descriptors(s1, grid,
                                                                  4)
    np.testing.assert_allclose(b[0], a[0], atol=DESC_TOL)
    assert np.array_equal(a[1], b[1])
    pts_a = ref_sold2.WunschLineMatcher().sample_line_points(s1)
    pts_b = sold2.WunschLineMatcher(device="cpu").sample_line_points(s1)
    assert all(np.array_equal(x, y) for x, y in zip(pts_a, pts_b))


def _tied(ls, i, cands, tol=1e-6):
    """Row i's candidate line scores tie within tol."""
    v = np.sort(ls[i][cands])
    return bool((np.diff(v) <= tol).any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wunsch_matches_equal_jax(seed):
    grid, s1, s2 = _line_descinfos(seed)
    ref = ref_sold2.WunschLineMatcher()
    port = sold2.WunschLineMatcher(device="cpu")
    d1 = ref.compute_descriptors(s1, grid, 4)
    d2 = ref.compute_descriptors(s2, grid, 4)
    a = ref.compute_matches(d1, d2)
    b = port.compute_matches(d1, d2)
    ls = ref._line_scores(ref._score_matrix(d1, d2))
    for i in np.nonzero(a != b)[0]:
        assert _tied(ls, i, np.arange(ls.shape[1]), 1e-5)
    assert (b >= 0).sum() >= 8
    ta = ref.compute_matches_topk(d1, d2, 3)
    tb = port.compute_matches_topk(d1, d2, 3)
    for i in range(len(ta)):
        assert set(ta[i]) == set(tb[i]) or _tied(ls, i, np.r_[ta[i], tb[i]])
    scores = np.random.default_rng(seed).normal(size=(9, 5, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        port.needleman_wunsch(torch.as_tensor(scores)).numpy(),
        ref.needleman_wunsch(scores), atol=1e-6)


@pytest.mark.parametrize("topk", [0, 2])
def test_sold2_matcher_equals_jax(topk):
    grid, s1, s2 = _line_descinfos(3)
    ref = ref_sold2.WunschLineMatcher()
    infos = [dict(zip(("desc", "valid"), ref.compute_descriptors(s, grid, 4)))
             for s in (s1, s2)]
    ref_m = ref_get_matcher({"method": "sold2", "topk": topk},
                            ref_get_extractor({"method": "sold2"}))
    port_m = get_matcher({"method": "sold2", "topk": topk},
                         get_extractor({"method": "sold2"}, device="cpu"),
                         device="cpu")
    a = ref_m.match_pair(*infos)
    b = port_m.match_pair(*infos)
    if topk == 0:
        assert set(map(tuple, a.tolist())) == set(map(tuple, b.tolist()))
    else:
        assert a.shape == b.shape
        for i in range(len(s1)):
            assert set(a[a[:, 0] == i, 1]) == set(b[b[:, 0] == i, 1])
    empty = {"desc": np.zeros((128, 0), np.float32),
             "valid": np.zeros((0, 5), bool)}
    assert port_m.match_pair(empty, infos[1]).shape == (0, 2)
