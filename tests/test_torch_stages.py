"""The port stage by stage against the JAX package on a bench-style scene
(12 views x 64 lines x 4 neighbours).  Each stage from the filters on is
fed the reference's output of the stage before (through
``limap_tpu_torch.convert``), so a mismatch points at the stage that
made it.

The 2D detections carry 0.1 px of endpoint noise: with noise-free
projections many proposal scores sit exactly on the fullscore_th = 1.0
boundary (sums of exp(0) = 1 terms), where last-ulp differences between
XLA and ATen decide the edge test either way.
"""

import numpy as np
import pytest
import torch

from limap_tpu.base.line_linker import LineLinker3dConfig as JL3
from limap_tpu.merging.merging import compact_track_batch as jcompact
from limap_tpu.merging.merging import filter_chain_batch as jchain
from limap_tpu.optimize.line_ba import LineBAConfig as JBA
from limap_tpu.optimize.line_ba import get_output_tracks as jout
from limap_tpu.optimize.line_ba import robust_weight as jrobust
from limap_tpu.optimize.line_ba import solve_line_bundle_adjustment as jba
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch import convert
from limap_tpu_torch.base.line_linker import LineLinker3dConfig
from limap_tpu_torch.merging.merging import (compact_track_batch,
                                             filter_chain_batch)
from limap_tpu_torch.optimize.line_ba import (LineBAConfig,
                                              get_output_tracks, robust_weight,
                                              solve_line_bundle_adjustment)
from limap_tpu_torch.testing.synthetic import build_scene
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

from test_torch_edge_cases import jax_collection

F2D = {"th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
       "th_sv_num_supports": 3, "th_overlap": 0.05,
       "th_overlap_num_supports": 3}


def noisy_scene(n_views=12, n_lines=64, n_neighbors=4, noise=0.1, seed=0):
    imagecols, segs, nbrs, gt = build_scene(n_views, n_lines, n_neighbors,
                                            seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    segs = {k: (v + rng.normal(0, noise, v.shape)).astype(np.float32)
            for k, v in segs.items()}
    return imagecols, segs, nbrs, gt


def unordered_endpoint_error(s1, e1, s2, e2):
    """Max endpoint error per segment with start/end allowed to swap
    (eigh fixes the aggregation axis only up to sign)."""
    same = np.maximum(np.abs(s1 - s2).max(-1), np.abs(e1 - e2).max(-1))
    swap = np.maximum(np.abs(s1 - e2).max(-1), np.abs(e1 - s2).max(-1))
    return np.minimum(same, swap)


@pytest.fixture(scope="module")
def stages():
    imagecols, segs, nbrs, _ = noisy_scene()
    jic = jax_collection(imagecols)
    cfg = dict(max_tris_per_node=32)
    jt = JTri(JCfg(**cfg))
    jt.init(segs, jic)
    jt.triangulate_all(nbrs)
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    pt.init(segs, imagecols)
    pt.triangulate_all(nbrs)
    _, outs, Tc = jt._dev_results
    I = len(imagecols.images)
    tables = (np.concatenate([np.asarray(o[1]) for o in outs])[:I],
              np.concatenate([np.asarray(o[2]) for o in outs])[:I])
    jtb, jhost = jt.compute_track_batch(return_host=True)
    ptb = pt.compute_track_batch()
    return dict(jic=jic, imagecols=imagecols, jt=jt, pt=pt, tables=tables,
                jtb=jtb, jhost=jhost, ptb=ptb)


def test_triangulate_all_edge_tables_identical(stages):
    jf, ji = stages["tables"]
    pf, pi, _ = stages["pt"]._tables()
    np.testing.assert_array_equal(pi.numpy(), ji)


def test_triangulate_all_best_lines_and_scores_close(stages):
    jf, _ = stages["tables"]
    pf = stages["pt"]._tables()[0].numpy()
    # best score: sums of exp-decay scores in [0, K - 1]
    np.testing.assert_allclose(pf[..., 9], jf[..., 9], atol=1e-3)
    # best lines and depths: two-view triangulation over 0.1-0.4 m
    # baselines at ~12 m depth amplifies last-ulp ray differences; 5 mm
    # is 4e-4 of the depth
    np.testing.assert_allclose(pf[..., :8], jf[..., :8], atol=5e-3)
    np.testing.assert_allclose(pf[..., 8], jf[..., 8], rtol=1e-4)


def test_compute_track_batch_identical_supports(stages):
    j, p = stages["jtb"], stages["ptb"]
    assert int(p.track_mask.sum()) == int(np.asarray(j.track_mask).sum()) > 40
    for f in ("img_index", "image_ids", "line_ids", "mask", "track_mask"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    err = unordered_endpoint_error(
        p.line.start.numpy(), p.line.end.numpy(),
        np.asarray(j.line.start), np.asarray(j.line.end))
    # aggregated from the supports above: TLS over triangulated endpoints
    # that agree to 5 mm
    assert err.max() < 5e-3, err.max()


@pytest.fixture(scope="module")
def filtered(stages):
    jviews = stages["jic"].batch()
    views = stages["imagecols"].batch("cpu")
    jtb, jhost = jchain(stages["jtb"], jviews, F2D, JL3(),
                        host=stages["jhost"])
    ptb, phost = filter_chain_batch(
        convert.track_batch(stages["jtb"], "cpu"), views, F2D,
        LineLinker3dConfig(), host=convert.host_track_batch(stages["jhost"]))
    jc, jch = jcompact(jhost.refresh(jtb, with_line=True), return_host=True)
    pc, pch = compact_track_batch(phost.refresh(ptb, with_line=True),
                                  return_host=True, device="cpu")
    return dict(jviews=jviews, views=views, jtb=jtb, ptb=ptb, jc=jc, pc=pc)


def test_filter_chain_identical_masks(filtered):
    j, p = filtered["jtb"], filtered["ptb"]
    np.testing.assert_array_equal(p.track_mask.numpy(),
                                  np.asarray(j.track_mask))
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
    assert 0 < int(p.track_mask.sum()) < p.track_mask.shape[0]


def test_compact_track_batch_identical(filtered):
    j, p = filtered["jc"], filtered["pc"]
    for f in ("img_index", "image_ids", "line_ids", "mask", "track_mask"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    err = unordered_endpoint_error(
        p.line.start.numpy(), p.line.end.numpy(),
        np.asarray(j.line.start), np.asarray(j.line.end))
    # re-aggregated from identical supports: fp32 TLS
    assert err.max() < 1e-3, err.max()


def test_line_ba_final_lines_close(filtered):
    jb = filtered["jc"]
    pb = convert.track_batch(jb, "cpu")
    jr, jres = jba(jb, filtered["jviews"], JBA(max_num_iterations=20))
    jl = jout(jb, filtered["jviews"], jr, 2).line
    pr, pres = solve_line_bundle_adjustment(
        pb, filtered["views"], LineBAConfig(max_num_iterations=20))
    pl = get_output_tracks(pb, filtered["views"], pr, 2).line
    ok = np.asarray(jb.track_mask)
    err = unordered_endpoint_error(
        pl.start.numpy()[ok], pl.end.numpy()[ok],
        np.asarray(jl.start)[ok], np.asarray(jl.end)[ok])
    # the LM accept test new_cost < cost branches differently under
    # rounding once the cost is flat, so the iterations differ; the final
    # lines agree to 1 cm at ~12 m, the costs to 1e-3 + 1 %
    assert err.max() < 1e-2, err.max()
    np.testing.assert_allclose(pres.cost.numpy()[ok],
                               np.asarray(jres.cost)[ok], rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(pres.cost0.numpy()[ok],
                               np.asarray(jres.cost0)[ok], rtol=1e-3,
                               atol=1e-4)


def test_get_output_tracks_on_reference_lines(filtered):
    """The re-trim alone, fed the reference's refined lines: no LM
    flips, so only fp32 rounding of the unprojections remains."""
    jb = filtered["jc"]
    jr, _ = jba(jb, filtered["jviews"], JBA(max_num_iterations=20))
    jl = jout(jb, filtered["jviews"], jr, 2).line
    pl = get_output_tracks(convert.track_batch(jb, "cpu"), filtered["views"],
                           convert.minimal_lines(jr, "cpu"), 2).line
    ok = np.asarray(jb.track_mask)
    # endpoints ~12 m away from the cameras: 1e-4 relative
    np.testing.assert_allclose(pl.start.numpy()[ok],
                               np.asarray(jl.start)[ok], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pl.end.numpy()[ok], np.asarray(jl.end)[ok],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "huber"])
def test_robust_weight(loss):
    r2 = np.geomspace(1e-6, 1e3, 50).astype(np.float32)
    np.testing.assert_allclose(
        robust_weight(torch.as_tensor(r2), loss, 0.25).numpy(),
        np.asarray(jrobust(r2, loss, 0.25)), rtol=1e-6)
    with pytest.raises(ValueError):
        robust_weight(torch.as_tensor(r2), "tukey", 0.25)
