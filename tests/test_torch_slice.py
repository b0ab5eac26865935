"""The whole slice through its entry points, port against the JAX
package, on the bench-style scene of test_torch_stages: triangulate ->
tracks -> filters + remerge -> line BA -> GT evaluation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from limap_tpu.base.line_linker import LineLinker3dConfig as JL3
from limap_tpu.base.linetrack import batch_to_tracks as jto_tracks
from limap_tpu.base.lines import Segments as JSeg
from limap_tpu.evaluation.evaluator import PointCloudEvaluator as JEval
from limap_tpu.evaluation.evaluator import report_error_to_gt as jreport
from limap_tpu.merging.merging import compact_track_batch as jcompact
from limap_tpu.merging.merging import filter_chain_batch as jchain
from limap_tpu.optimize.line_ba import LineBAConfig as JBA
from limap_tpu.optimize.line_ba import get_output_tracks as jout
from limap_tpu.optimize.line_ba import solve_line_bundle_adjustment as jba
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch.base.line_linker import LineLinker3dConfig
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import batch_to_tracks
from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                  report_error_to_gt,
                                                  report_track_stats)
from limap_tpu_torch.merging.merging import (compact_track_batch,
                                             filter_chain_batch)
from limap_tpu_torch.optimize.line_ba import (LineBAConfig,
                                              get_output_tracks,
                                              solve_line_bundle_adjustment)
from limap_tpu_torch.testing.synthetic import build_scene, gt_point_cloud
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

from test_torch_edge_cases import jax_collection
from test_torch_stages import F2D, noisy_scene, unordered_endpoint_error

TAUS = (0.01, 0.05, 0.1)
N_SAMPLES = 200


def run_port(imagecols, segs, nbrs):
    tri = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=32),
                                 device="cpu")
    tri.init(segs, imagecols)
    tri.triangulate_all(nbrs)
    tb, host = tri.compute_track_batch(return_host=True)
    views = imagecols.batch("cpu")
    tb, host = filter_chain_batch(tb, views, F2D, LineLinker3dConfig(),
                                  host=host)
    tb, host = compact_track_batch(host.refresh(tb, with_line=True),
                                   return_host=True, device="cpu")
    cfg = LineBAConfig(max_num_iterations=20)
    refined, _ = solve_line_bundle_adjustment(tb, views, cfg)
    tb = get_output_tracks(tb, views, refined, cfg.num_outliers_aggregator)
    return [t for t in batch_to_tracks(tb, host=host) if t.count_lines() > 0]


def run_reference(imagecols, segs, nbrs):
    jic = jax_collection(imagecols)
    tri = JTri(JCfg(max_tris_per_node=32))
    tri.init(segs, jic)
    tri.triangulate_all(nbrs)
    tb, host = tri.compute_track_batch(return_host=True)
    views = jic.batch()
    tb, host = jchain(tb, views, F2D, JL3(), host=host)
    tb, host = jcompact(host.refresh(tb, with_line=True), return_host=True)
    cfg = JBA(max_num_iterations=20)
    refined, _ = jba(tb, views, cfg)
    tb = jout(tb, views, refined, cfg.num_outliers_aggregator)
    return [t for t in jto_tracks(tb, host=host) if t.count_lines() > 0]


def _key(t):
    return tuple(sorted(zip(t.image_id_list, t.line_id_list)))


@pytest.fixture(scope="module")
def slice_runs():
    imagecols, segs, nbrs, gt = noisy_scene()
    return (run_port(imagecols, segs, nbrs),
            run_reference(imagecols, segs, nbrs), gt)


def test_same_tracks_and_supports(slice_runs):
    port, ref, _ = slice_runs
    assert len(port) == len(ref) > 30
    assert sorted(map(_key, port)) == sorted(map(_key, ref))
    pm = {_key(t): t.line for t in port}
    rm = {_key(t): t.line for t in ref}
    a = np.stack([pm[k] for k in rm])
    b = np.stack([rm[k] for k in rm])
    err = unordered_endpoint_error(a[:, 0], a[:, 1], b[:, 0], b[:, 1])
    # the tolerance of the line-BA stage test (LM accept flips)
    assert err.max() < 1e-2, err.max()


def test_recall_and_precision_match(slice_runs):
    port, ref, gt = slice_runs
    cloud = gt_point_cloud(gt, 100)
    pl = np.stack([t.line for t in port])
    rl = np.stack([t.line for t in ref])
    p = report_error_to_gt(PointCloudEvaluator(cloud, device="cpu"), pl, TAUS,
                           N_SAMPLES)
    r = jreport(JEval(cloud), rl, TAUS, N_SAMPLES)
    for tau in TAUS:
        # lines within 1 cm of each other: a sample within tau of the
        # cloud for one package may fall just outside for the other.
        # 1 % of the recalled length (metres) and 1 point of precision
        np.testing.assert_allclose(p["recall"][tau], r["recall"][tau],
                                   rtol=1e-2)
        assert abs(p["precision"][tau] - r["precision"][tau]) <= 1.0
    assert p["recall"][0.1] > 0.5 * np.linalg.norm(
        gt[:, 1] - gt[:, 0], axis=1).sum()
    # the per-line ratio at one tau, each package on its own lines
    p32 = torch.as_tensor(pl, dtype=torch.float32)
    pr = PointCloudEvaluator(cloud, device="cpu").ComputeInlierRatio(
        Segments(p32[:, 0], p32[:, 1]), 0.05, N_SAMPLES)
    assert abs(float(pr.mean()) - float(np.mean(np.asarray(
        JEval(cloud).ComputeInlierRatio(JSeg(jnp.asarray(rl[:, 0]),
                                             jnp.asarray(rl[:, 1])),
                                        0.05, N_SAMPLES))))) <= 1e-2
    stats = report_track_stats(port)
    assert stats["n_tracks"] == len(port)
    assert stats["n_tracks_nv4"] > 0


def test_scene_matches_bench_scene():
    """The port's synthetic scene (chip_smoke.py drives it) is
    bench.py::build_scene: same poses, matches and (fp32) projections."""
    imagecols, segs, nbrs, _ = build_scene(10, 50, 4, device="cpu")
    jic, jsegs, jnbrs = bench.build_scene(10, 50, 4)
    for i in jic.images:
        np.testing.assert_allclose(imagecols.images[i].pose.qvec,
                                   jic.images[i].pose.qvec, atol=1e-7)
        np.testing.assert_array_equal(imagecols.images[i].pose.tvec,
                                      jic.images[i].pose.tvec)
    assert nbrs.keys() == jnbrs.keys()
    for i in nbrs:
        assert nbrs[i].keys() == jnbrs[i].keys()
        # projections at f = 600 px: fp32 rounding
        np.testing.assert_allclose(segs[i], jsegs[i], atol=1e-3)
