"""The host merging strategies ("avg", "exhaustive") against the JAX
package: the union-find loops on the same edges, and the triangulator's
host clustering path with each strategy."""

import numpy as np
import pytest

from limap_tpu.base.line_linker import LineLinker3dConfig as JL3
from limap_tpu.merging import strategies as jstrat
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch.base.line_linker import LineLinker3dConfig as PL3
from limap_tpu_torch.merging import strategies as pstrat
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

from test_torch_edge_cases import jax_collection
from test_torch_exhaustive import _line_err, _supports
from test_torch_stages import noisy_scene


def _strategy_inputs(seed):
    """6 groups of 5 nearly collinear 3D lines, edges within and across
    groups with random scores."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(6):
        s = rng.normal(size=3) * 3 + np.array([0, 0, 10.0])
        d = rng.normal(size=3)
        for _ in range(5):
            jit = rng.normal(size=(2, 3)) * rng.choice([0.002, 0.05, 0.5])
            lines.append(np.stack([s, s + d]) + jit)
    lines = np.asarray(lines, np.float32)
    n = len(lines)
    a = rng.integers(0, n, 120)
    b = (a + rng.integers(1, 5, 120)) % n
    edges = np.unique(np.sort(np.stack([a, b], 1), 1), axis=0)
    scores = rng.uniform(0.1, 1.0, len(edges)).astype(np.float32)
    return edges, scores, lines, np.arange(n) % 7


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["compute_track_labels_avg",
                                  "compute_track_labels_exhaustive"])
def test_strategies_match_jax(seed, name):
    edges, scores, lines, img = _strategy_inputs(seed)
    cfg = dict(th_angle=10.0, th_perp=0.05)
    want = getattr(jstrat, name)(edges, scores, lines, img, JL3(**cfg))
    got = getattr(pstrat, name)(edges, scores, lines, img, PL3(**cfg))
    np.testing.assert_array_equal(got, np.asarray(want))
    # some merges are refused and some accepted
    assert 2 <= len(set(got[got >= 0].tolist())) < len(lines) // 2


@pytest.mark.parametrize("strategy", ["avg", "exhaustive"])
def test_triangulator_strategies_match_jax(strategy):
    """The host clustering path with each strategy on the matcher path:
    JAX's tracks but the one JAX makes of all the nodes the strategy left
    alone (they share one label there); the port leaves those nodes out,
    as the reference does."""
    imagecols, segs, nbrs, _ = noisy_scene(n_views=8, n_lines=40,
                                           n_neighbors=4, noise=0.2, seed=5)
    cfg = dict(max_tris_per_node=8, merging_strategy=strategy)
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    jt = JTri(JCfg(**cfg))
    pt.init(segs, imagecols)
    jt.init(segs, jax_collection(imagecols))
    pt.triangulate_all(nbrs)
    jt.triangulate_all(nbrs)
    ptr = {_supports(t): t for t in pt.compute_line_tracks()}
    jtr = {_supports(t): t for t in jt.compute_line_tracks()}
    assert len(ptr) > 10
    L = pt.L
    lone = [s for s in jtr if s not in ptr]
    assert len(lone) <= 1, lone
    for s in lone:
        # JAX's track of the strategy's singletons: label I * L - 1
        labels = jt._cluster_labels()[0]
        nodes = [pt.id2idx[i] * L + a for i, a in s]
        assert (labels[nodes] == len(imagecols.images) * L - 1).all()
    for s, t in ptr.items():
        assert s in jtr
        assert _line_err(t.line, jtr[s].line) < 5e-3


