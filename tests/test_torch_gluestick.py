"""The port's GlueStick against the JAX package on the CPU.

The seeded weights (the same numpy draw); the GNN on the same node
descriptors (1e-4: fp32 products in other orders through 27 attention
layers); the extractor end to end on a rendered view with the same
SuperPoint weights (junction descriptors 1e-5, scores 1e-6); the matcher
on a view against a shuffled copy of its lines, where the random
network matches lines to their copies: the same match lists, each line
matched to its copy (the OT on ops/log_sinkhorn.py's plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import gluestick as J
from limap_tpu_torch import convert
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.line2d import gluestick as P
from limap_tpu_torch.testing import pipeline, zoo
from torch_threads import two_torch_threads  # noqa: F401

GNN_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return J.init_params(0)


def test_weights_and_gnn_match_jax(params):
    for k, v in P.init_params(0).items():
        assert np.array_equal(v.numpy(), np.asarray(params[k])), k
    rng = np.random.default_rng(0)
    d0 = rng.normal(size=(256, 16)).astype(np.float32)
    d1 = rng.normal(size=(256, 20)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=0)
    d1 /= np.linalg.norm(d1, axis=0)
    a0 = J.GlueStickMatcher._adjacency(8)
    a1 = J.GlueStickMatcher._adjacency(10)
    ref = J.gluestick_gnn(params, jnp.asarray(d0), jnp.asarray(d1),
                          jnp.asarray(a0), jnp.asarray(a1))
    net = P.load_torch_state_dict(convert.gluestick_state_dict(params))
    assert np.array_equal(P.adjacency(8, "cpu").numpy(), a0)
    got = P.gluestick_gnn(net, torch.as_tensor(d0), torch.as_tensor(d1),
                          P.adjacency(8, "cpu"), P.adjacency(10, "cpu"))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=GNN_TOL * np.abs(r).max())


class _View:
    def __init__(self, img):
        self.img = img

    def read_image(self, set_gray=True):
        return self.img


def shuffled(info, seed=0):
    """A copy of a descinfo with its lines (and their endpoints' rows) in
    a shuffled order; returns (copy, expected: a line's copy)."""
    n = len(info["lines"])
    perm = np.random.default_rng(seed).permutation(n)
    rows = (2 * perm[:, None] + np.arange(2)).reshape(-1)
    copy = dict(info, lines=info["lines"][perm],
                junctions=info["junctions"][rows],
                junc_desc=info["junc_desc"][rows],
                junc_score=info["junc_score"][rows])
    expected = np.empty(n, np.int64)
    expected[perm] = np.arange(n)
    return copy, expected


def test_extract_and_match_end_to_end(params, tmp_path):
    from limap_tpu.point2d.superpoint import SuperPoint
    sp = tmp_path / "superpoint_v1.pth"
    torch.save(convert.superpoint_state_dict(
        jax.device_get(SuperPoint().params)), sp)
    scene = pipeline.build_scene(n_views=1, hw=(120, 160))
    img, segs = scene[1][0], zoo.noisy_segments(scene, 0)[:20]
    je = J.GlueStickExtractor({"sp_weight_path": str(sp)})
    pe = get_extractor({"method": "gluestick", "sp_weight_path": str(sp)},
                       device="cpu")
    ref = je.extract(_View(img), segs)
    got = pe.extract(_View(img), segs)
    for k in ("lines", "junctions", "image_shape"):
        assert np.array_equal(ref[k], got[k]), k
    np.testing.assert_allclose(got["junc_desc"], ref["junc_desc"], atol=1e-5)
    np.testing.assert_allclose(got["junc_score"], ref["junc_score"],
                               atol=1e-6)
    copy, expected = shuffled(ref)
    jm = J.GlueStickMatcher(je, {"topk": 0, "match_threshold": 0.01})
    pm = get_matcher({"method": "gluestick", "topk": 0,
                      "match_threshold": 0.01}, pe, device="cpu")
    pm.net = P.load_torch_state_dict(convert.gluestick_state_dict(params))
    a = jm.match_pair(ref, copy)
    b = pm.match_pair(ref, copy)
    assert len(a) >= 10
    assert np.array_equal(a, b)
    assert (expected[a[:, 0]] == a[:, 1]).all()
