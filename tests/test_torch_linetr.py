"""The port's LineTR against the JAX package on the CPU.

The tokenizer (equal), the float64 descriptor sampler (1e-12), the
network on the same tokens (1e-5: fp32 products in other orders through
8 attention layers), the extractor end to end on two rendered views
with the same SuperPoint weights (1e-3: OpenCV's uint8 resize to 640 x
480 and util/cv2_ops' differ by a grey level here and there, which
moves SuperPoint's maps), and the matcher on the same descriptors
(equal match lists).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import linetr as J
from limap_tpu_torch import convert
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.line2d import linetr as P
from limap_tpu_torch.testing import pipeline, zoo
from torch_threads import two_torch_threads  # noqa: F401

FORWARD_TOL = 1e-5
UINT8_TOL = 1e-3


@pytest.fixture(scope="module")
def sp_weights(tmp_path_factory):
    from limap_tpu.point2d.superpoint import SuperPoint
    path = tmp_path_factory.mktemp("sp") / "superpoint_v1.pth"
    torch.save(convert.superpoint_state_dict(
        jax.device_get(SuperPoint().params)), path)
    return str(path)


@pytest.fixture(scope="module")
def views():
    scene = pipeline.build_scene(n_views=2, hw=(120, 160))
    return ([scene[1][k] for k in (0, 1)],
            [zoo.noisy_segments(scene, k)[:24] for k in (0, 1)])


@pytest.fixture(scope="module")
def extractors(sp_weights):
    je = J.LineTRExtractor({"sp_weight_path": sp_weights})
    pe = get_extractor({"method": "linetr", "sp_weight_path": sp_weights},
                       device="cpu")
    return je, pe


def test_weights_tokens_and_sampler_match_jax(views):
    ref_params = J.init_params(0)
    for k, v in P.init_params(0).items():
        assert np.array_equal(v.numpy(), np.asarray(ref_params[k])), k
    segs = views[1][0]
    klines = segs[:, :4].reshape(-1, 2, 2) * [4.0, 4.0]
    ref = J.tokenize(klines, 8.0, 21, (480, 640))
    got = P.tokenize(klines, 8.0, 21, (480, 640))
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    grid = np.random.default_rng(0).normal(size=(60, 80, 256)).astype(
        np.float32)
    np.testing.assert_allclose(
        P.sample_dense_descriptors(torch.as_tensor(grid), ref[1]).numpy(),
        J.sample_dense_descriptors(grid, ref[1]), atol=1e-12)


def test_forward_matches_jax(views):
    segs = views[1][0]
    klines = segs[:, :4].reshape(-1, 2, 2) * [4.0, 4.0]
    slines, tokens, masks, resp, ang, _ = J.tokenize(klines, 8.0, 21,
                                                     (480, 640))
    rng = np.random.default_rng(1)
    desc = rng.normal(size=tokens.shape[:2] + (256,))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    score = rng.random(tokens.shape[:2] + (1,))
    sl, tk = J.normalize_keylines(slines, tokens, (480, 640))
    args = [np.asarray(a, np.float32) for a in
            (sl, resp, ang, tk, desc, score, masks)]
    ref = np.asarray(J.linetr_forward(J.init_params(0),
                                      *(jnp.asarray(a) for a in args)))
    net = P.load_torch_state_dict(convert.linetr_state_dict(
        J.init_params(0)))
    got = P.linetr_forward(net, *(torch.as_tensor(a) for a in args))
    assert got.shape == ref.shape == (len(slines), 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=FORWARD_TOL)


def test_extract_and_match_end_to_end(views, extractors):
    je, pe = extractors
    imgs, segs = views
    ref = [je.compute_descinfo(i, s) for i, s in zip(imgs, segs)]
    got = [pe.compute_descinfo(i, s) for i, s in zip(imgs, segs)]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["line_descriptors"],
                                   r["line_descriptors"], atol=UINT8_TOL)
        assert np.array_equal(g["mat_klines2sublines"],
                              r["mat_klines2sublines"])
    for topk in (0, 2):
        a = J.LineTRMatcher(je, {"topk": topk}).match_pair(*ref)
        b = get_matcher({"method": "linetr", "topk": topk}, pe,
                        device="cpu").match_pair(*ref)
        assert np.array_equal(a, b), topk
