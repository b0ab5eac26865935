"""The port's S2DNet against the JAX package's Flax module on the CPU:
JAX's random Flax parameters carried across by convert.s2dnet_state_dict,
the three adapted maps (1e-5 of their largest magnitude: fp32
convolutions in another order), jax.image.resize's bilinear upsampling
against F.interpolate(align_corners=False) at the edges (1e-6: both
renormalize to the edge texel), and the hypercolumns of an image whose
size is not a multiple of 4 (1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from limap_tpu.features import extractors as J
from limap_tpu_torch import convert
from limap_tpu_torch.features import extractors as P
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    ref = J.S2DNetExtractor()
    sd = convert.s2dnet_state_dict(jax.device_get(ref.params))
    return ref, P.S2DNetExtractor(device="cpu", state_dict=sd), sd


def test_carrier_names_every_layer(pair):
    _, _, sd = pair
    assert set(sd) == set(P.S2DNetBackbone().state_dict())
    assert sd["conv0_0.weight"].shape == (64, 1, 3, 3)
    assert sd["adap2.weight"].shape == (128, 256, 1, 1)


def test_backbone_maps_match_flax(pair):
    ref, port, _ = pair
    x = np.random.default_rng(0).random((1, 32, 48, 1)).astype(np.float32)
    want = ref.net.apply(ref.params, jnp.asarray(x))
    with torch.no_grad():
        got = port.net(torch.as_tensor(x).permute(0, 3, 1, 2))
    for a, g in zip(want, got):
        a = np.asarray(a)
        g = g.permute(0, 2, 3, 1).numpy()
        assert a.shape == g.shape
        np.testing.assert_allclose(g, a, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("factor", [2, 4])
def test_bilinear_upsampling_equals_jax_image_resize(factor):
    x = np.random.default_rng(factor).normal(size=(7, 9, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (7 * factor,
                                                        9 * factor, 3),
                                       "bilinear"))
    got = F.interpolate(torch.as_tensor(x).permute(2, 0, 1)[None],
                        size=(7 * factor, 9 * factor), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_extract_matches_jax(pair):
    ref, port, _ = pair
    img = (np.random.default_rng(1).random((50, 66)) * 255).astype(np.uint8)
    a = np.asarray(ref.extract(img))
    g = port.extract(img).numpy()
    assert a.shape == g.shape == (48, 64, 128)
    np.testing.assert_allclose(g, a, atol=1e-5)
