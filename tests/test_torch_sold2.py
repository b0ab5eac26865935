"""The port's SOLD2 network against the JAX package on the CPU: the same
parameters (the reference's seeded draw, which the port repeats) and the
same numpy images through both, the JAX convolutions at HIGHEST
precision (its default on this CPU build rounds the products more
coarsely).  Tolerance: every output map within 1e-4 of its largest
magnitude (fp32 convolutions summed in other orders through ~80 layers).

Also the checkpoint layout: the port's module ``state_dict`` has the
published names, a ``sold2_wireframe.tar``-layout file loads in both
packages, and the loader refuses a missing or misshapen entry."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from limap_tpu.line2d.sold2 import nets as ref_nets
from limap_tpu.line2d.sold2 import sold2 as ref_sold2
from limap_tpu_torch import convert
from limap_tpu_torch.line2d.sold2 import nets, sold2
from torch_threads import two_torch_threads  # noqa: F401

MAP_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    ref_nets.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    ref_nets.set_conv_precision(None)


@pytest.fixture(scope="module")
def params():
    return ref_nets.init_params(0)


def test_init_params_repeat_the_reference_draw(params):
    got = nets.init_params(0)
    ref = convert.sold2_state_dict({k: np.asarray(v)
                                    for k, v in params.items()})
    assert set(got) == set(ref) == {k for k, _ in nets._spec()}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_state_dict_has_the_published_names():
    net = nets.SOLD2Net()
    names = {k for k in net.state_dict()
             if not k.endswith("num_batches_tracked")}
    assert names == {k for k, _ in nets._spec()}
    for k, shape in nets._spec():
        assert tuple(net.state_dict()[k].shape) == shape, k


def test_forward_matches_jax_at_128(params):
    img = np.random.default_rng(0).random((1, 128, 128, 1)).astype(
        np.float32)
    ref = ref_nets.sold2_forward(params, jnp.asarray(img))
    net = nets.build_net(nets.init_params(0), "cpu")
    got = nets.sold2_forward(net, torch.as_tensor(img))
    for key, shape in (("junctions", (1, 16, 16, 65)),
                       ("heatmap", (1, 128, 128, 2)),
                       ("descriptors", (1, 32, 32, 128))):
        a, b = np.asarray(ref[key]), got[key].numpy()
        assert a.shape == b.shape == shape
        np.testing.assert_allclose(b, a, atol=MAP_RTOL * np.abs(a).max())


@pytest.mark.parametrize("size", [(5, 7, 11, 13), (8, 6, 16, 12)])
def test_resize_and_pixel_shuffle_equal_jax(size):
    h, w, oh, ow = size
    x = np.random.default_rng(h).normal(size=(1, h, w, 12)).astype(
        np.float32)
    assert np.array_equal(
        nets.resize_nearest_torch(torch.as_tensor(x), oh, ow).numpy(),
        np.asarray(ref_nets.resize_nearest_torch(jnp.asarray(x), oh, ow)))
    assert np.array_equal(
        nets.pixel_shuffle_nhwc(torch.as_tensor(x), 2).numpy(),
        np.asarray(ref_nets.pixel_shuffle_nhwc(jnp.asarray(x), 2)))


def test_checkpoint_layout_loads_in_both(tmp_path):
    sd = nets.init_params(3)
    path = str(tmp_path / "sold2_wireframe.tar")
    torch.save({"model_state_dict": dict(
        sd, **{"backbone_net.net.bn1.num_batches_tracked":
               torch.tensor(7)})}, path)
    ref = ref_sold2.SOLD2Engine(weight_path=path)
    port = sold2.SOLD2Engine(weight_path=path, device="cpu")
    for k, v in convert.sold2_state_dict(
            {k: np.asarray(v) for k, v in ref.params.items()}).items():
        assert torch.equal(port.net.state_dict()[k], v), k
    bad = dict(sd)
    del bad["descriptor_decoder.convPb.bias"]
    with pytest.raises(KeyError, match="descriptor_decoder.convPb.bias"):
        nets.load_torch_state_dict(bad)
    bad = dict(sd, **{"junction_decoder.convPb.weight":
                      torch.zeros(64, 256, 1, 1)})
    with pytest.raises(ValueError, match="junction_decoder.convPb.weight"):
        nets.load_torch_state_dict(bad)
