"""The port's DeepLSD against the JAX package on the CPU: the seeded
weights (the same numpy draw), the forward at 64 x 96 with JAX's
convolutions at HIGHEST precision (fields within 1e-4 of their largest
magnitude: fp32 convolutions summed in other orders), the field
extraction on synthetic distance and angle fields (segments equal as
sets within 0.05 px, at most a tenth unmatched: a component on a
threshold may pass in one package only), the detector end to end on a
rendered view, and the checkpoint loader."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import deeplsd as J
from limap_tpu.line2d.sold2 import nets as ref_nets
from limap_tpu_torch import convert
from limap_tpu_torch.line2d import deeplsd as P
from limap_tpu_torch.line2d import get_detector

from test_torch_tpu_lsd import unmatched
from torch_threads import two_torch_threads  # noqa: F401

MAP_RTOL = 1e-4
ENDPOINT_TOL = 0.05
MAX_UNMATCHED_SHARE = 0.1


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    ref_nets.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    ref_nets.set_conv_precision(None)


@pytest.fixture(scope="module")
def params():
    return J.init_params(0)


def synthetic_fields(H=120, W=160, seed=0):
    """A distance field to 6 random segments and the angle of the nearest
    one (mod pi)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    p = np.stack([xx, yy], -1)
    best = np.full((H, W), np.inf)
    ang = np.zeros((H, W))
    for _ in range(6):
        a = rng.uniform([10, 10], [W - 10, H - 10])
        b = rng.uniform([10, 10], [W - 10, H - 10])
        d = b - a
        t = np.clip(((p - a) @ d) / (d @ d), 0, 1)
        dist = np.linalg.norm(p - (a + t[..., None] * d), axis=-1)
        closer = dist < best
        best = np.where(closer, dist, best)
        ang = np.where(closer, np.arctan2(d[1], d[0]) % np.pi, ang)
    return best.astype(np.float32), ang.astype(np.float32)


def test_init_params_repeat_the_reference_draw(params):
    got = P.init_params(0)
    ref = convert.deeplsd_state_dict(params)
    assert set(got) == set(ref) == {k for k, _ in P._spec()}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert set(P.DeepLSDNet().state_dict()) == set(ref)


def test_forward_matches_jax(params):
    img = np.random.default_rng(1).random((1, 64, 96, 1)).astype(np.float32)
    ref = J.deeplsd_forward(params, jnp.asarray(img))
    net = P.load_torch_state_dict(convert.deeplsd_state_dict(params))
    got = P.deeplsd_forward(net, torch.as_tensor(img))
    for k in ("df", "angle"):
        a = np.asarray(ref[k])
        assert got[k].shape == a.shape == (1, 64, 96)
        np.testing.assert_allclose(got[k].numpy(), a,
                                   atol=MAP_RTOL * np.abs(a).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_from_fields_matches_jax(seed):
    df, ang = synthetic_fields(seed=seed)
    rs, rn = J.extract_from_fields(jnp.asarray(df), jnp.asarray(ang))
    ps, pn = P.extract_from_fields(torch.as_tensor(df), torch.as_tensor(ang))
    a = np.asarray(rs)[:int(rn)]
    b = ps.numpy()[:int(pn)]
    assert len(a) >= 6
    assert abs(len(a) - len(b)) <= MAX_UNMATCHED_SHARE * len(a)
    assert unmatched(a, b, ENDPOINT_TOL) <= MAX_UNMATCHED_SHARE * len(a)
    assert unmatched(b, a, ENDPOINT_TOL) <= MAX_UNMATCHED_SHARE * len(b)


def test_detector_end_to_end_and_checkpoint(params, tmp_path):
    """Both detectors from one checkpoint file in the published place
    under a weights directory, on the same image: the fields, then each
    package's extraction from JAX's fields."""
    from limap_tpu_torch.testing import pipeline
    img = pipeline.build_scene(n_views=1, hw=(96, 128))[1][0]
    path = tmp_path / "line2d" / "DeepLSD" / "deeplsd_md.tar"
    os.makedirs(path.parent)
    torch.save({"model": convert.deeplsd_state_dict(params)}, path)
    jd = J.DeepLSDDetector({"weight_path": str(tmp_path)})
    pd = get_detector({"method": "deeplsd"}, weight_path=str(tmp_path),
                      device="cpu")
    x = np.zeros((1, 96, 128, 1), np.float32)
    x[0, ..., 0] = img / 255.0
    ref = jd._forward(jd.params, jnp.asarray(x))
    df, ang = pd.fields(img)
    for k, got in (("df", df), ("angle", ang)):
        a = np.asarray(ref[k])[0]
        np.testing.assert_allclose(got.numpy(), a,
                                   atol=MAP_RTOL * np.abs(a).max())
    a = np.asarray(J.extract_from_fields(ref["df"][0], ref["angle"][0])[0])
    b = P.segments_from_fields(torch.as_tensor(np.asarray(ref["df"][0])),
                               torch.as_tensor(np.asarray(ref["angle"][0])))
    a = a[a[:, 4] > 0]
    assert abs(len(a) - len(b)) <= MAX_UNMATCHED_SHARE * max(len(a), 1)
    assert unmatched(b, a, ENDPOINT_TOL) <= MAX_UNMATCHED_SHARE * max(
        len(b), 1)
    assert pd.detect_array(img).shape[1] == 5


def test_loader_refuses_a_missing_or_misshapen_entry():
    sd = P.init_params(0)
    bad = dict(sd)
    del bad["df_head.2.bias"]
    with pytest.raises(ValueError, match="missing df_head.2.bias"):
        P.load_torch_state_dict(bad)
    bad = dict(sd, **{"df_head.2.weight": torch.zeros(1, 64, 3, 3)})
    with pytest.raises(ValueError, match="df_head.2.weight: got"):
        P.load_torch_state_dict(bad)
