"""The port's SuperGlue against the JAX package on the CPU: the full
architecture (keypoint encoder, 18 attentional layers, final projection)
from the same random parameters, carried across by
``convert.superglue_state_dict``.

The parameters are drawn with the fan-in scale and the descriptors are
unit vectors, as SuperPoint's are: the reference's own random draw
(unit-normal kernels) makes the 18 layers chaotic, where fp32 rounding
alone moves the scores by 1e-3 of their size.  Tolerances: raw scores
within 1e-4 of their largest magnitude (fp32 products over 18 layers in
other orders); the optimal transport within 1e-5 absolute; matches
equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limap_tpu.point2d import superglue as ref_sg
from limap_tpu_torch import convert
from limap_tpu_torch.point2d import superglue as sg
from limap_tpu_torch.testing.learned import superglue_random_state_dict
from torch_threads import two_torch_threads  # noqa: F401

SCORE_RTOL = 1e-4
OT_TOL = 1e-5


def random_inputs(seed, n0=24, n1=31, h=480, w=640):
    rng = np.random.default_rng(seed)

    def unit(n):
        d = rng.normal(size=(256, n))
        return (d / np.linalg.norm(d, axis=0)).astype(np.float32)

    return {"image_shape0": (h, w), "image_shape1": (h, w),
            "keypoints0": rng.uniform(0, w, (n0, 2)).astype(np.float32),
            "keypoints1": rng.uniform(0, w, (n1, 2)).astype(np.float32),
            "scores0": rng.uniform(size=n0).astype(np.float32),
            "scores1": rng.uniform(size=n1).astype(np.float32),
            "descriptors0": unit(n0), "descriptors1": unit(n1)}


@pytest.fixture(scope="module")
def pair():
    """(the JAX SuperGlue, the port's) on the same parameters."""
    sd = superglue_random_state_dict(5)
    ref = ref_sg.SuperGlue.__new__(ref_sg.SuperGlue)
    ref.params = {k: jnp.asarray(v) for k, v in
                  ref_sg.params_from_state_dict(
                      {k: v.numpy() for k, v in sd.items()}).items()}
    ref.match_threshold = ref_sg.MATCH_THRESHOLD
    ref.sinkhorn_iterations = ref_sg.SINKHORN_ITERATIONS
    port = sg.SuperGlue(device="cpu")
    port.params = sg.params_from_state_dict(convert.superglue_state_dict(
        {k: np.asarray(v) for k, v in ref.params.items()}))
    return ref, port


def test_key_spec_and_random_params_equal_jax():
    assert sg.key_spec() == ref_sg.key_spec()
    ref = ref_sg.random_params(3)
    got = sg.random_params(3)
    assert set(got) == set(ref)
    for k, v in convert.superglue_state_dict(ref).items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_scores_match_jax(pair, seed):
    ref, port = pair
    data = random_inputs(seed)
    a = np.asarray(ref.scores(data))
    b = port.scores(data).numpy()
    assert a.shape == b.shape == (24, 31)
    np.testing.assert_allclose(b, a, atol=SCORE_RTOL * np.abs(a).max())


def test_optimal_transport_and_matches_equal_jax(pair):
    ref, port = pair
    data = random_inputs(2, 40, 37)
    raw = np.asarray(ref.scores(data))
    Zj = np.asarray(ref.solve_optimal_transport(raw))
    Zt = port.solve_optimal_transport(torch.as_tensor(np.array(raw))).numpy()
    np.testing.assert_allclose(Zt, Zj, atol=OT_TOL)
    for a, b in zip(ref_sg.get_matches(Zj), sg.get_matches(Zt)):
        assert a.shape == b.shape
    mj, mt = ref_sg.get_matches(Zj), sg.get_matches(Zt)
    assert np.array_equal(mj[0], mt[0]) and np.array_equal(mj[1], mt[1])
    np.testing.assert_allclose(mt[2], mj[2], atol=OT_TOL)


def test_call_equals_jax_and_handles_empty(pair):
    ref, port = pair
    data = random_inputs(4, 30, 30)
    # the second image's keypoints a shuffled copy of the first's, so
    # there is something to match
    perm = np.random.default_rng(0).permutation(30)
    for k in ("keypoints", "scores"):
        data[k + "1"] = data[k + "0"][perm]
    data["descriptors1"] = data["descriptors0"][:, perm]
    a, b = ref(data), port(data)
    assert np.array_equal(a["matches0"], b["matches0"])
    assert np.array_equal(a["matches1"], b["matches1"])
    assert (b["matches0"] >= 0).sum() >= 10
    empty = dict(data, keypoints0=np.zeros((0, 2)), scores0=np.zeros(0),
                 descriptors0=np.zeros((256, 0)))
    out = port(empty)
    assert out["matches0"].shape == (0,) and (out["matches1"] == -1).all()


def test_strict_loader(tmp_path):
    sd = superglue_random_state_dict(0)
    good = str(tmp_path / "superglue_outdoor.pth")
    torch.save(dict(sd, **{"kenc.encoder.1.num_batches_tracked":
                           torch.tensor(0)}), good)
    params = sg.load_checkpoint(good)
    ref = ref_sg.load_checkpoint(good)
    for k, v in convert.superglue_state_dict(ref).items():
        assert torch.equal(params[k], v), k
    missing = dict(sd)
    del missing["gnn.layers.3.attn.merge.bias"]
    with pytest.raises(ValueError, match="missing=.*layers.3.attn.merge"):
        sg.params_from_state_dict(missing)
    misshapen = dict(sd, **{"final_proj.weight": torch.zeros(256, 128, 1)})
    with pytest.raises(ValueError, match="final_proj.weight: shape"):
        sg.params_from_state_dict(misshapen)
    extra = dict(sd, **{"gnn.layers.18.attn.merge.bias": torch.zeros(256)})
    with pytest.raises(ValueError, match="unexpected"):
        sg.params_from_state_dict(extra)


def test_normalize_keypoints_matches_jax():
    k = np.random.default_rng(1).uniform(0, 640, (10, 2)).astype(np.float32)
    a = np.asarray(ref_sg.normalize_keypoints(jnp.asarray(k), 480.0, 640.0))
    b = sg.normalize_keypoints(torch.as_tensor(k), 480.0, 640.0).numpy()
    np.testing.assert_allclose(b, a, atol=1e-7)
