"""The port's point front end (SuperPoint, the descriptor sampler, the
Sinkhorn solver and matcher) against the JAX package on the CPU: the
same numpy inputs through both, the reference's SuperPoint parameters
carried across by ``convert.superpoint_state_dict``.

Tolerances: the SuperPoint forward pass (semi, desc) within 1e-5 (fp32
convolutions summed in other orders); the descriptor sampler within 1e-6
(the same formula, a different summation order of the norm); the
Sinkhorn log assignment within 1e-5 absolute (fp32 logsumexp over rows
and columns in other orders, values up to ~25).  Keypoints are compared
as sets, a keypoint on one side only excused where its score lies within
float32 rounding (KP_TIE) of a neighbour's in its NMS window, of the
threshold or of the top-k cut; matches likewise where the assignment's
two best entries of a row or column lie within MATCH_TIE."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from limap_tpu.point2d import matching as ref_matching
from limap_tpu.point2d import superpoint as ref_sp
from limap_tpu_torch import convert
from limap_tpu_torch.point2d import matching, superpoint
from limap_tpu_torch.testing import pipeline
from torch_threads import two_torch_threads  # noqa: F401

FWD_TOL = 1e-5
SAMPLE_TOL = 1e-6
SINKHORN_TOL = 1e-5
KP_TIE = 1e-6
MATCH_TIE = 1e-5


@pytest.fixture(scope="module")
def nets():
    ref = ref_sp.SuperPoint(max_keypoints=400, keypoint_threshold=1e-3)
    port = superpoint.SuperPoint(max_keypoints=400, keypoint_threshold=1e-3,
                                 device="cpu")
    port.net.load_state_dict(convert.superpoint_state_dict(
        jax.tree_util.tree_map(np.asarray, ref.params)))
    return ref, port


@pytest.fixture(scope="module")
def image():
    return pipeline.build_scene(n_views=1, hw=(120, 160))[1][0]


def test_forward_pass_matches_jax(nets):
    ref, port = nets
    x = np.random.default_rng(0).random((1, 64, 80, 1)).astype(np.float32)
    semi_j, desc_j = ref.net.apply(ref.params, jnp.asarray(x))
    with torch.no_grad():
        semi_t, desc_t = port.net(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(semi_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(semi_j), atol=FWD_TOL)
    np.testing.assert_allclose(desc_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(desc_j), atol=FWD_TOL)


def _ties(missing, heat, threshold, radius, cut):
    out = []
    for x, y in missing:
        v = heat[y, x]
        win = heat[max(y - radius, 0):y + radius + 1,
                   max(x - radius, 0):x + radius + 1].copy()
        win[min(y, radius), min(x, radius)] = -np.inf
        out.append(win.max() >= v - KP_TIE or abs(v - threshold) <= KP_TIE
                   or abs(v - cut) <= KP_TIE)
    return out


def test_keypoints_as_sets_and_dense_outputs(nets, image):
    ref, port = nets
    oj, ot = ref(image), port(image)
    dj, dt = ref.dense(image), port.dense(image)
    np.testing.assert_allclose(dt["dense_score"], dj["dense_score"],
                               atol=FWD_TOL)
    np.testing.assert_allclose(dt["dense_descriptor"],
                               dj["dense_descriptor"], atol=FWD_TOL)
    kj = set(map(tuple, oj["keypoints"].astype(int).tolist()))
    kt = set(map(tuple, ot["keypoints"].astype(int).tolist()))
    assert len(kj) > 100
    cut = float(oj["scores"][-1])
    for missing, heat in ((kj - kt, dj["dense_score"]),
                          (kt - kj, dt["dense_score"])):
        assert all(_ties(sorted(missing), heat, ref.keypoint_threshold,
                         ref.nms_radius, cut))
    common = {tuple(p): i for i, p in enumerate(
        ot["keypoints"].astype(int).tolist())}
    for i, p in enumerate(oj["keypoints"].astype(int).tolist()):
        if tuple(p) in common:
            j = common[tuple(p)]
            np.testing.assert_allclose(ot["descriptors"][j],
                                       oj["descriptors"][i], atol=FWD_TOL)
            assert ot["scores"][j] == pytest.approx(oj["scores"][i],
                                                    abs=FWD_TOL)


def test_keypoint_order_is_by_score_then_raster():
    """The port's top-k is a stable sort of the scores: among equal
    scores the raster (row-major) order of np.nonzero stays."""
    sp = superpoint.SuperPoint(max_keypoints=3, keypoint_threshold=0.0,
                               device="cpu")
    heat = torch.zeros(16, 16)
    for y, x in ((2, 12), (9, 3), (13, 13), (5, 5)):
        heat[y, x] = 0.5
    sp._forward = lambda img: (heat, torch.zeros(2, 2, 256))
    out = sp(np.zeros((16, 16), np.uint8))
    assert out["keypoints"].tolist() == [[12, 2], [5, 5], [3, 9]]


@pytest.mark.parametrize("radius", [1, 4])
def test_simple_nms_matches_jax(radius):
    rng = np.random.default_rng(radius)
    s = rng.random((2, 30, 40)).astype(np.float32)
    s[0, 10, 10:13] = 2.0          # ties on a plateau all stay
    ref = np.asarray(ref_sp.simple_nms(jnp.asarray(s), radius))
    got = superpoint.simple_nms(torch.as_tensor(s), radius).numpy()
    assert np.array_equal(got, ref)


def test_sample_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(15, 20, 256)).astype(np.float32)
    kps = np.concatenate([
        rng.uniform(0, [160, 120], (64, 2)),
        [[0, 0], [159.5, 119.5], [-4.0, 3.0], [170.0, 130.0], [4.0, 4.0]],
    ]).astype(np.float32)
    ref = np.asarray(ref_sp.sample_descriptors(jnp.asarray(grid),
                                               jnp.asarray(kps)))
    got = superpoint.sample_descriptors(torch.as_tensor(grid),
                                        torch.as_tensor(kps)).numpy()
    np.testing.assert_allclose(got, ref, atol=SAMPLE_TOL)


@pytest.mark.parametrize("iters", [50, 100])
@pytest.mark.parametrize("M,N", [(7, 11), (64, 80), (1, 9), (30, 1),
                                 (200, 150)])
def test_log_sinkhorn_matches_jax(M, N, iters):
    rng = np.random.default_rng(M * N + iters)
    s = (rng.normal(size=(M, N)) * 3).astype(np.float32)
    ref = np.asarray(ref_matching.log_sinkhorn(jnp.asarray(s),
                                               jnp.asarray(0.7), iters))
    got = matching.log_sinkhorn(s, 0.7, iters, device="cpu")
    assert got.shape == (M + 1, N + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=SINKHORN_TOL)


def _match_ties(P, i, j):
    """Row i's or column j's two best entries within MATCH_TIE."""
    row = np.sort(P[i])[-2:]
    col = np.sort(P[:, j])[-2:]
    return row[1] - row[0] <= MATCH_TIE or col[1] - col[0] <= MATCH_TIE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinkhorn_match_equals_jax_up_to_near_ties(seed):
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(40, 32))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = d1[rng.permutation(40)[:35]] + rng.normal(size=(35, 32)) * 0.1
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    ref = ref_matching.sinkhorn_match(d1, d2)
    got = matching.sinkhorn_match(d1, d2, device="cpu")
    a, b = set(map(tuple, ref.tolist())), set(map(tuple, got.tolist()))
    assert len(a) >= 25
    Z = np.asarray(ref_matching.log_sinkhorn(
        jnp.asarray((d1 @ d2.T / 0.1).astype(np.float32)), jnp.asarray(0.5),
        50))
    P = np.exp(Z[:-1, :-1])
    assert all(_match_ties(P, i, j) for i, j in a ^ b)
    assert matching.sinkhorn_match(np.zeros((0, 4)), d2,
                                   device="cpu").shape == (0, 2)


def test_superpoint_checkpoint_layout_loads_in_both(tmp_path, image):
    """A superpoint_v1.pth-layout file (the port's seeded random weights)
    loads in both packages and gives the same dense outputs."""
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(superpoint.random_state_dict(3), path)
    ref = ref_sp.SuperPoint(weight_path=path)
    port = superpoint.SuperPoint(weight_path=path, device="cpu")
    dj, dt = ref.dense(image), port.dense(image)
    np.testing.assert_allclose(dt["dense_score"], dj["dense_score"],
                               atol=FWD_TOL)
    np.testing.assert_allclose(dt["dense_descriptor"],
                               dj["dense_descriptor"], atol=FWD_TOL)
    sd = torch.load(path, weights_only=True)
    del sd["convDb.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="convDb.bias"):
        superpoint.SuperPoint(weight_path=path, device="cpu")
