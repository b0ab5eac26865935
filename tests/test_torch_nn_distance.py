"""The port's nearest-neighbour distance (plain version, the one CPU
tensors take) against the JAX Pallas kernel in interpret mode, the JAX
evaluator's XLA version and an f64 numpy reference.  The CUDA kernel is
held to the plain version on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.evaluation.evaluator import _min_dist_to_points
from limap_tpu.ops.pallas.nn_distance import min_dist_pallas
from limap_tpu_torch.ops import cuda_build
from limap_tpu_torch.ops.nn_distance import nn_min_dist, nn_min_dist_plain
from torch_threads import two_torch_threads  # noqa: F401

# (S, M): ragged sizes, none a multiple of the TPU tiles (256 x 1024) or
# of the CUDA kernel's 256 threads / 2048-point tiles; M below one tile;
# S = 1
SIZES = [(1, 5), (70, 300), (257, 1025), (513, 2049), (33, 4097)]


def _inputs(S, M, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, 3)).astype(np.float32)
    p = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    return q, p


def _f64(q, p):
    d2 = ((q[:, None].astype(np.float64) - p[None]) ** 2).sum(-1)
    return np.sqrt(d2.min(1))


@pytest.mark.parametrize("S,M", SIZES)
def test_plain_vs_f64(S, M):
    q, p = _inputs(S, M)
    d = nn_min_dist(torch.as_tensor(q), torch.as_tensor(p)).numpy()
    # difference form in fp32: a few ulp of the distance
    np.testing.assert_allclose(d, _f64(q, p), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,M", SIZES)
def test_plain_vs_pallas_interpret(S, M):
    q, p = _inputs(S, M, seed=1)
    ref = np.asarray(min_dist_pallas(jnp.asarray(q), jnp.asarray(p), True))
    d = nn_min_dist(torch.as_tensor(q), torch.as_tensor(p)).numpy()
    # the Pallas kernel expands ||s||^2 + ||p||^2 - 2 s.p, which cancels
    # near zero: the atol of the reference's own test_pallas_nn.py
    np.testing.assert_allclose(d, ref, atol=1e-4)


@pytest.mark.parametrize("S,M", SIZES)
def test_plain_vs_xla_evaluator(S, M):
    q, p = _inputs(S, M, seed=2)
    ref = np.asarray(_min_dist_to_points(jnp.asarray(q), jnp.asarray(p)))
    d = nn_min_dist(torch.as_tensor(q), torch.as_tensor(p)).numpy()
    # same difference form, another summation order
    np.testing.assert_allclose(d, ref, rtol=1e-5, atol=1e-6)


def test_plain_chunking_is_exact():
    q, p = _inputs(100, 77, seed=3)
    tq, tp = torch.as_tensor(q), torch.as_tensor(p)
    np.testing.assert_array_equal(nn_min_dist_plain(tq, tp, chunk_elems=50),
                                  nn_min_dist_plain(tq, tp))


def test_empty_inputs():
    q, p = _inputs(4, 3)
    out = nn_min_dist(torch.as_tensor(q), torch.zeros((0, 3)))
    assert torch.isinf(out).all() and out.shape == (4,)
    assert nn_min_dist(torch.zeros((0, 3)), torch.as_tensor(p)).shape == (0,)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    q, p = torch.zeros((8, 3)), torch.zeros((5, 3))
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        q = torch.zeros((8, 4))
    elif bad == "contiguous":
        q = torch.zeros((3, 8)).T
    else:
        q, p = q.to("meta"), p.to("meta")
    with pytest.raises((TypeError, ValueError)):
        nn_min_dist(q, p)


def test_no_fallback_when_build_fails(monkeypatch, tmp_path):
    """Without nvcc the kernel's build raises; nothing runs the plain
    version in its place."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    cuda_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.load_library("nn_min_dist.cu")
    finally:
        cuda_build.load_library.cache_clear()
