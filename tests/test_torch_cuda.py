"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a GPU.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops.nn_distance import nn_min_dist, nn_min_dist_plain

pytestmark = pytest.mark.cuda

# ragged sizes (none a multiple of the kernel's 256 threads or 2048-point
# tiles, M below one tile, S = 1) and one evaluation-sized cloud
SIZES = [(1, 5), (70, 300), (257, 1025), (513, 2049), (33, 4097),
         (8192, 100_000)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.parametrize("S,M", SIZES)
def test_nn_min_dist_kernel_vs_plain(cuda, S, M):
    rng = np.random.default_rng(S + M)
    q = torch.as_tensor(rng.normal(size=(S, 3)).astype(np.float32),
                        device="cuda")
    p = torch.as_tensor((rng.normal(size=(M, 3)) * 2).astype(np.float32),
                        device="cuda")
    n0 = nn_min_dist.launches
    d = nn_min_dist(q, p)
    torch.cuda.synchronize()
    assert nn_min_dist.launches == n0 + 1
    # both take the difference form in fp32; the rounding order differs
    torch.testing.assert_close(d, nn_min_dist_plain(q, p), rtol=1e-5,
                               atol=1e-6)


def test_nn_min_dist_kernel_edge_cases(cuda):
    p = torch.randn(10, 3, device="cuda")
    assert nn_min_dist(torch.zeros((0, 3), device="cuda"), p).shape == (0,)
    out = nn_min_dist(torch.randn(4, 3, device="cuda"),
                      torch.zeros((0, 3), device="cuda"))
    assert torch.isinf(out).all()
    with pytest.raises(ValueError):
        nn_min_dist(torch.randn(4, 3, device="cuda"), p.cpu())
