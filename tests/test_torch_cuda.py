"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a GPU.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import nn_distance as nnd
from limap_tpu_torch.ops.nn_distance import (nn_min_dist, nn_min_dist_plain,
                                             nn_min_dist_scalar)

pytestmark = pytest.mark.cuda

KERNELS = {"nn_min_dist": nn_min_dist,
           "nn_min_dist_scalar": nn_min_dist_scalar}
# ragged sizes (none a multiple of the scalar kernel's 256 threads and
# 2048-point tiles or of the tensor-core kernel's 256-query blocks and
# 1024-point stages, M below one tile, S = 1) and one evaluation-sized cloud
SIZES = [(1, 5), (70, 300), (257, 1025), (513, 2049), (33, 4097),
         (8192, 100_000)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def adversarial(kind):
    """Inputs built against the tensor-core filter (numpy fp32)."""
    rng = np.random.default_rng(7)
    p = rng.uniform(-10, 10, (20_000, 3))
    q = p[rng.integers(0, len(p), 2000)] + rng.normal(0, 0.02, (2000, 3))
    if kind == "shifted":       # a scene 1 km from the origin on each axis
        p, q = p + 1000.0, q + 1000.0
    elif kind == "zero":        # the cloud holds the queries, and twice
        p = np.concatenate([p, q, q, p[:500]])
    elif kind == "clusters":    # points within 1e-4 m around each query
        p = np.concatenate([p] + [q + rng.normal(0, 1e-4, q.shape)
                                  for _ in range(6)])
    return q.astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("S,M", SIZES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_vs_plain(cuda, name, S, M):
    kernel = KERNELS[name]
    rng = np.random.default_rng(S + M)
    q = torch.as_tensor(rng.normal(size=(S, 3)).astype(np.float32),
                        device="cuda")
    p = torch.as_tensor((rng.normal(size=(M, 3)) * 2).astype(np.float32),
                        device="cuda")
    n0 = kernel.launches
    d = kernel(q, p)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    # both take the difference form in fp32; the rounding order differs
    torch.testing.assert_close(d, nn_min_dist_plain(q, p), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["shifted", "zero", "clusters"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_adversarial(cuda, name, kind):
    q, p = (torch.as_tensor(x, device="cuda") for x in adversarial(kind))
    d = KERNELS[name](q, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, nn_min_dist_plain(q, p), rtol=1e-5,
                               atol=1e-6)


def test_kernels_agree_bit_for_bit(cuda):
    """The confirm step is the scalar kernel's arithmetic on the pairs
    that matter, so the two kernels return the same bits."""
    q, p = (torch.as_tensor(x, device="cuda") for x in adversarial("zero"))
    assert torch.equal(nn_min_dist(q, p), nn_min_dist_scalar(q, p))
    confirms = int(nn_min_dist.confirms)
    assert 0 < confirms < 0.05 * q.shape[0] * p.shape[0]


def test_filter_tile_vs_plain(cuda):
    """The mma fragment layout and the staging: the kernel's raw filter
    values against the fp32 matrix product of the same operands."""
    q, p = (torch.as_tensor(x, device="cuda")
            for x in adversarial("shifted"))
    B, centre, p_max, _ = nnd.prepare_cloud_operand(p[:1500])
    A, ss, _ = nnd.prepare_query_operand(q[:600], centre, p_max)
    D = nnd.filter_tile_values(A, B)
    torch.cuda.synchronize()
    ref = nnd.filter_values_plain(A, B[:nnd.CLOUD_PAD])
    # 8 addends of magnitude up to (||s'|| + ||p'||)^2, each truncated
    # at the largest one's last place by the tensor cores
    atol = 2.0 ** -19 * float((ss.max().sqrt() + p_max) ** 2)
    torch.testing.assert_close(D, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_edge_cases(cuda, name):
    kernel = KERNELS[name]
    p = torch.randn(10, 3, device="cuda")
    assert kernel(torch.zeros((0, 3), device="cuda"), p).shape == (0,)
    out = kernel(torch.randn(4, 3, device="cuda"),
                 torch.zeros((0, 3), device="cuda"))
    assert torch.isinf(out).all()
    with pytest.raises(ValueError):
        kernel(torch.randn(4, 3, device="cuda"), p.cpu())


def test_tpu_lsd_repeats_on_the_card_and_agrees_with_the_cpu(cuda):
    """The card adds a component's moments in pixel order, so two runs
    give the same bits, and the CPU's segments within 0.05 px (measured
    0.011 px at 800x600 on an H100)."""
    from limap_tpu_torch.line2d.tpu_lsd import detect_segments
    from limap_tpu_torch.testing import pipeline
    img = pipeline.build_scene(n_views=1)[1][0]
    first = detect_segments(img, max_segs=3000, device="cuda")
    again = detect_segments(img, max_segs=3000, device="cuda")
    assert np.array_equal(first, again) and len(first) > 300
    cpu = detect_segments(img, max_segs=3000, device="cpu")
    offs = np.abs(cpu[:, None, :4] - first[None, :, :4]).max(-1).min(1)
    assert (offs > 0.05).sum() <= 0.02 * len(cpu)
