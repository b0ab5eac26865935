"""The port's SOLD2 pipeline against the JAX package on the CPU, end to
end on two small rendered views: forward, junctions, detection without
the junction refinement, saliency, line descriptors and Wunsch matching,
from the same seeded network (the reference's draw, which the port
repeats), the JAX convolutions at HIGHEST precision.  Segments equal;
saliencies within 1e-4 relative (a float64 sum of float32-network
heatmap values); descriptors within 1e-4 (fp32 network outputs);
Wunsch matches equal on at least 95 % of the lines (the network's
rounding moves near-tied line scores)."""

import numpy as np
import pytest
import jax

from limap_tpu.line2d.sold2 import nets as ref_nets
from limap_tpu.line2d.sold2 import sold2 as ref_sold2
from limap_tpu_torch.line2d.sold2 import sold2
from limap_tpu_torch.testing import pipeline
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    ref_nets.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    ref_nets.set_conv_precision(None)


def test_engine_pipeline_matches_jax_without_junction_refinement():
    """Forward, junctions, detection (the junction refinement, JAX's
    float64 numpy hot loop, is held in test_torch_sold2_detection.py),
    saliency, line descriptors and Wunsch matching of two 96 x 96 views.
    The reference's engine samples the descriptors at the junction grid
    size 8; the port at the descriptor grid's stride 4, so the port's
    descinfo is held to the reference matcher's compute_descriptors at
    4."""
    _, imgs, _, _ = pipeline.build_scene(n_views=2, hw=(96, 96))
    ref = ref_sold2.SOLD2Engine(seed=0)
    port = sold2.SOLD2Engine(seed=0, device="cpu")
    for eng in (ref, port):
        eng.line_detector.use_junction_refinement = False
    out = {}
    for i in (0, 1):
        a = ref.detect(imgs[i])
        b = port.detect(imgs[i])
        assert len(b[0]) > 10
        rows = lambda s: set(map(tuple, np.round(s[:, :4], 9).tolist()))
        assert rows(a[0]) == rows(b[0])
        np.testing.assert_allclose(
            np.sort(b[0][:, 4]), np.sort(a[0][:, 4]), rtol=1e-4)
        segs_hw = np.flip(b[0][:, :4].reshape(-1, 2, 2), axis=2)
        want = ref.matcher.compute_descriptors(segs_hw, a[1], 4)
        np.testing.assert_allclose(b[3][0], want[0], atol=1e-4)
        assert np.array_equal(b[3][1], want[1])
        out[i] = b[3]
    m_ref = ref_sold2.WunschLineMatcher().compute_matches(out[0], out[1])
    m_port = port.matcher.compute_matches(out[0], out[1])
    assert np.mean(m_ref == m_port) >= 0.95
