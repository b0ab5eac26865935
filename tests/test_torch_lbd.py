"""The port's LBD against the JAX package on the CPU.

Kernel V's plain version against JAX's lbd_describe on segments inside
the image, across its border and of zero length: op by op (JAX without
jit) within 1e-5 (float32 sums in other orders; the std of a band whose
columns are all but equal is 0 in one order and ~1.6e-6 in another), and
against JAX's jitted program within 5e-3 (XLA fuses and contracts the
float32 arithmetic, which moves JAX's own descriptors by up to 2e-3 from
its op-by-op values at 240 x 320); the extractor end to end on two rendered views
(its pyramid on util/cv2_ops in place of OpenCV: 1e-5); the matcher on
the same descriptors (equal match lists, mutual NN and top k)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import lbd as J
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.ops import lbd_describe as V
from limap_tpu_torch.testing import pipeline, zoo, zoo_checks
from torch_threads import two_torch_threads  # noqa: F401

DESC_TOL = 1e-5
JIT_TOL = 5e-3
EAGER_LINES = 64
EXTRACT_TOL = 1e-5


@pytest.mark.parametrize("case", range(len(zoo_checks.lbd_cases())))
def test_describe_matches_jax(case):
    name, img, segs, valid = zoo_checks.lbd_cases()[case]
    args = (jnp.asarray(img), jnp.asarray(segs), jnp.asarray(valid))
    jitted = np.asarray(J.lbd_describe(*args))
    got = V.lbd_describe(*(torch.as_tensor(a) for a in (img, segs, valid)))
    # JAX op by op is slow: its first EAGER_LINES lines
    n = min(len(segs), EAGER_LINES)
    with jax.disable_jit():
        ref = np.asarray(J.lbd_describe(args[0], args[1][:n], args[2][:n]))
    np.testing.assert_allclose(got.numpy()[:n], ref, atol=DESC_TOL)
    np.testing.assert_allclose(got.numpy(), jitted, atol=JIT_TOL)
    assert not got.numpy()[~valid].any()


class _View:
    def __init__(self, img):
        self.img = img

    def read_image(self, set_gray=True):
        return self.img


@pytest.fixture(scope="module")
def views():
    scene = pipeline.build_scene(n_views=2, hw=(120, 160))
    return ([scene[1][k] for k in (0, 1)],
            [zoo.noisy_segments(scene, k) for k in (0, 1)])


def test_extract_and_match_end_to_end(views):
    imgs, segs = views
    je = J.LBDExtractor()
    pe = get_extractor({"method": "lbd"}, device="cpu")
    ref = [je.extract(_View(i), s) for i, s in zip(imgs, segs)]
    got = [pe.extract(_View(i), s) for i, s in zip(imgs, segs)]
    for r, g in zip(ref, got):
        assert g["line_descriptors"].shape == r["line_descriptors"].shape \
            == (len(g["line_descriptors"]), 3, 72)
        np.testing.assert_allclose(g["line_descriptors"],
                                   r["line_descriptors"], atol=EXTRACT_TOL)
    for topk in (0, 3):
        jm = J.LBDMatcher(je, {"topk": topk})
        pm = get_matcher({"method": "lbd", "topk": topk}, pe, device="cpu")
        a = jm.match_pair(*ref)
        b = pm.match_pair(*ref)
        assert len(a) > 10
        assert np.array_equal(a, b), topk


def test_empty_inputs():
    pe = get_extractor({"method": "lbd"}, device="cpu")
    out = pe.extract(_View(np.zeros((20, 30), np.uint8)),
                     np.zeros((0, 5)))
    assert out["line_descriptors"].shape == (0, 3, 72)
    pm = get_matcher({"method": "lbd", "topk": 0}, pe, device="cpu")
    assert pm.match_pair(out, out).shape == (0, 2)
