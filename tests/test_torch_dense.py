"""The port's dense line matchers against the JAX package on the CPU.

Kernel W's plain version against JAX's jitted _ncc_flow by rows (indices
equal, scores 1e-6; both directions in test_torch_ncc_both.py); the
correlation flow on two textured rendered views (a
cell whose best index differs must be a near tie: its two columns'
float64 correlations within 1e-5; the warps elsewhere within 1e-5 and
the certainties within 1e-5, both upsampled by util/cv2_ops' INTER_LINEAR
resize in place of OpenCV's); the float64 line distances from the same
warps (1e-9); the matcher end to end (the same match lists); dense_roma
raising as JAX's does without romatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import dense as J
from limap_tpu_torch.line2d import dense as P
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.ops import ncc_argmax as W
from limap_tpu_torch.testing import pipeline, zoo, zoo_checks
from torch_threads import two_torch_threads  # noqa: F401

NEAR_TIE = 1e-5
WARP_TOL = 1e-5


@pytest.mark.parametrize("case", range(len(zoo_checks.ncc_cases())))
def test_ncc_flow_matches_jax(case):
    _, f1, f2 = zoo_checks.ncc_cases()[case]
    ri, rs = J._ncc_flow(jnp.asarray(f1), jnp.asarray(f2))
    pi, ps, _, _ = W.ncc_argmax_both(torch.as_tensor(f1),
                                     torch.as_tensor(f2))
    assert np.array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=1e-6)


@pytest.fixture(scope="module")
def textured():
    scene = pipeline.build_scene(n_views=2, hw=(120, 160))
    rng = np.random.default_rng(0)
    imgs = [np.clip(scene[1][k] + rng.normal(size=(120, 160)) * 6, 0,
                    255).astype(np.uint8) for k in (0, 1)]
    segs = [zoo.noisy_segments(scene, k) for k in (0, 1)]
    return imgs, segs


def test_correlation_flow_matches_jax(textured):
    imgs, _ = textured
    cj = J.CorrelationFlowMatcher()
    cp = P.CorrelationFlowMatcher(device="cpu")
    ref = cj.get_warping_symmetric(*imgs)
    got = cp.get_warping_symmetric(*imgs)
    for which, (a, b) in ((0, (0, 1)), (1, (1, 0))):
        fa, ga, _ = cj._features(imgs[a])
        fb, _, _ = cj._features(imgs[b])
        ri, _ = J._ncc_flow(jnp.asarray(fa), jnp.asarray(fb))
        pa, _, _ = cp._features(imgs[a])
        pb, _, _ = cp._features(imgs[b])
        np.testing.assert_allclose(pa.numpy(), fa, atol=1e-6)
        # the port takes both directions from image 0's rows x image 1's
        pi = W.ncc_argmax_both(*((pa, pb) if which == 0 else (pb, pa)))[
            2 * which]
        ri, pi = np.asarray(ri), pi.numpy()
        differ = np.nonzero(ri != pi)[0]
        f64a, f64b = fa.astype(np.float64), fb.astype(np.float64)
        for i in differ:
            assert abs(f64a[i] @ f64b[ri[i]] - f64a[i] @ f64b[pi[i]]) \
                <= NEAR_TIE, i
        assert len(differ) <= 0.01 * len(ri)
        same = np.repeat(np.repeat((ri == pi).reshape(ga), 8, 0), 8, 1)
        # cells next to a differing one move by the upsampling
        from scipy.ndimage import binary_erosion
        same = binary_erosion(same, np.ones((17, 17)))
        warp, cert = ref[2 * which], ref[2 * which + 1]
        gw, gc = got[2 * which].numpy(), got[2 * which + 1].numpy()
        np.testing.assert_allclose(gw[same], warp[same], atol=WARP_TOL)
        np.testing.assert_allclose(gc[same], cert[same], atol=WARP_TOL)


def test_line_distances_and_matches_end_to_end(textured):
    imgs, segs = textured
    je, pe = J.DenseNaiveExtractor(), get_extractor(
        {"method": "dense_naive"}, device="cpu")

    class View:
        def __init__(self, img):
            self.img = img

        def read_image(self, set_gray=True):
            return self.img

    ref = [je.extract(View(i), s) for i, s in zip(imgs, segs)]
    got = [pe.extract(View(i), s) for i, s in zip(imgs, segs)]
    for r, g in zip(ref, got):
        for k in r:
            assert np.array_equal(r[k], g[k]), k
    jm = J.NCCDenseLineMatcher(je, {"topk": 0})
    pm = get_matcher({"method": "dense_ncc", "topk": 0}, pe, device="cpu")
    # the distances from JAX's own warp, in both packages
    w12, c12, _, _ = jm.dense_matcher.get_warping_symmetric(
        ref[0]["image"], ref[1]["image"])
    d_ref, o_ref = jm._distance_one_direction(ref[0], ref[1], w12, c12)
    d_got, o_got = pm._distance_one_direction(
        ref[0], ref[1], torch.as_tensor(w12), torch.as_tensor(c12))
    np.testing.assert_allclose(d_got.numpy(), d_ref, atol=1e-9)
    np.testing.assert_allclose(o_got.numpy(), o_ref, atol=1e-12)
    a = jm.match_pair(*ref)
    b = pm.match_pair(*ref)
    assert len(a) >= 3
    assert np.array_equal(a, b)


def test_roma_raises_as_jax_does():
    ext = get_extractor({"method": "dense_naive"}, device="cpu")
    with pytest.raises(ImportError, match="romatch"):
        get_matcher({"method": "dense_roma"}, ext, device="cpu")
    with pytest.raises(ImportError, match="romatch"):
        J.RoMaLineMatcher(J.DenseNaiveExtractor())
