"""The port's tpu_lsd detector against the JAX one, on the CPU: the same
numpy images through both.  Sobel fields within 1e-6, component labels
equal, detections equal as sets to a sub-pixel tolerance."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limap_tpu.line2d import tpu_lsd as ref
from limap_tpu_torch.line2d import get_detector, get_extractor, get_matcher
from limap_tpu_torch.line2d import tpu_lsd as port
from limap_tpu_torch.testing.pipeline import draw_line

from test_line2d import gt_coverage
from torch_threads import two_torch_threads  # noqa: F401

# Both packages add the moments in pixel order on the CPU, so matched
# endpoints differ by rounding only (measured: 4e-3 px at 240x320)
ENDPOINT_TOL = 0.05
# A component whose width, density or length sits on its threshold may
# pass in one package only
MAX_UNMATCHED_SHARE = 0.1


def draw_synthetic_image(rng, H=240, W=320, n_lines=6):
    """tests/test_line2d.py::draw_synthetic_image with the strokes drawn
    by the port's rasteriser."""
    img = np.full((H, W), 220, np.uint8)
    gt = []
    for _ in range(n_lines):
        while True:
            p1 = rng.uniform([20, 20], [W - 20, H - 20])
            p2 = rng.uniform([20, 20], [W - 20, H - 20])
            if np.linalg.norm(p2 - p1) > 60:
                break
        draw_line(img, p1.astype(int), p2.astype(int), 40)
        gt.append(np.concatenate([p1, p2]))
    noise = rng.normal(size=(H, W)) * 3
    img = np.clip(img.astype(np.float64) + noise, 0, 255).astype(np.uint8)
    return img, np.asarray(gt)


def unmatched(a, b, tol):
    """Rows of a [N, >=4] with no row of b within tol (max abs over the
    four endpoint coordinates)."""
    if not len(a) or not len(b):
        return len(a)
    d = np.abs(a[:, None, :4] - b[None, :, :4]).max(-1)
    return int((d.min(1) > tol).sum())


def test_sobel_matches_reference(rng):
    img = rng.uniform(size=(37, 53)).astype(np.float32)
    gx, gy = port._sobel(torch.as_tensor(img))
    rx, ry = ref._sobel(jnp.asarray(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-6)


@pytest.mark.parametrize("density", [0.3, 0.55, 0.7])
@pytest.mark.parametrize("n_rounds", [1, 2, 3])
def test_grid_cc_labels_equal_on_random_masks(rng, density, n_rounds):
    """Also where n_rounds stops short of the fixpoint (long snakes at
    density 0.55): the jumps read the previous jump's labels in both."""
    mask = rng.uniform(size=(60, 83)) < density
    got = port._grid_cc(torch.as_tensor(mask), n_rounds).numpy()
    want = np.asarray(ref._grid_cc(jnp.asarray(mask), n_rounds))
    assert np.array_equal(got, want)
    assert (got[~mask] == -1).all()


def test_grid_cc_labels_equal_on_a_drawing(rng):
    img, _ = draw_synthetic_image(rng)
    gx, gy = port._sobel(torch.as_tensor(img.astype(np.float32) / 255.0))
    mask = (torch.sqrt(gx * gx + gy * gy) > 0.05).numpy()
    got = port._grid_cc(torch.as_tensor(mask), 2).numpy()
    want = np.asarray(ref._grid_cc(jnp.asarray(mask), 2))
    assert np.array_equal(got, want)


def test_grid_cc_converged_labels_are_component_minima(rng):
    """A converged label is the minimum flat index of its component."""
    mask = rng.uniform(size=(60, 83)) < 0.35
    full = port._grid_cc(torch.as_tensor(mask), 30).numpy()
    from scipy import ndimage
    comp, n = ndimage.label(mask, structure=np.ones((3, 3)))
    flat = np.arange(mask.size).reshape(mask.shape)
    minima = ndimage.minimum(flat, comp, index=np.arange(1, n + 1))
    assert np.array_equal(full[mask], minima[comp[mask] - 1])


@pytest.mark.parametrize("grad_th", [0.03, 0.05])
def test_detect_segments_matches_reference_as_sets(rng, grad_th):
    img, gt = draw_synthetic_image(rng)
    got = port.detect_segments(img, grad_th=grad_th, device="cpu")
    want = ref.detect_segments(img, grad_th=grad_th)
    assert len(want) >= len(gt)
    allowed = MAX_UNMATCHED_SHARE * len(want)
    assert abs(len(got) - len(want)) <= allowed
    assert unmatched(got, want, ENDPOINT_TOL) <= allowed
    assert unmatched(want, got, ENDPOINT_TOL) <= allowed
    # longest first in both
    assert (np.diff(got[:, 4]) <= 1e-6).all()


def test_detect_segments_caps_at_max_segs(rng):
    img, _ = draw_synthetic_image(rng)
    got = port.detect_segments(img, grad_th=0.05, max_segs=5, device="cpu")
    want = ref.detect_segments(img, grad_th=0.05, max_segs=5)
    assert len(got) == len(want) == 5
    assert unmatched(got, want, ENDPOINT_TOL) == 0


def test_tpu_lsd_detects_synthetic_lines(rng):
    """The coverage gate of tests/test_line2d.py on the port."""
    img, gt = draw_synthetic_image(rng)
    segs = port.detect_segments(img, grad_th=0.05, device="cpu")
    assert len(segs) >= len(gt)
    coverages = [gt_coverage(g, segs) for g in gt]
    assert sum(c > 0.6 for c in coverages) >= len(gt) - 1, coverages


def test_blank_image_gives_no_segments():
    out = port.detect_segments(np.full((40, 50), 128, np.uint8), device="cpu")
    assert out.shape == (0, 5)


def test_registry_builds_the_ported_methods_and_names_the_rest(rng):
    det = get_detector({"method": "tpu_lsd", "grad_th": 0.05},
                       max_num_2d_segs=7, device="cpu")
    assert det.get_module_name() == "tpu_lsd"
    img, _ = draw_synthetic_image(rng)
    assert len(det.detect_array(img)) == 7
    ext = get_extractor({"method": "patch_endpoints"}, device="cpu")
    assert get_matcher({"method": "nn_endpoints", "topk": 3}, ext,
                       device="cpu").topk == 3
    assert get_detector({"method": "sold2"}, device="cpu") \
        .get_module_name() == "sold2"
    assert get_extractor({"method": "superpoint_endpoints"}, device="cpu") \
        .get_module_name() == "superpoint_endpoints"
    assert get_matcher({"method": "sinkhorn_endpoints"}, ext, device="cpu") \
        .get_module_name() == "sinkhorn_endpoints"
    # the learned zoo builds too (random weights, on the CPU)
    assert get_detector({"method": "tp_lsd"}, device="cpu") \
        .get_module_name() == "tp_lsd"
    lbd = get_extractor({"method": "lbd"}, device="cpu")
    assert lbd.get_module_name() == "lbd"
    assert get_matcher({"method": "lbd"}, lbd, device="cpu") \
        .get_module_name() == "lbd"
    dense = get_extractor({"method": "dense_naive"}, device="cpu")
    assert get_matcher({"method": "dense_ncc"}, dense, device="cpu") \
        .get_module_name() == "dense_ncc"
    with pytest.raises(NotImplementedError, match="unknown detector"):
        get_detector({"method": "no_such_method"}, device="cpu")


def test_not_ported_lists_cover_the_reference_registries():
    """Every method the JAX package registers is ported: none is named
    as waiting any more."""
    from limap_tpu.line2d import base as ref_base
    from limap_tpu_torch.line2d import base as port_base
    for f in (ref_base.get_detector, ref_base.get_extractor):
        with pytest.raises(NotImplementedError):
            f({"method": "no_such_method"})   # imports every module
    with pytest.raises(NotImplementedError):
        ref_base.get_matcher({"method": "no_such_method"}, None)
    with pytest.raises(NotImplementedError):
        port_base.get_detector({"method": "no_such_method"})
    for kind, theirs, ours in (
            ("detector", ref_base.DETECTOR_REGISTRY,
             port_base.DETECTOR_REGISTRY),
            ("extractor", ref_base.EXTRACTOR_REGISTRY,
             port_base.EXTRACTOR_REGISTRY),
            ("matcher", ref_base.MATCHER_REGISTRY,
             port_base.MATCHER_REGISTRY)):
        waiting = set(port_base.NOT_PORTED[kind])
        assert not waiting
        assert set(theirs) == set(ours), kind


def test_lsd_wrapper_detects_like_the_reference(rng):
    """The cv2 wrapper (cv2 is installed where the tests run)."""
    from limap_tpu.line2d.lsd import LSDDetector as RefLSD
    img, _ = draw_synthetic_image(rng)
    got = get_detector({"method": "lsd"}).detect_array(img)
    want = RefLSD().detect_array(img)
    np.testing.assert_allclose(got, want)


def test_detect_arrays_parallel_threads_only_host_detectors(rng, monkeypatch):
    """A device detector runs in the calling thread; cv2's LSD fans out.
    Either way the result is the per-image detection, capped."""
    import threading
    from limap_tpu_torch.line2d import base
    imgs = {i: draw_synthetic_image(rng)[0] for i in range(3)}
    threads = set()
    real = port.detect_segments

    def spy(*a, **k):
        threads.add(threading.get_ident())
        return real(*a, **k)

    monkeypatch.setattr(port, "detect_segments", spy)
    got = base.detect_arrays_parallel({"method": "tpu_lsd", "grad_th": 0.05},
                                      imgs, max_num_2d_segs=6, device="cpu")
    assert threads == {threading.get_ident()}
    for i, img in imgs.items():
        want = real(img, grad_th=0.05, max_segs=6, device="cpu")
        np.testing.assert_allclose(got[i], want)
    host = base.detect_arrays_parallel({"method": "lsd"}, imgs)
    assert set(host) == set(imgs) and all(len(v) for v in host.values())
