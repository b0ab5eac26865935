"""util/cv2_ops against OpenCV on random inputs.

Tolerances, each the largest difference measured against cv2 5.0 plus a
margin:
- float32 INTER_NEAREST resize and RGB -> HSV: equal;
- float32 INTER_LINEAR resize: 5e-7 on [0, 1] (OpenCV's float32 weights
  and sums differ from the port's by an ulp or two);
- float32 5x5 blur: 5e-7 on [0, 1] (pairwise-symmetric taps, another
  summation order);
- uint8 INTER_LINEAR resize, uint8 blur and HSV -> BGR: one grey level
  (OpenCV's fixed-point rules are not reproduced);
- float32 warpAffine: 2e-5 on [0, 1] (OpenCV 5 takes float32 source
  coordinates in a SIMD order of its own; a coordinate that rounds the
  other way moves a texel by up to its gradient times 1e-6 px).
"""

import cv2
import numpy as np
import pytest
import torch

from limap_tpu_torch.util import cv2_ops as C
from torch_threads import two_torch_threads  # noqa: F401

SIZES = [(58, 43), (32, 48), (200, 150), (21, 15), (83, 61)]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.random((61, 83)).astype(np.float32),
            rng.integers(0, 256, (61, 83), dtype=np.uint8),
            rng.integers(0, 256, (50, 60, 3), dtype=np.uint8))


@pytest.mark.parametrize("size", SIZES)
def test_resize_float32(images, size):
    f, _, _ = images
    t = torch.as_tensor(f)
    assert np.array_equal(C.resize(t, size, C.INTER_NEAREST).numpy(),
                          cv2.resize(f, size,
                                     interpolation=cv2.INTER_NEAREST))
    np.testing.assert_allclose(
        C.resize(t, size, C.INTER_LINEAR).numpy(),
        cv2.resize(f, size, interpolation=cv2.INTER_LINEAR), atol=5e-7)


@pytest.mark.parametrize("size", SIZES)
def test_resize_uint8(images, size):
    _, u, _ = images
    got = C.resize(torch.as_tensor(u), size, C.INTER_LINEAR).numpy()
    ref = cv2.resize(u, size, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_resize_by_factor_and_channels(images):
    f, u, _ = images
    got = C.resize(torch.as_tensor(u), None, C.INTER_LINEAR, fx=0.25,
                   fy=0.25).numpy()
    ref = cv2.resize(u, (0, 0), fx=0.25, fy=0.25,
                     interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    two = np.stack([f[:10, :12], 1 - f[:10, :12]], -1)
    np.testing.assert_allclose(
        C.resize(torch.as_tensor(two), (97, 81)).numpy(),
        cv2.resize(two, (97, 81), interpolation=cv2.INTER_LINEAR),
        atol=5e-7)


@pytest.mark.parametrize("sigma", [1.0, float(np.sqrt(2.0)), 2.0, 3.0])
def test_gaussian_blur(images, sigma):
    f, u, _ = images
    assert np.array_equal(C.gaussian_kernel(5, sigma),
                          cv2.getGaussianKernel(5, sigma,
                                                ktype=cv2.CV_32F)[:, 0])
    np.testing.assert_allclose(
        C.gaussian_blur(torch.as_tensor(f), sigma).numpy(),
        cv2.GaussianBlur(f, (5, 5), sigma, borderType=cv2.BORDER_REPLICATE),
        atol=5e-7)
    got = C.gaussian_blur(torch.as_tensor(u), sigma,
                          border="reflect101").numpy()
    ref = cv2.GaussianBlur(u, (5, 5), sigma)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_colour_conversions(images):
    _, _, rgb = images
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    assert np.array_equal(C.rgb_to_hsv(torch.as_tensor(rgb)).numpy(), hsv)
    got = C.hsv_to_bgr(torch.as_tensor(hsv)).numpy()
    ref = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    grey = np.repeat(rgb[..., :1], 3, -1)
    assert np.array_equal(C.rgb_to_hsv(torch.as_tensor(grey)).numpy(),
                          cv2.cvtColor(grey, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("angle,shift", [(0.37, (3.3, -2.7)),
                                         (-1.2, (40.0, 10.0)),
                                         (0.0, (0.3, 0.0))])
def test_warp_affine(images, angle, shift):
    f, _, _ = images
    A = np.array([[np.cos(angle), -np.sin(angle), shift[0]],
                  [np.sin(angle), np.cos(angle), shift[1]]])
    np.testing.assert_array_equal(C.invert_affine(A),
                                  cv2.invertAffineTransform(A))
    np.testing.assert_allclose(
        C.warp_affine(torch.as_tensor(f), A, (83, 61)).numpy(),
        cv2.warpAffine(f, A, (83, 61)), atol=2e-5)


def test_warp_takes_float32_coordinates():
    """A translation by 0.3 px weights the neighbours 0.7 / 0.3, not by
    1/32 steps: OpenCV 5's warpAffine does not round coordinates."""
    img = np.zeros((4, 8), np.float32)
    img[:, 4] = 1.0
    A = np.array([[1.0, 0, 0.3], [0, 1.0, 0]])
    ref = cv2.warpAffine(img, A, (8, 4))
    got = C.warp_affine(torch.as_tensor(img), A, (8, 4)).numpy()
    np.testing.assert_allclose(ref[1, 4:6], [0.7, 0.3], atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-6)
