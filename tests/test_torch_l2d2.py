"""The port's L2D2 against the JAX package on the CPU.

- the seeded orthogonal weights (the same numpy draw) and the forward on
  the same patches (1e-5: fp32 convolutions in another order);
- kernel Y's plain version against JAX's get_patch (OpenCV's warpAffine
  and resize) on lines whose crop lies inside the warped image: 2e-5 on
  [0, 1] images (util/cv2_ops' float32 warp within 2e-5 of OpenCV's);
- a line longer than the image: JAX's numpy slice starts from the end
  of the warped image (a negative start), the port cuts the intended box,
  which OpenCV gives on a canvas padded on every side (2e-5);
- the extractor end to end on two rendered views (1e-4: the patches'
  rounding through the network) and the matcher on the same descriptors
  (equal match lists).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import l2d2 as J
from limap_tpu_torch import convert
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.line2d import l2d2 as P
from limap_tpu_torch.ops import l2d2_patches as Y
from limap_tpu_torch.testing import pipeline, zoo, zoo_checks
from torch_threads import two_torch_threads  # noqa: F401

PATCH_TOL = 2e-5
FORWARD_TOL = 1e-5
EXTRACT_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return J.init_params(0)


def test_weights_and_forward_match_jax(params):
    sd = convert.l2d2_state_dict(params)
    for k, v in P.init_params(0).items():
        assert torch.equal(v, sd[k]), k
    x = np.random.default_rng(0).normal(size=(5, 48, 32, 1)).astype(
        np.float32)
    ref = np.asarray(J.l2d2_forward(params, jnp.asarray(x)))
    got = P.l2d2_forward(P.load_torch_state_dict(sd), torch.as_tensor(x))
    assert got.shape == (5, 128)
    np.testing.assert_allclose(got.numpy(), ref, atol=FORWARD_TOL)


@pytest.mark.parametrize("case", range(len(zoo_checks.patch_cases())))
def test_patches_match_jax_inside_the_canvas(case):
    _, img, lines = zoo_checks.patch_cases()[case]
    minv, boxes = Y.line_boxes(lines, img.shape)
    inside = (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0)
    assert inside.sum() >= 20
    got = P.get_patches(torch.as_tensor(img), lines[inside]).numpy()
    ref = np.stack([J.get_patch(img, ln) for ln in lines[inside]])
    np.testing.assert_allclose(got, ref, atol=PATCH_TOL)


def intended_patch(img, line, pad=200):
    """The reference's box on a canvas padded by ``pad`` on every side,
    by OpenCV: no slice can start before the canvas."""
    h, w = img.shape
    line = np.asarray(line, np.float64)
    if line[1, 1] < line[0, 1]:
        line = line[[1, 0]]
    angle = np.arctan2(line[1, 0] - line[0, 0], line[1, 1] - line[0, 1])
    mid = line.mean(axis=0)
    T1 = np.array([[1.0, 0, -mid[0]], [0, 1, -mid[1]], [0, 0, 1]])
    TR = np.array([[np.cos(angle), -np.sin(angle), 0],
                   [np.sin(angle), np.cos(angle), 0], [0, 0, 1]])
    T2 = np.array([[1.0, 0, w // 2 + pad], [0, 1, h // 2 + pad], [0, 0, 1]])
    warped = cv2.warpAffine(img, (T2 @ TR @ T1)[:2], (w + 2 * pad,
                                                      h + 2 * pad))
    new_h = max(int(np.round(np.linalg.norm(line[0] - line[1]))), 5)
    new_w = new_h * 32 // 48
    crop = warped[pad + h // 2 - new_h // 2:pad + h // 2 + new_h // 2,
                  pad + w // 2 - new_w // 2:pad + w // 2 + new_w // 2]
    return cv2.resize(crop, (32, 48))


def test_a_line_longer_than_the_image_is_cut_where_intended():
    img = np.random.default_rng(5).random((60, 80)).astype(np.float32)
    line = np.array([[5.0, 3.0], [70.0, 55.0]])     # 83 px, image 60 high
    minv, boxes = Y.line_boxes(line[None], img.shape)
    assert boxes[0, 0] < 0
    got = P.get_patches(torch.as_tensor(img), line[None]).numpy()[0]
    np.testing.assert_allclose(got, intended_patch(img, line),
                               atol=PATCH_TOL)
    jax_patch = J.get_patch(img, line)
    assert np.abs(jax_patch - got).max() > 0.1


class _View:
    def __init__(self, img):
        self.img = img

    def read_image(self, set_gray=True):
        return self.img


def test_extract_and_match_end_to_end(params, tmp_path):
    scene = pipeline.build_scene(n_views=2, hw=(120, 160))
    imgs = [scene[1][k] for k in (0, 1)]
    segs = [zoo.noisy_segments(scene, k) for k in (0, 1)]
    # lines whose crop stays inside the warped image, where both agree
    keep = [Y.line_boxes(s[:, :4].reshape(-1, 2, 2), (120, 160))[1][:, 0]
            >= 0 for s in segs]
    segs = [s[k] for s, k in zip(segs, keep)]
    path = tmp_path / "l2d2.th"
    torch.save(convert.l2d2_state_dict(params), path)
    je = J.L2D2Extractor({"weight_path": str(path)})
    pe = get_extractor({"method": "l2d2"}, weight_path=str(path),
                       device="cpu")
    ref = [je.extract(_View(i), s) for i, s in zip(imgs, segs)]
    got = [pe.extract(_View(i), s) for i, s in zip(imgs, segs)]
    for r, g in zip(ref, got):
        assert len(r["line_descriptors"]) > 20
        np.testing.assert_allclose(g["line_descriptors"],
                                   r["line_descriptors"], atol=EXTRACT_TOL)
    for topk in (0, 2):
        a = J.L2D2Matcher(je, {"topk": topk}).match_pair(*ref)
        b = get_matcher({"method": "l2d2", "topk": topk}, pe,
                        device="cpu").match_pair(*ref)
        assert np.array_equal(a, b), topk
