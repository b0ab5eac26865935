"""The port's patch-endpoint descriptors and neighbour matcher against
the JAX ones, on the CPU: the same numpy images and segments through
both.  Descriptors within 1e-5; match lists equal up to top-k ties, so
they are compared as sets of (line, matched line)."""

import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from limap_tpu.line2d import endpoints as ref
from limap_tpu.line2d import get_matcher as ref_get_matcher
from limap_tpu.line2d.line_utils import merge_lines as ref_merge_lines
from limap_tpu_torch.line2d import endpoints as port
from limap_tpu_torch.line2d import get_matcher
from limap_tpu_torch.line2d.base import BaseMatcher
from limap_tpu_torch.line2d.line_utils import merge_lines
from torch_threads import two_torch_threads  # noqa: F401

DESC_TOL = 1e-5


def scene(rng, n_images=4, hw=(64, 80), score=True):
    imgs = {i: rng.uniform(0, 255, size=hw).astype(np.uint8)
            for i in range(n_images)}
    segs = {}
    for i in range(n_images):
        s = rng.uniform(5, 60, size=(5 + i, 4))
        segs[i] = (np.concatenate(
            [s, rng.uniform(0.5, 1, size=(len(s), 1))], 1) if score else s)
    nbrs = {i: [j for j in range(n_images) if j != i]
            for i in range(n_images)}
    return imgs, segs, nbrs


def as_pairs(m):
    return set(map(tuple, np.asarray(m).reshape(-1, 2).tolist()))


def test_descriptors_match_reference_also_at_the_border(rng):
    """Endpoints on and beyond the image border exercise the clipped
    corner index and weight (indexed loads, not grid_sample)."""
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    ep = np.concatenate([
        rng.uniform([0, 0], [64, 48], size=(20, 2)),
        [[0, 0], [63, 47], [-5, 10], [70, 50], [63.5, 0.25], [1e-3, 46.999]],
    ]).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, len(ep))
    dirs = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    got = port._sample_patch_descriptors(
        torch.as_tensor(img), torch.as_tensor(ep), torch.as_tensor(dirs))
    want = ref._sample_patch_descriptors(
        jnp.asarray(img), jnp.asarray(ep), jnp.asarray(dirs))
    assert got.shape == (len(ep), port.PATCH * port.PATCH + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DESC_TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_extractor_descinfo_matches_reference(rng):
    imgs, segs, _ = scene(rng)
    ex = port.PatchEndpointsExtractor({"device": "cpu"})
    rex = ref.PatchEndpointsExtractor({})
    for i in imgs:
        got = ex.compute_descinfo(imgs[i], segs[i])
        want = rex.compute_descinfo(imgs[i], segs[i])
        assert set(got) == set(want)
        np.testing.assert_allclose(got["endpoints_desc"],
                                   want["endpoints_desc"], atol=DESC_TOL)
        np.testing.assert_allclose(got["lines"], want["lines"])
        np.testing.assert_allclose(got["lines_score"], want["lines_score"])
    empty = ex.compute_descinfo(imgs[0], np.zeros((0, 5)))
    want = rex.compute_descinfo(imgs[0], np.zeros((0, 5)))
    assert empty["endpoints_desc"].shape == want["endpoints_desc"].shape


def test_batched_descinfos_match_per_image_and_reference(rng):
    imgs, segs, _ = scene(rng, n_images=3)
    segs[1] = np.zeros((0, 5))
    ex = port.PatchEndpointsExtractor({"device": "cpu"})
    batch = port.compute_descinfos_batch(imgs, segs, device="cpu")
    want = ref.compute_descinfos_batch(imgs, segs)
    for i in imgs:
        single = ex.compute_descinfo(imgs[i], segs[i])
        if len(segs[i]):
            np.testing.assert_allclose(batch[i]["endpoints_desc"],
                                       single["endpoints_desc"], atol=1e-6)
            np.testing.assert_allclose(batch[i]["lines_score"],
                                       single["lines_score"], atol=1e-6)
        assert batch[i]["endpoints_desc"].shape == \
            want[i]["endpoints_desc"].shape
        np.testing.assert_allclose(batch[i]["endpoints_desc"],
                                   want[i]["endpoints_desc"], atol=DESC_TOL)
    # float images take the same path as uint8 ones
    as_float = {i: imgs[i].astype(np.float32) / 255.0 for i in imgs}
    again = port.compute_descinfos_batch(as_float, segs, device="cpu")
    np.testing.assert_allclose(again[2]["endpoints_desc"],
                               batch[2]["endpoints_desc"], atol=1e-6)


def test_batched_line_matches_good_mask_and_indices(rng):
    """_batched_line_matches on one descriptor stack: the good mask equal,
    the indices equal where good, as sets per line (top-k ties).  Rows
    past n1 and columns past n2 stay masked."""
    I, D, L, k = 4, 66, 8, 2
    stack = rng.normal(size=(I, D, 2 * L)).astype(np.float32)
    stack /= np.linalg.norm(stack, axis=1, keepdims=True)
    rows1 = np.array([0, 1, 2, 3, 0])
    rows2 = np.array([1, 2, 3, 0, 0])
    n = np.array([5, 6, 7, 8])
    min_score = 0.02
    good, idx = port._batched_line_matches(
        torch.as_tensor(stack), torch.as_tensor(rows1),
        torch.as_tensor(rows2), torch.as_tensor(n[rows1]),
        torch.as_tensor(n[rows2]), min_score, k)
    rgood, ridx = ref._batched_line_matches(
        jnp.asarray(stack.reshape(-1)), jnp.asarray(rows1, jnp.int32),
        jnp.asarray(rows2, jnp.int32), jnp.asarray(n[rows1], jnp.int32),
        jnp.asarray(n[rows2], jnp.int32), jnp.float32(min_score), k, D,
        2 * L)
    good, idx = good.numpy(), idx.numpy()
    rgood, ridx = np.asarray(rgood).astype(bool), np.asarray(ridx)
    assert idx.dtype == np.int32          # the reference's are int16
    assert good.any() and not good.all()
    assert np.array_equal(good, rgood)
    for p in range(len(rows1)):
        assert not good[p, n[rows1[p]]:].any()
        for line in range(L):
            assert set(idx[p, line][good[p, line]]) == \
                set(ridx[p, line][rgood[p, line]])
            assert (idx[p, line][good[p, line]] < n[rows2[p]]).all()


@pytest.mark.parametrize("topk,min_score", [(2, -10.0), (2, 0.6), (1, 0.5)])
def test_match_all_neighbors_batched_equals_two_stage_and_reference(
        rng, topk, min_score):
    """Mirror of tests/test_line2d.py: fused describe + match == batch
    extract + batched pair matching, and both equal the JAX result."""
    imgs, segs, nbrs = scene(rng, score=False)
    fused = port.match_all_neighbors_batched(
        imgs, segs, nbrs, topk=topk, min_score=min_score, device="cpu")
    descinfos = port.compute_descinfos_batch(imgs, segs, device="cpu")
    pairs = [(i, j) for i in sorted(nbrs) for j in nbrs[i]]
    two = port.batched_match_pairs(descinfos, pairs, topk=topk,
                                   min_score=min_score, device="cpu")
    want = ref.match_all_neighbors_batched(imgs, segs, nbrs, topk=topk,
                                           min_score=min_score)
    n_matches = 0
    for (a, b) in pairs:
        assert np.array_equal(fused[a][b], two[(a, b)]), (a, b)
        assert as_pairs(fused[a][b]) == as_pairs(want[a][b]), (a, b)
        n_matches += len(fused[a][b])
    assert n_matches > 0


def test_match_chunks_do_not_change_the_result(rng):
    imgs, segs, nbrs = scene(rng, score=False)
    one = port.match_all_neighbors_batched(imgs, segs, nbrs, device="cpu",
                                           min_score=0.3)
    many = port.match_all_neighbors_batched(imgs, segs, nbrs, device="cpu",
                                            min_score=0.3, chunk=5)
    for a in nbrs:
        for b in nbrs[a]:
            assert np.array_equal(one[a][b], many[a][b])


def test_half_resolution_device_images_match_reference(rng):
    """The protocol's path: half-resolution uploads, img_scale = 0.5.
    The port's box mean and cv2's INTER_AREA differ by at most one grey
    level, which moves a score by ~1e-3: the threshold is kept away."""
    imgs, segs, nbrs = scene(rng, hw=(96, 128), score=False)
    for i in segs:
        segs[i] = segs[i] * 1.5
    dev = {i: port.upload_image_u8(imgs[i], downscale=2, device="cpu")
           for i in imgs}
    rdev = {i: ref.upload_image_u8(imgs[i], downscale=2) for i in imgs}
    for i in imgs:
        assert dev[i].dtype == torch.uint8 and dev[i].shape == (48 * 64,)
        diff = np.abs(dev[i].numpy().astype(int)
                      - np.asarray(rdev[i]).astype(int))
        assert diff.max() <= 1
    # the same device images through both matchers: equal match sets
    same = {i: torch.as_tensor(np.array(rdev[i])) for i in imgs}
    got = port.match_all_neighbors_batched(
        imgs, segs, nbrs, topk=2, min_score=-10.0, device_imgs=same,
        img_scale=0.5, device="cpu")
    want = ref.match_all_neighbors_batched(
        imgs, segs, nbrs, topk=2, min_score=-10.0, device_imgs=rdev,
        img_scale=0.5)
    for a in nbrs:
        for b in nbrs[a]:
            assert as_pairs(got[a][b]) == as_pairs(want[a][b])


@pytest.mark.parametrize("factor", [2, 4])
def test_box_downscale_is_area_interpolation(rng, factor):
    im = rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    got = port.box_downscale_u8(im, factor)
    want = cv2.resize(im, (64 // factor, 48 // factor),
                      interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="multiple"):
        port.box_downscale_u8(im[:47], factor)


def test_intended_divergences_from_the_reference(rng):
    imgs, segs, nbrs = scene(rng, score=False)
    # img_scale without downscaled device images: the reference scales
    # the endpoints over full-size images; the port refuses
    with pytest.raises(ValueError, match="img_scale"):
        port.match_all_neighbors_batched(imgs, segs, nbrs, img_scale=0.5,
                                         device="cpu")
    # device-only mode cannot know H and W, in either package
    dev = {i: port.upload_image_u8(imgs[i], device="cpu") for i in imgs}
    with pytest.raises(ValueError, match="imgs"):
        port.match_all_neighbors_batched({}, segs, nbrs, device_imgs=dev,
                                         device="cpu")
    with pytest.raises(ValueError, match="imgs"):
        ref.match_all_neighbors_batched(
            {}, segs, nbrs, device_imgs={i: ref.upload_image_u8(imgs[i])
                                         for i in imgs})
    with pytest.raises(ValueError, match="img_scale"):
        port.match_all_neighbors_batched(imgs, segs, nbrs, device_imgs=dev,
                                         img_scale=0.5, device="cpu")
    # int32 indices hold a line id above int16's range
    assert torch.iinfo(torch.int32).max > 40000 > np.iinfo(np.int16).max
    stack = torch.zeros((1, 4, 16))
    z = torch.zeros(1, dtype=torch.int64)
    _, idx = port._batched_line_scores_topk(stack, z, z, z + 8, 2)
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("topk", [0, 3])
def test_match_pair_matches_reference(rng, topk):
    imgs, segs, _ = scene(rng)
    ex = port.PatchEndpointsExtractor({"device": "cpu"})
    d0 = ex.compute_descinfo(imgs[0], segs[0])
    d1 = ex.compute_descinfo(imgs[1], segs[1])
    m = port.NNEndpointsMatcher(ex, {"topk": topk, "min_score": 0.1,
                                     "device": "cpu"})
    rm = ref.NNEndpointsMatcher(ref.PatchEndpointsExtractor({}),
                                {"topk": topk, "min_score": 0.1})
    got, want = m.match_pair(d0, d1), rm.match_pair(d0, d1)
    assert len(got) and as_pairs(got) == as_pairs(want)
    empty = ex.compute_descinfo(imgs[0], np.zeros((0, 5)))
    assert m.match_pair(d0, empty).shape == (0, 2)


def test_nn_endpoints_match_all_neighbors_files(rng, tmp_path):
    """The batched match_all_neighbors override writes the same
    matches_{id}.npy files as the generic per-pair loop and as the JAX
    matcher, from the same descinfo files."""
    imgs, segs, nbrs = scene(rng, score=False)
    segs[3] = np.zeros((0, 4))
    ex = port.PatchEndpointsExtractor({"device": "cpu"})
    dfolder = str(tmp_path / "descinfos")
    descinfos = port.compute_descinfos_batch(imgs, segs, device="cpu")
    for i in imgs:
        ex.save_descinfo(dfolder, i, descinfos[i])
    cfg = {"method": "nn_endpoints", "topk": 2, "min_score": -10.0}
    m = get_matcher(cfg, ex, device="cpu")
    folder_b = m.match_all_neighbors(str(tmp_path / "b"), list(imgs), nbrs,
                                     dfolder)
    folder_g = BaseMatcher.match_all_neighbors(
        m, str(tmp_path / "g"), list(imgs), nbrs, dfolder)
    rm = ref_get_matcher(cfg, ref.PatchEndpointsExtractor({}))
    folder_r = rm.match_all_neighbors(str(tmp_path / "r"), list(imgs), nbrs,
                                      dfolder)
    for i in imgs:
        mb, mg = m.read_match(folder_b, i), m.read_match(folder_g, i)
        mr = rm.read_match(folder_r, i)
        assert set(mb) == set(mg) == set(mr) == set(nbrs[i])
        for ng in mb:
            assert as_pairs(mb[ng]) == as_pairs(mg[ng]) == as_pairs(mr[ng])
    # a second call with skip_exists leaves the files alone
    assert m.match_all_neighbors(str(tmp_path / "b"), list(imgs), nbrs,
                                 dfolder, skip_exists=True) == folder_b


def test_merge_lines_matches_reference(rng):
    segs = np.array([[0, 0, 40, 0, 1.0], [45, 0.5, 100, 0.5, 1.0],
                     [0, 50, 100, 50, 1.0], [10, 80, 60, 95, 1.0],
                     [62, 95.5, 90, 104, 1.0]])
    got, want = merge_lines(segs), ref_merge_lines(segs)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert merge_lines(segs[:1]).shape == (1, 4)
