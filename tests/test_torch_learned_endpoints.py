"""The port's learned endpoint extractor and matchers against the JAX
package on the CPU: SuperPointEndpointsExtractor, SuperGlueEndpointsMatcher
(topk 0: the optimal transport over line scores; topk > 0: each line's
best) and SinkhornEndpointsMatcher, with the reference's parameters
carried across by ``convert``; and the point model from SuperPoint
features (``run_sfm_with_known_poses(weight_path=...)``).

Tolerances: descriptors within 1e-5 (fp32 convolutions in other orders);
match lists equal, top-k lists compared as sets per line (a stable sort
against numpy's unstable one)."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from limap_tpu.line2d import get_extractor as ref_get_extractor
from limap_tpu.line2d import get_matcher as ref_get_matcher
from limap_tpu.point2d import superglue as ref_sg
from limap_tpu.pointsfm import sfm as ref_sfm
from limap_tpu_torch import convert
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.line2d import get_extractor, get_matcher
from limap_tpu_torch.point2d import superglue as sg
from limap_tpu_torch.point2d.superpoint import random_state_dict
from limap_tpu_torch.pointsfm import run_sfm_with_known_poses
from limap_tpu_torch.testing import pipeline
from limap_tpu_torch.testing.learned import superglue_random_state_dict
from torch_threads import two_torch_threads  # noqa: F401

DESC_TOL = 1e-5


class _Fake:
    def __init__(self, name):
        self.name = name

    def get_module_name(self):
        return self.name


@pytest.fixture(scope="module")
def scene():
    cols, imgs, _, _ = pipeline.build_scene(n_views=3, hw=(120, 160))
    rng = np.random.default_rng(0)
    segs = {i: np.concatenate([rng.uniform(4, [156, 116, 156, 116], (12, 4)),
                               rng.uniform(0.5, 1, (12, 1))], 1)
            for i in imgs}
    return cols, imgs, segs


@pytest.fixture(scope="module")
def extractors():
    ref = ref_get_extractor({"method": "superpoint_endpoints"})
    port = get_extractor({"method": "superpoint_endpoints"}, device="cpu")
    port.sp.net.load_state_dict(convert.superpoint_state_dict(
        jax.tree_util.tree_map(np.asarray, ref.sp.params)))
    return ref, port


def test_superpoint_endpoints_descinfo_matches_jax(extractors, scene):
    ref, port = extractors
    _, imgs, segs = scene
    for i in imgs:
        a = ref.compute_descinfo(imgs[i], segs[i])
        b = port.compute_descinfo(imgs[i], segs[i])
        assert tuple(a["image_shape"]) == tuple(b["image_shape"])
        assert np.array_equal(a["lines"], b["lines"])
        np.testing.assert_allclose(b["lines_score"], a["lines_score"],
                                   rtol=1e-12)
        assert b["endpoints_desc"].shape == (256, 24)
        np.testing.assert_allclose(b["endpoints_desc"], a["endpoints_desc"],
                                   atol=DESC_TOL)
    empty = port.compute_descinfo(imgs[0], np.zeros((0, 5)))
    assert empty["endpoints_desc"].shape == (256, 0)


def _descinfos(seed, n1=11, n2=13, shared=8):
    """Two descinfos sharing ``shared`` lines (endpoints and
    descriptors), the second's in another order, with noise."""
    rng = np.random.default_rng(seed)

    def one(n):
        desc = rng.normal(size=(256, 2 * n))
        return {"image_shape": (480, 640),
                "lines": rng.uniform(50, 400, (2 * n, 2)),
                "lines_score": rng.uniform(0.3, 1.0, n),
                "endpoints_desc": (desc / np.linalg.norm(desc, axis=0))}

    a, b = one(n1), one(n2)
    perm = rng.permutation(n2)[:shared]
    for k, j in enumerate(perm):
        for key in ("lines", "endpoints_desc"):
            src = a[key][..., 2 * k:2 * k + 2] if key == "endpoints_desc" \
                else a[key][2 * k:2 * k + 2]
            if key == "endpoints_desc":
                b[key][:, 2 * j:2 * j + 2] = src + rng.normal(
                    size=src.shape) * 0.01
            else:
                b[key][2 * j:2 * j + 2] = src + rng.normal(size=src.shape)
    return a, b


@pytest.fixture(scope="module")
def superglue_pair():
    sd = superglue_random_state_dict(7)
    params = ref_sg.params_from_state_dict({k: v.numpy()
                                            for k, v in sd.items()})
    return params, sg.params_from_state_dict(convert.superglue_state_dict(
        params))


@pytest.mark.parametrize("topk", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_superglue_endpoints_matches_jax(superglue_pair, topk, seed,
                                         recwarn):
    jp, tp = superglue_pair
    d1, d2 = _descinfos(seed)
    ref = ref_get_matcher({"method": "superglue_endpoints", "topk": topk},
                          _Fake("superpoint_endpoints"))
    ref.sg.params = {k: jnp.asarray(v) for k, v in jp.items()}
    port = get_matcher({"method": "superglue_endpoints", "topk": topk},
                       _Fake("superpoint_endpoints"), device="cpu")
    port.sg.params = tp
    a, b = ref.match_pair(d1, d2), port.match_pair(d1, d2)
    if topk == 0:
        assert np.array_equal(np.asarray(a), b)
        assert len(b) >= 5
    else:
        assert a.shape == b.shape == (11 * 3, 2)
        for i in range(11):
            assert set(a[a[:, 0] == i, 1]) == set(b[b[:, 0] == i, 1])
    assert any("WITHOUT a checkpoint" in str(w.message) for w in recwarn)
    empty = dict(d1, endpoints_desc=np.zeros((256, 0)))
    assert port.match_pair(empty, d2).shape == (0, 2)


def test_superglue_endpoints_needs_superpoint_descriptors():
    with pytest.raises(ValueError, match="superpoint_endpoints"):
        get_matcher({"method": "superglue_endpoints"},
                    _Fake("patch_endpoints"), device="cpu")


def test_superglue_endpoints_reads_its_checkpoint(tmp_path, recwarn):
    path = str(tmp_path / "superglue_outdoor.pth")
    torch.save(superglue_random_state_dict(1), path)
    # the config's superglue_weight_path, or the registry's weight_path
    for options, wp in (({"superglue_weight_path": path}, None), ({}, path)):
        m = get_matcher({"method": "superglue_endpoints", **options},
                        _Fake("superpoint_endpoints"), weight_path=wp,
                        device="cpu")
        assert torch.equal(m.sg.params["final_proj.weight"],
                           superglue_random_state_dict(1)
                           ["final_proj.weight"])
    assert not recwarn.list


@pytest.mark.parametrize("kind", ["patch", "superpoint"])
def test_sinkhorn_endpoints_matches_jax(kind, extractors, scene):
    _, imgs, segs = scene
    if kind == "superpoint":
        ref_ex, port_ex = extractors
    else:
        ref_ex = ref_get_extractor({"method": "patch_endpoints"})
        port_ex = get_extractor({"method": "patch_endpoints"}, device="cpu")
    infos = {i: port_ex.compute_descinfo(imgs[i], segs[i]) for i in imgs}
    ref = ref_get_matcher({"method": "sinkhorn_endpoints", "topk": 0,
                           "match_threshold": 0.0}, ref_ex)
    port = get_matcher({"method": "sinkhorn_endpoints", "topk": 0,
                        "match_threshold": 0.0}, port_ex, device="cpu")
    total = 0
    for i, j in ((0, 1), (1, 2), (0, 2)):
        a = np.asarray(ref.match_pair(infos[i], infos[j]))
        b = port.match_pair(infos[i], infos[j])
        assert np.array_equal(a, b)
        total += len(b)
    assert total > 0


def test_sinkhorn_endpoints_runs_the_solver_on_every_pair(extractors, scene,
                                                          tmp_path):
    """Divergence from JAX on purpose: the reference's sinkhorn_endpoints
    inherits nn_endpoints' batched top-k override, so with topk > 0 (the
    default 10) its match_all_neighbors never runs the Sinkhorn solve and
    returns nn_endpoints' matches; the port's runs match_pair on every
    pair."""
    _, imgs, segs = scene
    port_ex = get_extractor({"method": "patch_endpoints"}, device="cpu")
    ref_ex = ref_get_extractor({"method": "patch_endpoints"})
    folder = str(tmp_path / "desc")
    for i in imgs:
        port_ex.save_descinfo(folder, i,
                              port_ex.compute_descinfo(imgs[i], segs[i]))
    nbrs = {i: [j for j in imgs if j != i] for i in imgs}
    cfg = {"topk": 10, "match_threshold": 0.0}

    def run(matcher, name):
        out = matcher.match_all_neighbors(str(tmp_path / name), list(imgs),
                                          nbrs, folder)
        return {i: matcher.read_match(out, i) for i in imgs}

    ref_sk = run(ref_get_matcher({"method": "sinkhorn_endpoints", **cfg},
                                 ref_ex), "ref_sk")
    ref_nn = run(ref_get_matcher({"method": "nn_endpoints", **cfg}, ref_ex),
                 "ref_nn")
    port_sk = run(get_matcher({"method": "sinkhorn_endpoints", **cfg},
                              port_ex, device="cpu"), "port_sk")
    port = get_matcher({"method": "sinkhorn_endpoints", **cfg}, port_ex,
                       device="cpu")
    infos = {i: port_ex.read_descinfo(folder, i) for i in imgs}
    for i in imgs:
        for j in nbrs[i]:
            assert np.array_equal(ref_sk[i][j], ref_nn[i][j])
            assert np.array_equal(port_sk[i][j],
                                  port.match_pair(infos[i], infos[j]))
            assert len(port_sk[i][j]) <= 12 < len(ref_sk[i][j])


def test_sfm_with_superpoint_weights_equals_jax(tmp_path):
    """run_sfm_with_known_poses(weight_path=...) builds SuperPoint from the
    file, as the reference does, and gives its point model."""
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(random_state_dict(2), path)
    cols, imgs, _, _ = pipeline.build_scene(n_views=3, hw=(120, 160))
    from limap_tpu.base.image_collection import ImageCollection as RefCols
    ref_cols = RefCols.from_dict(cols.as_dict())
    port = run_sfm_with_known_poses(cols, images=imgs, weight_path=path,
                                    n_neighbors=2, device="cpu")
    ref = ref_sfm.run_sfm_with_known_poses(ref_cols, images=imgs,
                                           weight_path=path, n_neighbors=2)
    assert len(port) > 0
    assert list(port) == list(ref)
    for pid in ref:
        assert port[pid]["image_ids"] == ref[pid]["image_ids"]
        np.testing.assert_allclose(port[pid]["xyz"], ref[pid]["xyz"],
                                   atol=1e-4)
    assert isinstance(cols, ImageCollection) and os.path.isfile(path)
