"""Fit and merge, the port against the JAX package on the same numpy
inputs: the 2D linker check, ``merge_to_linetracks``, the list remerge,
and ``line_fitnmerge`` of both packages from the same PNGs and depth
maps.  Fitted segments and aggregated lines come from a TLS axis whose
sign is free, so segments are compared up to endpoint order."""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from limap_tpu.base import CameraViewsBatch as JViews
from limap_tpu.base import LineLinker as JLinker
from limap_tpu.base import line_linker as jll
from limap_tpu.base.depth_reader_base import ArrayDepthReader as JDepth
from limap_tpu.base.image_collection import ImageCollection as RefCollection
from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.base.linetrack import LineTrack as JTrack
from limap_tpu.merging import merge_to_linetracks as j_merge
from limap_tpu.merging import remerge as j_remerge
from limap_tpu.merging import set_uncertainty_segs3d as j_set_unc
from limap_tpu.runners import line_fitnmerge as j_line_fitnmerge
from limap_tpu.util import io as ref_io
from limap_tpu_torch.base import ArrayDepthReader, LineLinker
from limap_tpu_torch.base import line_linker as tll
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.linetrack import LineTrack
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.merging import (merge_to_linetracks, remerge,
                                     set_uncertainty_segs3d)
from limap_tpu_torch.ops import linker_edges as le
from limap_tpu_torch.runners import line_fitnmerge
from limap_tpu_torch.testing import fitnmerge
from limap_tpu_torch.util import io
from limap_tpu_torch.util.config import default_fitnmerge_config

from test_merging import make_scene as merging_scene
from test_pipeline_e2e import track_to_gt_error
from test_torch_runner import make_scene as runner_scene

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfgs", "fitnmerge", "default.yaml")
t = lambda x: torch.as_tensor(np.array(x))

LINKER_2D = {
    "defaults": {},
    "fitnmerge": default_fitnmerge_config()["merging"]["linker2d"],
    "innerseg_no_smart": {"th_angle": 6.0, "use_smartangle": False,
                          "use_innerseg": True, "th_innerseg": 3.0,
                          "th_perp": 4.0, "th_overlap": 0.2},
}


def key(track):
    return tuple(zip(track.image_id_list, track.line_id_list))


def line_error(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a[::-1] - b).max())


def test_default_fitnmerge_config_equals_the_yaml_and_is_fresh():
    with open(CFG) as f:
        assert default_fitnmerge_config() == yaml.safe_load(f)
    a = default_fitnmerge_config()
    a["merging"]["linker3d"]["th_angle"] = -1
    assert default_fitnmerge_config()["merging"]["linker3d"]["th_angle"] == 8


@pytest.mark.parametrize("name", sorted(LINKER_2D))
def test_check_2d_and_linker_match_jax(name):
    """Random 2D pairs around a base segment (angles, offsets and shifts
    spanning each threshold) and 3D pairs with uncertainties."""
    rng = np.random.default_rng(7)
    n = 4000
    s = rng.uniform(0, 600, (n, 2))
    d = rng.normal(size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ln = rng.uniform(5, 80, (n, 1))
    ang = np.radians(rng.uniform(-12, 12, n))
    rot = np.stack([np.cos(ang) * d[:, 0] - np.sin(ang) * d[:, 1],
                    np.sin(ang) * d[:, 0] + np.cos(ang) * d[:, 1]], 1)
    off = rng.normal(size=(n, 1)) * 3 * np.stack([-d[:, 1], d[:, 0]], 1)
    shift = rng.uniform(-1.2, 1.2, (n, 1)) * ln * d
    a2 = np.stack([s, s + d * ln], 1).astype(np.float32)
    b2 = np.stack([s + off + shift, s + off + shift + rot * ln * 0.8],
                  1).astype(np.float32)
    a3 = rng.normal(size=(n, 2, 3)).astype(np.float32)
    b3 = (a3 + rng.normal(size=(n, 2, 3)) * 0.05).astype(np.float32)
    u = rng.uniform(0.5, 2.0, (2, n)).astype(np.float32)
    cfg2 = LINKER_2D[name]
    j = JLinker.from_dicts(cfg2, None)
    p = LineLinker.from_dicts(cfg2, None)
    assert p.linker_2d.__dict__ == j.linker_2d.__dict__
    ja, jb = (JSegments(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]))
              for x in (a2, b2))
    pa, pb = (Segments(t(x[:, 0]), t(x[:, 1])) for x in (a2, b2))
    ref = np.asarray(j.check_2d(ja, jb))
    ours = p.check_2d(pa, pb).numpy()
    assert 0.05 < ref.mean() < 0.95
    assert np.array_equal(ours, ref)
    assert np.array_equal(tll.check_2d(pa, pb, p.linker_2d).numpy(),
                          np.asarray(jll.check_2d(ja, jb, j.linker_2d)))
    np.testing.assert_allclose(p.score_2d(pa, pb).numpy(),
                               np.asarray(j.score_2d(ja, jb)), atol=1e-5)
    ja3, jb3 = (JSegments(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]),
                          uncertainty=jnp.asarray(uu))
                for x, uu in ((a3, u[0]), (b3, u[1])))
    pa3, pb3 = (Segments(t(x[:, 0]), t(x[:, 1]), uncertainty=t(uu))
                for x, uu in ((a3, u[0]), (b3, u[1])))
    assert np.array_equal(p.check_3d(pa3, pb3).numpy(),
                          np.asarray(j.check_3d(ja3, jb3)))
    np.testing.assert_allclose(p.score_3d(pa3, pb3).numpy(),
                               np.asarray(j.score_3d(ja3, jb3)), atol=1e-5)
    assert p.linker_3d.to_avgtest_merging() == \
        LineLinker().linker_3d.to_avgtest_merging()
    assert p.linker_3d.to_avgtest_merging().__dict__ == \
        j.linker_3d.to_avgtest_merging().__dict__


def merge_both(rng, n_views, n_lines, linker_dicts=(None, None),
               var2d=15.0, drop=()):
    """merge_to_linetracks of both packages on test_merging.make_scene
    (all views neighbours of each other; ``drop`` masks (image, line)
    slots)."""
    views, batch, gt, l2d, l3d = merging_scene(rng, n_views, n_lines)
    vb = JViews(batch.kvec[:, None], batch.qvec[:, None], batch.tvec[:, None])
    j3 = j_set_unc(l3d, vb, var2d=var2d)
    mask = np.ones((n_views, n_lines), bool)
    for i, li in drop:
        mask[i, li] = False
    nbrs = np.stack([np.setdiff1d(np.arange(n_views), [i])
                     for i in range(n_views)])
    ref = j_merge(l2d, j3, jnp.asarray(mask), batch,
                  jnp.asarray(nbrs, jnp.int32),
                  jnp.ones(nbrs.shape, bool), JLinker.from_dicts(*linker_dicts))
    pv = CameraViewsBatch(*(t(x) for x in batch))
    p3 = set_uncertainty_segs3d(
        Segments(t(l3d.start), t(l3d.end)),
        CameraViewsBatch(*(x[:, None] for x in pv)), var2d=var2d)
    np.testing.assert_allclose(p3.uncertainty.numpy(),
                               np.asarray(j3.uncertainty), rtol=1e-6)
    ours = merge_to_linetracks(
        Segments(t(l2d.start), t(l2d.end)), p3, t(mask), pv, t(nbrs),
        torch.ones(nbrs.shape, dtype=torch.bool),
        LineLinker.from_dicts(*linker_dicts))
    return ref, ours, pv, batch


@pytest.mark.parametrize("linker_dicts,drop", [
    ((None, None), ()),
    ((None, None), ((0, 1), (2, 3), (3, 0))),
    ((LINKER_2D["fitnmerge"],
      default_fitnmerge_config()["merging"]["linker3d"]), ()),
])
def test_merge_to_linetracks_matches_jax(linker_dicts, drop):
    rng = np.random.default_rng(0)
    ref, ours, _, _ = merge_both(rng, 5, 8, linker_dicts, drop=drop)
    assert len(ref) >= 6
    assert [key(x) for x in ours] == [key(x) for x in ref]
    for a, b in zip(ours, ref):
        assert a.node_id_list == b.node_id_list
        assert a.score_list == pytest.approx(b.score_list, rel=1e-6)
        assert line_error(a.line, b.line) <= 1e-5


def test_track_filters_by_images_and_sensitivity_match_jax():
    from limap_tpu.base.linetrack import tracks_to_batch as j_to_batch
    from limap_tpu.merging import check_sensitivity as j_sens
    from limap_tpu.merging import filter_tracks_by_num_images as j_num
    from limap_tpu_torch.base.linetrack import tracks_to_batch
    from limap_tpu_torch.merging import (check_sensitivity,
                                         filter_tracks_by_num_images)
    rng = np.random.default_rng(2)
    ref, ours, pv, batch = merge_both(rng, 5, 8, drop=((0, 1), (2, 1)))
    id2idx = {i: i for i in range(5)}
    jb = j_to_batch(ref, id2idx)
    tb = tracks_to_batch(ours, id2idx, device="cpu")
    T, S = jb.mask.shape
    for n in (3, 4, 5):
        assert np.array_equal(
            filter_tracks_by_num_images(tb, n).track_mask.numpy()[:T],
            np.asarray(j_num(jb, n).track_mask))
    for th in (1.0, 20.0, 70.0):
        assert np.array_equal(check_sensitivity(tb, pv, th).numpy()[:T, :S],
                              np.asarray(j_sens(jb, batch, th)))


def test_edge_bits_give_argwhere_order():
    rng = np.random.default_rng(4)
    ok_self = rng.random((3, 40, 40)) < 0.05
    ok_cross = rng.random((3, 2, 40, 40)) < 0.05
    nbrs = torch.as_tensor([[1, 2], [0, 2], [1, 0]])
    bits = le.pack_bits(t(ok_self)), le.pack_bits(t(ok_cross))
    assert bits[0].shape == (3, 40, 2) and bits[0].dtype == torch.int32
    assert np.array_equal(le.unpack_bits(bits[0], 40).numpy(), ok_self)
    es, ec = np.argwhere(ok_self), np.argwhere(ok_cross)
    ref = np.concatenate([
        np.stack([es[:, 0] * 40 + es[:, 1], es[:, 0] * 40 + es[:, 2]], 1),
        np.stack([ec[:, 0] * 40 + ec[:, 2],
                  nbrs.numpy()[ec[:, 0], ec[:, 1]] * 40 + ec[:, 3]], 1)])
    assert np.array_equal(le.edges_from_bits(*bits, nbrs, 40).numpy(), ref)
    # the top bit of a word
    one = torch.zeros((1, 1, 32), dtype=torch.bool)
    one[0, 0, 31] = True
    assert int(le.pack_bits(one)) == -2 ** 31


def split_tracks(tracks, rng, track_cls):
    """Each track of >= 4 lines cut in two at a random point."""
    out = []
    for tr in tracks:
        n = tr.count_lines()
        cut = rng.integers(2, n - 1) if n >= 4 else n
        for lo, hi in ((0, cut), (cut, n)):
            if hi <= lo:
                continue
            part = track_cls()
            part.line = np.asarray(tr.line)
            for name in ("image_id_list", "line_id_list", "line2d_list",
                         "line3d_list", "score_list", "node_id_list"):
                setattr(part, name, list(getattr(tr, name))[lo:hi])
            out.append(part)
    return out


def to_port(tracks):
    return [LineTrack(line=x.line, image_id_list=x.image_id_list,
                      line_id_list=x.line_id_list, line2d_list=x.line2d_list,
                      line3d_list=x.line3d_list, score_list=x.score_list,
                      node_id_list=x.node_id_list) for x in tracks]


@pytest.mark.parametrize("num_outliers", [0, 2])
def test_list_remerge_matches_jax(num_outliers):
    """Tracks cut in two merge back, in JAX's group order, with the same
    re-aggregated lines."""
    from limap_tpu.base.line_linker import LineLinker3dConfig as J3
    from limap_tpu_torch.base.line_linker import LineLinker3dConfig as T3
    rng = np.random.default_rng(0)
    ref, _, pv, batch = merge_both(rng, 6, 8)
    parts = split_tracks(ref, np.random.default_rng(1), JTrack)
    assert len(parts) > len(ref)
    id2idx = {i: i for i in range(6)}
    merged_j = j_remerge(parts, batch, id2idx, J3(), num_outliers)
    merged_t = remerge(to_port(parts), pv, id2idx, T3(), num_outliers)
    assert len(merged_j) < len(parts)
    assert [key(x) for x in merged_t] == [key(x) for x in merged_j]
    for a, b in zip(merged_t, merged_j):
        assert a.node_id_list == b.node_id_list
        assert line_error(a.line, b.line) <= 1e-5


# ------------------------------------------------------------- the runner
def depth_readers(imagecols, cls):
    return {i: cls(fitnmerge.wall_depth(imagecols.camview(i)))
            for i in imagecols.get_img_ids()}


def small_cfg(out):
    cfg = default_fitnmerge_config()
    cfg.update(output_dir=str(out), max_image_dim=-1, n_visible_views=3)
    return cfg


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    """JAX's line_fitnmerge on the 5-view scene of test_torch_runner,
    then the port's twice: from JAX's detections and fitted segments,
    and on its own."""
    tmp = tmp_path_factory.mktemp("fitnmerge")
    imagecols, gt = runner_scene(np.random.default_rng(0), tmp, n_views=5,
                                 n_lines=5)
    ref_cols = RefCollection.from_dict(imagecols.as_dict())
    ref_tracks = j_line_fitnmerge(small_cfg(tmp / "ref"), ref_cols,
                                  depth_readers(imagecols, JDepth))
    cfg = small_cfg(tmp / "port_loaded")
    cfg.update(load_dir=str(tmp / "ref"), load_det=True, load_fit=True)
    loaded = line_fitnmerge(cfg, imagecols, None, device="cpu")
    own = line_fitnmerge(small_cfg(tmp / "port"), imagecols,
                         depth_readers(imagecols, ArrayDepthReader),
                         device="cpu")
    return tmp, imagecols, gt, ref_tracks, loaded, own


def test_runner_from_jax_fitted_segments_matches_jax_exactly(runner_runs):
    tmp, imagecols, gt, ref_tracks, loaded, _ = runner_runs
    assert len(ref_tracks) >= 5
    assert [key(x) for x in loaded] == [key(x) for x in ref_tracks]
    for a, b in zip(loaded, ref_tracks):
        assert line_error(a.line, b.line) <= 1e-4
    # the saved folders, read by the other package's io
    port_folder = str(tmp / "port_loaded" / "fitnmerge_finaltracks")
    ref_folder = str(tmp / "ref" / "fitnmerge_finaltracks")
    from_port = ref_io.read_folder_linetracks_with_info(port_folder)
    from_ref = io.read_folder_linetracks_with_info(ref_folder)
    assert [key(x) for x in from_port[0]] == [key(x) for x in ref_tracks]
    assert [key(x) for x in from_ref[0]] == [key(x) for x in loaded]
    assert from_port[2].NumImages() == from_ref[2].NumImages() == 5
    for name in ("fitnmerge_alltracks.txt", "fitnmerge_lines_nv3.obj",
                 "fitnmerge_metrics.json"):
        assert (tmp / "port_loaded" / name).is_file(), name
    # loaded fits are not written again, as in JAX
    assert not (tmp / "port_loaded" / "fitted_3d_segs.npy").exists()
    with open(tmp / "port_loaded" / "fitnmerge_metrics.json") as f:
        m = json.load(f)
    assert set(m["stages_s"]) == {"detect", "merge_to_tracks"}
    assert m["tracks"]["n_tracks"] == len(loaded)


def test_runner_own_fit_holds_jax_outcome(runner_runs):
    tmp, imagecols, gt, ref_tracks, _, own = runner_runs
    assert abs(len(own) - len(ref_tracks)) <= 1
    good = [x for x in own if x.count_images() >= 3]
    assert len(good) >= len(gt) - 1
    errs = sorted(track_to_gt_error(x, gt) for x in good)
    assert np.median(errs[:len(gt)]) < 0.5
    assert max(errs) < 0.5
    with open(tmp / "port" / "fitnmerge_metrics.json") as f:
        assert set(json.load(f)["stages_s"]) == {"detect", "fit_3d_segs",
                                                 "merge_to_tracks"}
    fitted = io.read_npy(str(tmp / "port" / "fitted_3d_segs.npy")).item()
    ref_fit = ref_io.read_npy(str(tmp / "ref" / "fitted_3d_segs.npy")).item()
    assert set(fitted) == set(ref_fit) == set(range(5))
    for i in fitted:
        ok = np.abs(fitted[i]).sum((1, 2)) > 0
        ok_ref = np.abs(ref_fit[i]).sum((1, 2)) > 0
        assert abs(int(ok.sum()) - int(ok_ref.sum())) <= 1


def test_point_map_runner_equals_depth_runner(runner_runs, tmp_path):
    """A point map that holds each pixel's lifted depth gives the same
    fit as the depth map up to its own median threshold; the runner goes
    through the saved detections and fitted segments."""
    _, imagecols, gt, _, _, own = runner_runs
    readers = {}
    from limap_tpu_torch.base import ArrayP3DReader
    for i in imagecols.get_img_ids():
        view = imagecols.camview(i)
        depth = fitnmerge.wall_depth(view)
        fx, fy, cx, cy = view.cam.kvec()
        vs, us = np.mgrid[:view.h(), :view.w()]
        cam = np.stack([(us - cx) / fx * depth, (vs - cy) / fy * depth,
                        depth], -1)
        world = (cam - view.pose.tvec) @ view.pose.R()
        readers[i] = ArrayP3DReader(world.astype(np.float32))
    from limap_tpu_torch.runners import line_fitting_with_points3d
    tracks = line_fitting_with_points3d(small_cfg(tmp_path / "p3d"),
                                        copy.deepcopy(imagecols), readers,
                                        device="cpu")
    good = [x for x in tracks if x.count_images() >= 3]
    assert len(good) >= len(gt) - 1
    errs = sorted(track_to_gt_error(x, gt) for x in good)
    assert np.median(errs[:len(gt)]) < 0.5
    assert (tmp_path / "p3d" / "fitted_3d_segs.npy").is_file()
