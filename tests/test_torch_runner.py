"""The slice as a whole: ``line_triangulation`` of both packages from the
same rendered images (tpu_lsd -> patch_endpoints -> nn_endpoints ->
triangulate -> tracks -> filters -> BA -> save), on the CPU."""

import copy
import json
import os

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import bench_pipeline
from limap_tpu.base.image_collection import ImageCollection as RefCollection
from limap_tpu.runners import line_triangulation as ref_line_triangulation
from limap_tpu.util import io as ref_io
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.runners import functions as runners
from limap_tpu_torch.runners import line_triangulation
from limap_tpu_torch.testing import pipeline
from limap_tpu_torch.util import io
from limap_tpu_torch.util.config import load_config
from limap_tpu_torch.util.profiler import StageProfiler

from test_pipeline_e2e import track_to_gt_line_error

H, W = 240, 320
WALL_Z = 10.0
CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfgs", "triangulation", "default.yaml")


def make_scene(rng, folder, n_views=5, n_lines=5, hw=(H, W)):
    """The cameras and GT lines of tests/test_pipeline_e2e.py::make_scene
    at half its image size (focal length halved with it), strokes drawn
    by the port's rasteriser, images written as PNG so both packages
    read the same pixels."""
    H, W = hw
    f = 600.0 * W / 640
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    cams = {0: Camera(K=K, hw=(H, W), cam_id=0)}
    gt = []
    slope = 0.6
    for i in range(n_lines):
        y = -3.4 + 6.0 * i / max(n_lines - 1, 1)
        x1 = rng.uniform(-4.5, -3.0)
        x2 = rng.uniform(1.5, 3.0)
        gt.append([[x1, y, WALL_Z],
                   [x2, y + slope * (x2 - x1) * 0.5, WALL_Z]])
    gt = np.asarray(gt)
    images = {}
    for k in range(n_views):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.02).as_matrix()
        C = np.array([1.2 * (k - n_views / 2),
                      1.0 * ((k % 2) - 0.5) + 0.2 * k, 0.3 * k])
        t = -R @ C
        img = np.full((H, W), 230, np.uint8)
        for li, line in enumerate(gt):
            p1 = K @ (R @ line[0] + t)
            p2 = K @ (R @ line[1] + t)
            pipeline.draw_line(img, (p1[:2] / p1[2]).astype(int),
                               (p2[:2] / p2[2]).astype(int), 20 + 28 * li)
        img = np.clip(img.astype(np.float64)
                      + rng.normal(size=(H, W)) * 2, 0, 255).astype(np.uint8)
        name = os.path.join(str(folder), f"img_{k}.png")
        cv2.imwrite(name, img)
        images[k] = CameraImage(0, CameraPose(R=R, tvec=t), name)
    return ImageCollection(cams, images), gt


def small_cfg(out):
    cfg = load_config(CFG)
    cfg["output_dir"] = str(out)
    cfg["max_image_dim"] = -1
    cfg["n_visible_views"] = 3
    cfg["n_neighbors"] = 4
    f2d = cfg["triangulation"]["filtering2d"]
    f2d["th_sv_num_supports"] = 2
    f2d["th_overlap_num_supports"] = 2
    # toy scale: only 4 neighbours, so the support-sum threshold of the
    # 100-image default is too strict
    cfg["triangulation"]["fullscore_th"] = 0.5
    cfg["refinement"]["min_num_images"] = 3
    return cfg


def files_under(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


def nearest_line_distance(track, others):
    """Endpoint distance of a track's line to the closest of ``others``,
    either way round."""
    return min(min(np.abs(track.line - o.line).max(),
                   np.abs(track.line[::-1] - o.line).max()) for o in others)


def test_line_triangulation_matches_reference_from_pixels(rng, tmp_path):
    imagecols, gt = make_scene(rng, tmp_path, n_views=6, n_lines=6)
    ref_cols = RefCollection.from_dict(imagecols.as_dict())
    cfg = small_cfg(tmp_path / "port")
    ref_cfg = small_cfg(tmp_path / "ref")
    tracks = line_triangulation(copy.deepcopy(cfg), imagecols, device="cpu")
    ref_tracks = ref_line_triangulation(copy.deepcopy(ref_cfg), ref_cols)

    # detections: the same files, the same segments to 0.05 px
    seg_dir = os.path.join("line_detections", "tpu_lsd", "segments")
    segs = io.read_all_segments_from_folder(str(tmp_path / "port" / seg_dir))
    ref_segs = ref_io.read_all_segments_from_folder(
        str(tmp_path / "ref" / seg_dir))
    assert set(segs) == set(ref_segs) == set(range(6))
    for i in segs:
        assert len(segs[i]) == len(ref_segs[i]) >= 3
        np.testing.assert_allclose(segs[i], ref_segs[i], atol=0.05)

    # tracks: as many good ones (one of slack: a filter threshold may
    # fall either way), every good line within 5 cm of a reference line
    # (LM accept tests flip under rounding; ~10 m depth), GT error under
    # the e2e test's gate.  With descriptor matches over 4 neighbours at
    # this image size only some of the 6 lines gather 3 views, in either
    # package (measured: 4 tracks, 2 of them good, in both).
    good = [t for t in tracks if t.count_images() >= 3]
    ref_good = [t for t in ref_tracks if t.count_images() >= 3]
    assert len(good) >= 2
    assert abs(len(good) - len(ref_good)) <= 1
    assert abs(len(tracks) - len(ref_tracks)) <= 2
    far = [t for t in good if nearest_line_distance(t, ref_tracks) > 0.05]
    assert len(far) <= 1, [t.line for t in far]
    errs = sorted(track_to_gt_line_error(t, gt) for t in good)
    assert np.median(errs[:len(gt)]) < 0.5

    # the same files written, readable by the other package
    port_files = files_under(tmp_path / "port")
    ref_files = files_under(tmp_path / "ref")
    strip = lambda fs: sorted(f for f in fs if "track_" not in f)
    assert strip(port_files) == strip(ref_files)
    for name in ("imagecols.npy", "metainfos.txt", "alltracks.txt",
                 "metrics.json", "triangulated_lines_nv3.obj",
                 os.path.join("finaltracks", "config.npy"),
                 os.path.join("finaltracks", "all_2d_segs.npy")):
        assert name in port_files, name
    assert (tmp_path / "port" / "metainfos.txt").read_text() == \
        (tmp_path / "ref" / "metainfos.txt").read_text()
    loaded, lcfg, lcols, lsegs = ref_io.read_folder_linetracks_with_info(
        str(tmp_path / "port" / "finaltracks"))
    assert len(loaded) == len(tracks) and lcols.NumImages() == 6
    assert lcfg["triangulation"]["var2d"] == 2.0   # tpu_lsd's default
    with open(tmp_path / "port" / "metrics.json") as f:
        m = json.load(f)
    assert set(m["stages_s"]) == {
        "detect_describe", "match", "triangulate_score", "track_build",
        "filters_remerge", "bundle_adjustment"}
    assert m["tracks"]["n_tracks"] == len(tracks)
    obj = io.load_obj(str(tmp_path / "port" / "triangulated_lines_nv3.obj"))
    assert len(obj) == len(good)

    # stage caches: a second run loads detections and matches from the
    # folder and gives the same tracks
    cfg2 = small_cfg(tmp_path / "port2")
    cfg2.update(load_dir=str(tmp_path / "port"), load_det=True,
                load_match=True, load_meta=True)
    again = line_triangulation(cfg2, imagecols, neighbors=None,
                               device="cpu")
    assert len(again) == len(tracks)
    for a, b in zip(again, tracks):
        np.testing.assert_allclose(a.line, b.line, atol=1e-5)


def test_runner_refuses_what_is_not_ported(rng, tmp_path):
    imagecols, _ = make_scene(rng, tmp_path, n_views=2, n_lines=2)
    # the exhaustive matcher is ported (tests/test_torch_exhaustive.py)
    cfg = small_cfg(tmp_path / "use_vp")
    cfg["triangulation"]["use_vp"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        line_triangulation(cfg, imagecols, device="cpu")
    cfg = runners.setup(small_cfg(tmp_path / "sfm"))
    with pytest.raises(NotImplementedError, match="pointsfm"):
        runners.compute_sfminfos(cfg, imagecols, points3d={0: {}})
    with pytest.raises(NotImplementedError, match="pointsfm"):
        runners.compute_sfminfos(cfg, imagecols, images={})
    distorted = ImageCollection(
        {0: Camera("SIMPLE_RADIAL", [300.0, 160, 120, 0.1], cam_id=0,
                   hw=(H, W))}, imagecols.images)
    with pytest.raises(NotImplementedError, match="undistort"):
        line_triangulation(small_cfg(tmp_path / "dist"), distorted,
                           device="cpu")
    assert runners.undistort_images(imagecols, str(tmp_path)) is imagecols


def test_pose_neighbors_and_ranges_equal_reference(rng, tmp_path):
    from limap_tpu.runners import functions as ref_runners
    imagecols, _ = make_scene(rng, tmp_path, n_views=6, n_lines=1)
    ref_cols = RefCollection.from_dict(imagecols.as_dict())
    assert runners.compute_pose_neighbors(imagecols, 3) == \
        ref_runners.compute_pose_neighbors(ref_cols, 3)
    for a, b in zip(runners.compute_pose_ranges(imagecols),
                    ref_runners.compute_pose_ranges(ref_cols)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    cfg = runners.setup({"output_dir": str(tmp_path / "o"),
                         "n_neighbors": 2})
    assert cfg["dir_load"] == cfg["dir_save"] == str(tmp_path / "o")
    _, nbrs, ranges = runners.compute_sfminfos(cfg, imagecols)
    cfg["load_meta"] = True
    _, nbrs2, ranges2 = runners.compute_sfminfos(cfg, imagecols)
    assert nbrs == nbrs2 and all(len(v) == 2 for v in nbrs.values())
    np.testing.assert_allclose(ranges, ranges2)


def test_pipeline_scene_and_quality_eval_equal_reference():
    """testing/pipeline.py against bench_pipeline.py: the same cameras,
    GT lines and neighbours from the same seed, images equal but for the
    stroke rasteriser, quality_eval equal on the same tracks."""
    imagecols, imgs, nbrs, gt = pipeline.build_scene(n_views=6)
    ref_cols, ref_imgs, ref_nbrs, ref_gt = bench_pipeline.build_scene(
        n_views=6)
    assert np.array_equal(gt, ref_gt) and nbrs == ref_nbrs
    np.testing.assert_allclose(imagecols.batch("cpu").qvec.numpy(),
                               np.asarray(ref_cols.batch().qvec))
    np.testing.assert_allclose(imagecols.batch("cpu").tvec.numpy(),
                               np.asarray(ref_cols.batch().tvec))
    for k in imgs:
        assert imgs[k].shape == (600, 800) and imgs[k].dtype == np.uint8
        # the two rasterisers differ on stroke borders only
        assert (imgs[k] != ref_imgs[k]).mean() < 0.05
    from limap_tpu_torch.base.linetrack import LineTrack
    rng = np.random.default_rng(3)
    tracks = []
    for g in gt[:40]:
        line = g + rng.normal(size=(2, 3)) * rng.choice([0.005, 0.03, 0.2])
        tracks.append(LineTrack(line, list(range(int(rng.integers(3, 7))))))
    assert pipeline.quality_eval(tracks, gt) == \
        bench_pipeline.quality_eval(tracks, gt)
    assert pipeline.quality_eval([], gt) == bench_pipeline.quality_eval([],
                                                                        gt)


def test_build_scene_writes_npy_images_a_runner_can_read(tmp_path):
    imagecols, imgs, nbrs, gt = pipeline.build_scene(
        n_views=3, n_lines=10, hw=(120, 160), n_neighbors=2,
        image_dir=str(tmp_path / "images"))
    assert nbrs == {0: [2, 1], 1: [0, 2], 2: [1, 0]}
    assert imagecols.cameras[0].kvec()[0] == 140.0
    for k in imgs:
        assert np.array_equal(imagecols.read_image(k, set_gray=True),
                              imgs[k])


def test_draw_line_is_two_pixels_wide():
    img = np.zeros((20, 30), np.uint8)
    pipeline.draw_line(img, (5, 10), (25, 10), 200)
    assert (img[:, 15] == 200).sum() in (2, 3)
    assert img[10, 4:27].all() and not img[10, :3].any()
    pipeline.draw_line(img, (-50, -50), (-10, -20), 99)     # off the image
    assert 99 not in img
    cv = np.zeros((20, 30), np.uint8)
    cv2.line(cv, (5, 10), (25, 10), 200, 2)
    assert ((img > 0) != (cv > 0)).sum() <= 30


def test_runner_config_is_the_default_with_the_protocol_settings(tmp_path):
    cfg = pipeline.runner_config(str(tmp_path), n_neighbors=6)
    want = load_config(CFG)
    want.update(output_dir=str(tmp_path), n_neighbors=6)
    want["line2d"]["matcher"].update(topk=2, min_score=0.5)
    want["triangulation"]["max_tris_per_node"] = 32
    want["triangulation"]["filtering2d"] = {
        "th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
        "th_sv_num_supports": 3, "th_overlap": 0.05,
        "th_overlap_num_supports": 3}      # bench_pipeline.py's stage 5
    want["refinement"]["max_num_iterations"] = 20
    assert cfg == want
    # a fresh dict each time: the runner writes into it
    cfg["triangulation"]["filtering2d"]["th_overlap"] = 9.0
    assert pipeline.runner_config(str(tmp_path))["triangulation"][
        "filtering2d"]["th_overlap"] == 0.05


def test_map_lines_is_what_run_runs_after_matching():
    """Stages 3-6 given run()'s own segments and matches give run()'s
    tracks (the CPU repeats itself bit for bit)."""
    scene = pipeline.build_scene(n_views=6, n_lines=20, hw=(240, 320),
                                 n_neighbors=4)
    r = pipeline.run(scene=scene, device="cpu")
    prof = StageProfiler(device="cpu")
    tracks = pipeline.map_lines(scene[0], r["segs"], r["matches"], "cpu",
                                prof)
    assert list(prof.times) == ["triangulate", "tracks", "filters", "ba"]
    assert list(r["stages_s"]) == ["detect", "describe_match"] \
        + list(prof.times)
    assert len(tracks) == r["n_tracks"] > 0
    for a, b in zip(tracks, r["linetracks"]):
        np.testing.assert_array_equal(a.line, b.line)
