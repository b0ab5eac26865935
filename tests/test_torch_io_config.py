"""The port's config, IO, profiler and host containers against the JAX
package's: files written by one are read by the other, configs load
equal, ``from_dict`` configs agree field by field."""

import dataclasses
import json
import os

import numpy as np
import pytest

from limap_tpu.base import camera as ref_camera
from limap_tpu.base import image_collection as ref_ic
from limap_tpu.base import line_linker as ref_linker
from limap_tpu.base import linetrack as ref_lt
from limap_tpu.optimize.line_ba import LineBAConfig as RefLineBAConfig
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as RefTriangulatorConfig
from limap_tpu.util import config as ref_config
from limap_tpu.util import io as ref_io
from limap_tpu_torch.base import camera, image_collection, line_linker
from limap_tpu_torch.base import linetrack as lt
from limap_tpu_torch.optimize.line_ba import LineBAConfig
from limap_tpu_torch.triangulation.triangulator import TriangulatorConfig
from limap_tpu_torch.util import config, io
from limap_tpu_torch.util.profiler import StageProfiler
from torch_threads import two_torch_threads  # noqa: F401

CFGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs")
DEFAULT = os.path.join(CFGS, "triangulation", "default.yaml")


def make_tracks(rng, mod, n=4):
    tracks = []
    for t in range(n):
        k = 2 + t
        tracks.append(mod.LineTrack(
            line=rng.normal(size=(2, 3)),
            image_id_list=[int(i) for i in rng.integers(0, 5, k)],
            line_id_list=[int(i) for i in rng.integers(0, 50, k)],
            line2d_list=list(rng.uniform(0, 100, (k, 2, 2))),
            line3d_list=list(rng.normal(size=(k, 2, 3))) if t % 2 else None,
            score_list=[float(x) for x in rng.uniform(size=k)]
            if t % 2 else None))
    return tracks


def make_imagecols(mod_cam, mod_ic, rng):
    cams = {0: mod_cam.Camera(K=np.array([[600.0, 0, 320], [0, 610, 240],
                                          [0, 0, 1]]), hw=(480, 640),
                              cam_id=0),
            3: mod_cam.Camera("SIMPLE_RADIAL", [500.0, 300, 200, 0.0],
                              cam_id=3, hw=(400, 600))}
    q = rng.normal(size=(3, 4))
    t = rng.normal(size=(3, 3))
    images = {i: mod_ic.CameraImage(0 if i < 2 else 3,
                                    mod_cam.CameraPose(q[i], t[i]),
                                    f"img_{i}.png") for i in range(3)}
    return mod_ic.ImageCollection(cams, images)


def assert_tracks_equal(a, b, tol=1e-9):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.line, y.line, atol=tol)
        assert x.image_id_list == y.image_id_list
        assert x.line_id_list == y.line_id_list
        np.testing.assert_allclose(np.array(x.line2d_list).reshape(-1),
                                   np.array(y.line2d_list).reshape(-1),
                                   atol=tol)
        np.testing.assert_allclose(np.array(x.line3d_list).reshape(-1),
                                   np.array(y.line3d_list).reshape(-1),
                                   atol=tol)
        np.testing.assert_allclose(x.score_list, y.score_list, atol=tol)


# ------------------------------------------------------------------ config
def test_load_config_equals_reference():
    got = config.load_config(DEFAULT)
    assert got == ref_config.load_config(DEFAULT)
    assert got["line2d"]["detector"]["method"] == "tpu_lsd"
    assert got["line2d"]["extractor"]["method"] == "patch_endpoints"
    assert got["line2d"]["matcher"]["method"] == "nn_endpoints"


def test_default_dict_equals_the_yaml_and_is_fresh():
    a = config.default_triangulation_config()
    assert a == config.load_config(DEFAULT)
    a["triangulation"]["var2d"] = 7.0
    assert config.default_triangulation_config()["triangulation"][
        "var2d"] == -1.0


def test_config_module_imports_without_yaml(monkeypatch):
    import importlib
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    mod = importlib.reload(config)
    try:
        assert mod.default_triangulation_config()["n_neighbors"] == 20
        with pytest.raises(ImportError):
            mod.load_config(DEFAULT)
    finally:
        monkeypatch.undo()
        importlib.reload(config)


def test_config_inheritance_and_overrides_equal_reference(tmp_path):
    child = tmp_path / "child.yaml"
    child.write_text(f"base_config_file: {DEFAULT}\nn_neighbors: 7\n"
                     "triangulation:\n    var2d: 3.5\n")
    args = ["--triangulation.IoU_threshold", "0.3", "--skip_exists",
            "--sfm.ranges.range_robust", "0.1", "0.9", "-nv", "5",
            "--output_dir", "none"]
    shortcuts = {"-nv": "--n_visible_views"}
    got = config.update_config(config.load_config(str(child)), list(args),
                               shortcuts)
    want = ref_config.update_config(ref_config.load_config(str(child)),
                                    list(args), shortcuts)
    assert got == want
    assert got["n_neighbors"] == 7 and got["skip_exists"] is True
    assert got["sfm"]["ranges"]["range_robust"] == [0.1, 0.9]
    assert config.update_recursive_deepcopy({"a": {"b": 1}}, {"a": {"c": 2}}) \
        == {"a": {"b": 1, "c": 2}}


@pytest.mark.parametrize("which", ["triangulator", "ba", "linker2d",
                                   "linker3d", "none"])
def test_from_dict_configs_equal_reference_field_by_field(which):
    cfg = config.load_config(DEFAULT)
    pairs = {
        "triangulator": (TriangulatorConfig.from_dict(cfg["triangulation"]),
                         RefTriangulatorConfig.from_dict(
                             cfg["triangulation"])),
        "ba": (LineBAConfig.from_dict(cfg["refinement"]),
               RefLineBAConfig.from_dict(cfg["refinement"])),
        "linker2d": (line_linker.LineLinker2dConfig.from_dict(
            cfg["triangulation"]["linker2d_config"]),
            ref_linker.LineLinker2dConfig.from_dict(
                cfg["triangulation"]["linker2d_config"])),
        "linker3d": (line_linker.LineLinker3dConfig.from_dict(
            cfg["triangulation"]["remerging"]["linker3d"]),
            ref_linker.LineLinker3dConfig.from_dict(
                cfg["triangulation"]["remerging"]["linker3d"])),
        "none": (TriangulatorConfig.from_dict(None),
                 RefTriangulatorConfig.from_dict(None)),
    }
    got, want = pairs[which]

    def flat(c):
        return {f.name: (flat(getattr(c, f.name))
                         if dataclasses.is_dataclass(getattr(c, f.name))
                         else getattr(c, f.name))
                for f in dataclasses.fields(c)}
    assert flat(got) == flat(want)


# ---------------------------------------------------------------------- io
def test_segments_and_metainfos_cross_read(rng, tmp_path):
    segs = rng.uniform(0, 640, (7, 5)).astype(np.float32)
    io.save_txt_segments(str(tmp_path / "p"), 3, segs)
    ref_io.save_txt_segments(str(tmp_path / "r"), 3, segs)
    io.save_txt_segments(str(tmp_path / "p"), 4, np.zeros((0, 5)))
    a = ref_io.read_txt_segments(str(tmp_path / "p"), 3)
    b = io.read_txt_segments(str(tmp_path / "r"), 3)
    assert a.shape == (7, 4) and np.array_equal(a, b)
    np.testing.assert_allclose(a, segs[:, :4], rtol=1e-6)
    both = io.read_all_segments_from_folder(str(tmp_path / "p"))
    assert set(both) == {3, 4} and both[4].shape[0] == 0
    assert io.exists_txt_segments(str(tmp_path / "p"), 4)
    assert (tmp_path / "p" / "segments_3.txt").read_text() == \
        (tmp_path / "r" / "segments_3.txt").read_text()

    nbrs = {0: [1, 2], 1: [0], 5: []}
    ranges = (np.array([-1.5, -2, 0.25]), np.array([3, 4, 5.5]))
    io.save_txt_metainfos(str(tmp_path / "mp.txt"), nbrs, ranges)
    ref_io.save_txt_metainfos(str(tmp_path / "mr.txt"), nbrs, ranges)
    assert (tmp_path / "mp.txt").read_text() == \
        (tmp_path / "mr.txt").read_text()
    n2, r2 = ref_io.read_txt_metainfos(str(tmp_path / "mp.txt"))
    n3, r3 = io.read_txt_metainfos(str(tmp_path / "mr.txt"))
    assert n2 == n3 == nbrs
    np.testing.assert_allclose(r2, ranges)
    np.testing.assert_allclose(r3, ranges)
    with pytest.raises(FileNotFoundError):
        io.read_txt_metainfos(str(tmp_path / "missing.txt"))


def test_linetracks_folder_with_info_cross_read(rng, tmp_path):
    tracks = make_tracks(rng, lt)
    ref_tracks = make_tracks(np.random.default_rng(0), ref_lt)
    assert_tracks_equal(tracks, ref_tracks)
    cols = make_imagecols(camera, image_collection, rng)
    ref_cols = make_imagecols(ref_camera, ref_ic, np.random.default_rng(1))
    segs = {0: rng.uniform(size=(3, 4))}
    cfg = {"n_visible_views": 4, "nested": {"a": 1}}
    io.save_folder_linetracks_with_info(str(tmp_path / "p"), tracks, cfg,
                                        cols, segs)
    ref_io.save_folder_linetracks_with_info(str(tmp_path / "r"), ref_tracks,
                                            cfg, ref_cols, segs)
    for name in sorted(os.listdir(tmp_path / "p")):
        if name.endswith(".txt"):
            assert (tmp_path / "p" / name).read_text() == \
                (tmp_path / "r" / name).read_text(), name
    t_r, cfg_r, cols_r, segs_r = ref_io.read_folder_linetracks_with_info(
        str(tmp_path / "p"))
    t_p, cfg_p, cols_p, segs_p = io.read_folder_linetracks_with_info(
        str(tmp_path / "r"))
    assert_tracks_equal(t_r, tracks)
    assert_tracks_equal(t_p, ref_tracks)
    assert cfg_r == cfg_p == cfg
    assert cols_r.NumImages() == cols.NumImages() == 3
    # a pose normalizes its quaternion again when it is read
    assert cols_p.as_dict()["cameras"] == ref_cols.as_dict()["cameras"]
    for i in range(3):
        np.testing.assert_allclose(cols_p.campose(i).qvec,
                                   ref_cols.campose(i).qvec, atol=1e-12)
        np.testing.assert_allclose(cols_r.campose(i).tvec,
                                   cols.campose(i).tvec)
    np.testing.assert_allclose(segs_r[0], segs_p[0])
    # single-file format keeps only tracks of enough images
    io.save_txt_linetracks(str(tmp_path / "all_p.txt"), tracks, 3)
    ref_io.save_txt_linetracks(str(tmp_path / "all_r.txt"), ref_tracks, 3)
    assert (tmp_path / "all_p.txt").read_text() == \
        (tmp_path / "all_r.txt").read_text()


def test_obj_ply_and_npy_cross_read(rng, tmp_path):
    lines = rng.normal(size=(5, 2, 3))
    io.save_obj(str(tmp_path / "p.obj"), lines)
    ref_io.save_obj(str(tmp_path / "r.obj"), lines)
    np.testing.assert_allclose(ref_io.load_obj(str(tmp_path / "p.obj")),
                               lines)
    np.testing.assert_allclose(io.load_obj(str(tmp_path / "r.obj")), lines)
    assert io.load_obj(str(tmp_path / "p.obj")).shape == (5, 2, 3)
    io.save_obj(str(tmp_path / "e.obj"), np.zeros((0, 2, 3)))
    assert io.load_obj(str(tmp_path / "e.obj")).shape == (0, 2, 3)
    pts = rng.normal(size=(9, 3))
    io.save_ply(str(tmp_path / "p.ply"), pts)
    np.testing.assert_allclose(ref_io.read_ply(str(tmp_path / "p.ply")), pts)
    ref_io.save_ply(str(tmp_path / "r.ply"), pts)
    np.testing.assert_allclose(io.read_ply(str(tmp_path / "r.ply")), pts)
    io.save_npy(str(tmp_path / "sub" / "x.npy"), {"a": [1, 2]})
    assert ref_io.read_npy(str(tmp_path / "sub" / "x.npy")).item() == \
        {"a": [1, 2]}


# ---------------------------------------------------------- host containers
def test_linetrack_dict_and_batch_round_trip(rng):
    tracks = make_tracks(rng, lt)
    again = [lt.LineTrack.from_dict(t.as_dict()) for t in tracks]
    assert_tracks_equal(again, tracks)
    assert tracks[1].as_dict() == make_tracks(
        np.random.default_rng(0), ref_lt)[1].as_dict()
    id2row = {i: i for i in range(5)}
    batch = lt.tracks_to_batch(tracks, id2row, device="cpu")
    ref_batch = ref_lt.tracks_to_batch(
        make_tracks(np.random.default_rng(0), ref_lt), id2row)
    T = len(tracks)
    S = min(batch.mask.shape[1], ref_batch.mask.shape[1])
    assert np.array_equal(batch.mask.numpy()[:T, :S],
                          np.asarray(ref_batch.mask)[:T, :S])
    assert batch.mask.numpy()[:T].sum() == np.asarray(ref_batch.mask).sum()
    for name in ("img_index", "image_ids", "line_ids", "score"):
        np.testing.assert_allclose(
            getattr(batch, name).numpy()[:T, :S],
            np.asarray(getattr(ref_batch, name))[:T, :S], atol=1e-6)
    np.testing.assert_allclose(batch.line2d.end.numpy()[:T, :S],
                               np.asarray(ref_batch.line2d.end)[:T, :S],
                               atol=1e-5)
    np.testing.assert_allclose(batch.line3d.start.numpy()[:T, :S],
                               np.asarray(ref_batch.line3d.start)[:T, :S],
                               atol=1e-6)
    back = lt.batch_to_tracks(batch)
    assert [t.image_id_list for t in back] == \
        [t.image_id_list for t in tracks]
    assert lt.tracks_to_batch([], id2row, device="cpu").track_mask.sum() == 0


def test_camera_and_collection_host_api_equal_reference(rng):
    cols = make_imagecols(camera, image_collection, rng)
    ref_cols = make_imagecols(ref_camera, ref_ic, np.random.default_rng(0))
    assert cols.as_dict() == ref_cols.as_dict()
    again = image_collection.ImageCollection.from_dict(cols.as_dict())
    assert again.as_dict()["cameras"] == cols.as_dict()["cameras"]
    np.testing.assert_allclose(again.campose(1).qvec, cols.campose(1).qvec,
                               atol=1e-12)
    assert cols.NumImages() == 3 and cols.image_name(2) == "img_2.png"
    nbrs = {0: [1, 2, 9], 9: [0], 2: [0]}
    assert cols.update_neighbors(nbrs) == ref_cols.update_neighbors(nbrs) \
        == {0: [1, 2], 2: [0]}
    for i in range(3):
        np.testing.assert_allclose(cols.campose(i).center(),
                                   ref_cols.campose(i).center(), atol=1e-6)
        np.testing.assert_allclose(cols.campose(i).R(),
                                   ref_cols.campose(i).R(), atol=1e-6)
    cols.set_max_image_dim(320)
    ref_cols.set_max_image_dim(320)
    assert cols.as_dict() == ref_cols.as_dict()
    assert (cols.cameras[0].h(), cols.cameras[0].w()) == (240, 320)
    cols.set_max_image_dim(-1)
    assert cols.as_dict() == ref_cols.as_dict()
    with pytest.raises(ValueError, match="no size"):
        camera.Camera(K=np.eye(3)).resize(10, 10)


def test_read_image_npy_png_and_missing_cv2(rng, tmp_path, monkeypatch):
    import cv2
    img = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    np.save(str(tmp_path / "a.npy"), img)
    np.save(str(tmp_path / "g.npy"), img[..., 0])
    cam = camera.Camera(K=np.eye(3), hw=(30, 40))
    ref_view = ref_camera.CameraView(
        ref_camera.Camera(K=np.eye(3), hw=(30, 40)), None,
        str(tmp_path / "a.png"))
    for name in ("a.png", "a.npy"):
        view = camera.CameraView(cam, None, str(tmp_path / name))
        assert np.array_equal(view.read_image(), ref_view.read_image())
        gray = view.read_image(set_gray=True)
        want = ref_view.read_image(set_gray=True)
        assert gray.shape == (30, 40) and gray.dtype == np.uint8
        assert np.abs(gray.astype(int) - want.astype(int)).max() <= 1
    assert np.array_equal(
        camera.CameraView(cam, None, str(tmp_path / "g.npy")).read_image(
            set_gray=True), img[..., 0])
    small = camera.CameraView(camera.Camera(K=np.eye(3), hw=(15, 20)), None,
                              str(tmp_path / "a.npy"))
    assert small.read_image().shape == (15, 20, 3)
    with pytest.raises(FileNotFoundError):
        camera.CameraView(cam, None, str(tmp_path / "no.png")).read_image()
    # without OpenCV: npy at the camera's size still reads, the rest
    # raises and names the file
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert camera.CameraView(cam, None, str(tmp_path / "a.npy")) \
        .read_image(set_gray=True).shape == (30, 40)
    with pytest.raises(ImportError, match="a.png"):
        camera.CameraView(cam, None, str(tmp_path / "a.png")).read_image()
    with pytest.raises(ImportError, match="a.npy"):
        small.read_image()


def test_lsd_detector_raises_without_cv2(monkeypatch):
    import sys
    from limap_tpu_torch.line2d import get_detector
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        get_detector({"method": "lsd"})


# ---------------------------------------------------------------- profiler
def test_stage_profiler_times_report_dump_and_trace(tmp_path, capsys):
    prof = StageProfiler(device="cpu")
    with prof.stage("a"):
        pass
    with prof.stage("a"):
        pass
    with pytest.raises(KeyError):
        with prof.stage("b"):
            raise KeyError("x")
    assert set(prof.times) == {"a", "b"} and prof.times["a"] >= 0
    assert prof.report() == prof.times
    assert "TOTAL" in capsys.readouterr().out
    prof.dump(str(tmp_path / "t.json"))
    assert set(json.load(open(tmp_path / "t.json"))) == {"a", "b"}
    traced = StageProfiler(trace_dir=str(tmp_path / "trace"), device="cpu")
    with traced.stage("s"):
        np.zeros(3).sum()
    assert (tmp_path / "trace" / "s.json").stat().st_size > 0
