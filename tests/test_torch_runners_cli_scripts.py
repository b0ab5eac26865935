"""The port's scripts and one mapping CLI against their JAX twins: the
convert_model round trips (the same files from the same model), the
tnt_align transform, the Aachen undistortion, the matching demo, the
localization CLI against a direct hybrid_localization call, and the
ETH3D triangulation CLI end to end from the same PNGs (both packages on
the CPU).  Each root file is loaded under a name of its own."""

import copy
import importlib.util
import os
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from tests.test_torch_runner import (make_scene, nearest_line_distance,
                                     small_cfg)
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + list(argv))
    return mod.main()


def _model(tmp_path, n=4, with_p2d=True):
    """A COLMAP text model with 2D observations, written by the port."""
    from limap_tpu_torch.base.camera import Camera, CameraPose
    from limap_tpu_torch.base.image_collection import (CameraImage,
                                                       ImageCollection)
    from limap_tpu_torch.pointsfm import write_model_txt
    K = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]])
    rng = np.random.default_rng(3)
    from scipy.spatial.transform import Rotation
    images, p2d = {}, {}
    gt_p = rng.uniform([-1, -1, 4], [1, 1, 6], (5, 3))
    pts = {p: {"xyz": gt_p[p], "image_ids": [], "point2D_idxs": []}
           for p in range(5)}
    for k in range(n):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
        t = np.array([0.3 * k, 0.1, 0.0])
        images[k + 1] = CameraImage(0, CameraPose(R=R, tvec=t),
                                    f"im_{k}.png")
        uv = (K @ (gt_p @ R.T + t).T).T
        p2d[k + 1] = np.concatenate([uv[:, :2] / uv[:, 2:],
                                     np.arange(5)[:, None]], 1)
        for p in range(5):
            pts[p]["image_ids"].append(k + 1)
            pts[p]["point2D_idxs"].append(p)
    ic = ImageCollection({0: Camera(K=K, hw=(80, 100), cam_id=0)}, images)
    write_model_txt(str(tmp_path / "model"), ic, pts,
                    p2d if with_p2d else None)
    return tmp_path / "model", ic


def test_convert_model_writes_the_jax_files(tmp_path, monkeypatch):
    from limap_tpu_torch.scripts import convert_model
    from limap_tpu_torch.util import io as limapio
    jax_script = _load("scripts/convert_model.py", "jax_convert_model_twin")
    model, ic = _model(tmp_path)
    convert_model.main(["-i", str(model), "-o", str(tmp_path / "port"),
                        "--type", "colmap2vsfm"])
    _run_jax_main(jax_script, ["-i", str(model), "-o",
                               str(tmp_path / "jax"), "--type",
                               "colmap2vsfm"], monkeypatch)
    a = (tmp_path / "port" / "reconstruction.nvm").read_text()
    assert a == (tmp_path / "jax" / "reconstruction.nvm").read_text()
    # NVM back through the port's reader: the centres and the points
    from limap_tpu_torch.pointsfm.readers import ReadModelVisualSfM
    cols, points3d = ReadModelVisualSfM(str(tmp_path / "port"))
    assert len(points3d) == 5
    for row, img_id in enumerate(ic.get_img_ids()):
        np.testing.assert_allclose(cols.campose(row).center(),
                                   ic.campose(img_id).center(), atol=1e-5)
    # imagecols.npy -> COLMAP
    limapio.save_npy(str(tmp_path / "ic.npy"), ic.as_dict())
    convert_model.main(["-i", str(tmp_path / "ic.npy"), "-o",
                        str(tmp_path / "port_colmap")])
    _run_jax_main(jax_script, ["-i", str(tmp_path / "ic.npy"), "-o",
                               str(tmp_path / "jax_colmap")], monkeypatch)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port_colmap" / f).read_text() == \
            (tmp_path / "jax_colmap" / f).read_text()


def test_tnt_align_gives_the_jax_transform(tmp_path, monkeypatch):
    from scipy.spatial.transform import Rotation
    from limap_tpu_torch.scripts import tnt_align
    jax_script = _load("scripts/tnt_align.py", "jax_tnt_align_twin")
    model, ic = _model(tmp_path, n=6)
    # the rig log: the centres under a known Sim3, each as a 4x4 pose
    R = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    s, t = 1.7, np.array([0.5, -1.0, 2.0])
    ids = sorted(ic.get_img_ids(), key=ic.image_name)
    lines = []
    for k, i in enumerate(ids):
        T = np.eye(4)
        T[:3, 3] = s * R @ ic.campose(i).center() + t
        lines.append(f"{k} {k} 0")
        lines += [" ".join(map(str, row)) for row in T]
    (tmp_path / "sfm.log").write_text("\n".join(lines) + "\n")
    trans = np.eye(4)
    trans[:3, :3] = Rotation.from_rotvec([0.0, 0.4, 0.0]).as_matrix()
    trans[:3, 3] = [3.0, 0.0, -1.0]
    np.savetxt(tmp_path / "trans.txt", trans)
    argv = ["--colmap_model", str(model), "--sfm_log",
            str(tmp_path / "sfm.log"), "--trans", str(tmp_path / "trans.txt")]
    tnt_align.main(argv + ["--output", str(tmp_path / "port")])
    _run_jax_main(jax_script, argv + ["--output", str(tmp_path / "jax")],
                  monkeypatch)
    a = np.loadtxt(tmp_path / "port" / "alignment.txt")
    b = np.loadtxt(tmp_path / "jax" / "alignment.txt")
    np.testing.assert_allclose(a, b, atol=1e-9)
    expect = trans[:3, :3] @ (s * R)
    np.testing.assert_allclose(a[:, :3], expect, atol=1e-6)


def test_aachen_undistort_writes_the_jax_cameras(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from limap_tpu_torch.scripts import aachen_undistort
    jax_script = _load("scripts/aachen_undistort.py",
                       "jax_aachen_undistort_twin")
    data = tmp_path / "Aachen-1.1"
    (data / "images_upright" / "query" / "night").mkdir(parents=True)
    (data / "queries").mkdir()
    rng = np.random.default_rng(4)
    names = []
    for k in range(2):
        name = f"query/night/q{k}.jpg"
        cv2.imwrite(str(data / "images_upright" / name),
                    rng.integers(0, 255, (60, 80, 3), np.uint8))
        names.append(f"{name} SIMPLE_RADIAL 80 60 70.0 40.0 30.0 "
                     f"{0.02 * (k + 1)}")
    (data / "queries" / "night_time_queries_with_intrinsics.txt"
     ).write_text("\n".join(names) + "\n")
    ja, jc = jax_script.load_list_file(
        str(data / "queries" / "night_time_queries_with_intrinsics.txt"))
    pa, pc = aachen_undistort.load_list_file(
        str(data / "queries" / "night_time_queries_with_intrinsics.txt"))
    assert ja == pa
    assert [list(c.params) for c in jc] == [list(c.params) for c in pc]
    aachen_undistort.main(["--data_dir", str(data), "--output",
                           str(tmp_path / "port.txt")])
    port_txt = (tmp_path / "port.txt").read_text()
    port_img = cv2.imread(str(data / "undistorted" / "query/night/q1.jpg"))
    _run_jax_main(jax_script, ["--data_dir", str(data), "--output",
                               str(tmp_path / "jax.txt")], monkeypatch)
    assert port_txt == (tmp_path / "jax.txt").read_text()
    jax_img = cv2.imread(str(data / "undistorted" / "query/night/q1.jpg"))
    assert np.abs(port_img.astype(int) - jax_img.astype(int)).max() <= 1


def test_matching_demo_counts_as_jax(tmp_path, monkeypatch, capsys):
    pytest.importorskip("cv2")
    from limap_tpu_torch.scripts import test_matching
    jax_script = _load("scripts/test_matching.py", "jax_test_matching_twin")
    test_matching.main(["--out_dir", str(tmp_path), "--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()[0]
    _run_jax_main(jax_script, ["--out_dir", str(tmp_path)], monkeypatch)
    jax_out = capsys.readouterr().out.splitlines()[0]
    strip = lambda s: s.split(", matching time")[0]
    assert strip(port_out) == strip(jax_out)
    assert (tmp_path / "matches.png").exists()


def test_localization_cli_equals_the_direct_call(tmp_path):
    """runners/localization.py on files written from
    tests/test_torch_localization_runner.py's scene (6 views at 240x320,
    one query with a prior and 30 point matches, a map from the true
    lines): the same pose as hybrid_localization called directly."""
    import json
    cv2 = pytest.importorskip("cv2")
    from limap_tpu_torch.base.camera import CameraPose
    from limap_tpu_torch.base.linetrack import LineTrack
    from limap_tpu_torch.pointsfm import write_model_txt
    from limap_tpu_torch.runners import functions, hybrid_localization
    from limap_tpu_torch.runners import localization
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util import io as limapio
    from tests.test_torch_localization_runner import (DB_IDS, Q_ID, config,
                                                      linemap, query_inputs)
    cols, imgs, _, gt = pipeline.build_scene(n_views=6, n_lines=30,
                                             hw=(240, 320))
    for i, img in imgs.items():
        name = str(tmp_path / f"img_{i}.png")
        cv2.imwrite(name, img)
        cols.images[i].image_name = name
    _, points, prior_R, prior_t = query_inputs(cols)
    db = cols.subset_by_image_ids(DB_IDS)
    query = copy.deepcopy(cols).subset_by_image_ids([Q_ID])
    query.set_camera_pose(Q_ID, CameraPose(R=prior_R, tvec=prior_t))
    cfg = config(tmp_path / "direct")
    segs, _ = functions.compute_2d_segs(functions.setup(dict(cfg)), db,
                                        compute_descinfo=False, device="cpu")
    tracks = linemap(segs, cols, gt, LineTrack)
    direct = hybrid_localization(copy.deepcopy(cfg), db, query,
                                 {Q_ID: points}, tracks, {Q_ID: DB_IDS},
                                 device="cpu")
    write_model_txt(str(tmp_path / "db"), db)
    write_model_txt(str(tmp_path / "query"), query)
    limapio.save_folder_linetracks_with_info(str(tmp_path / "map"), tracks)
    np.savez(tmp_path / "corresp.npz", **{f"p3ds_{Q_ID}": points[0],
                                          f"p2ds_{Q_ID}": points[1]})
    (tmp_path / "retrieval.txt").write_text(
        " ".join(map(str, [Q_ID] + DB_IDS)) + "\n")
    cfg["output_dir"] = str(tmp_path / "cli")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    cli = localization.main([
        "--db_model", str(tmp_path / "db"),
        "--query_model", str(tmp_path / "query"),
        "--linemap", str(tmp_path / "map"),
        "--point_corresp", str(tmp_path / "corresp.npz"),
        "--retrieval", str(tmp_path / "retrieval.txt"),
        "--results_path", str(tmp_path / "results.txt"),
        "-c", str(tmp_path / "cfg.json"), "--device", "cpu"])
    assert sorted(cli) == sorted(direct) == [Q_ID]
    np.testing.assert_allclose(cli[Q_ID].center(), direct[Q_ID].center(),
                               atol=1e-3)
    assert (tmp_path / "results.txt").exists()


def _eth3d_layout(rng, tmp_path):
    """make_scene's 6 views as an ETH3D scene: PNG images under
    images/, a COLMAP model with points on the wall seen by every view."""
    import cv2
    from limap_tpu_torch.pointsfm import write_model_txt
    scene = tmp_path / "data" / "terrains"
    (scene / "images").mkdir(parents=True)
    imagecols, gt = make_scene(rng, scene / "images", n_views=6, n_lines=6)
    for i in imagecols.get_img_ids():
        imagecols.change_image_name(
            i, os.path.basename(imagecols.image_name(i)))
    xyz = np.random.default_rng(5).uniform([-5, -4, 9.5], [4, 4, 10.5],
                                           (60, 3))
    pts = {p: {"xyz": xyz[p], "image_ids": imagecols.get_img_ids()}
           for p in range(len(xyz))}
    write_model_txt(str(scene / "dslr_calibration_undistorted"), imagecols,
                    pts)
    assert cv2 is not None
    return gt


def test_eth3d_triangulation_cli_matches_jax(rng, tmp_path, monkeypatch):
    """The one mapping CLI run end to end against its JAX twin: the ETH3D
    triangulation from the same PNGs and COLMAP model, both on the CPU
    (as tests/test_torch_runner.py holds the runner)."""
    yaml = pytest.importorskip("yaml")
    gt = _eth3d_layout(rng, tmp_path)
    from limap_tpu_torch.runners.eth3d import triangulation as port_cli
    jax_cli = _load("runners/eth3d/triangulation.py", "jax_eth3d_tri_twin")
    jax_cli_tracks = {}
    import limap_tpu.runners as jax_runners
    orig = jax_runners.line_triangulation

    def keep(*a, **k):
        out = orig(*a, **k)
        jax_cli_tracks["tracks"] = out
        return out

    monkeypatch.setattr(jax_runners, "line_triangulation", keep)
    cfgs = {}
    for tag in ("port", "jax"):
        cfg = small_cfg(tmp_path / tag)
        cfgs[tag] = tmp_path / f"{tag}.yaml"
        cfgs[tag].write_text(yaml.safe_dump(cfg))
    tracks = port_cli.main(["-c", str(cfgs["port"]), "--data_dir",
                            str(tmp_path / "data"), "--device", "cpu"])
    _run_jax_main(jax_cli, ["-c", str(cfgs["jax"]), "--data_dir",
                            str(tmp_path / "data")], monkeypatch)
    ref_tracks = jax_cli_tracks["tracks"]
    good = [t for t in tracks if t.count_images() >= 3]
    ref_good = [t for t in ref_tracks if t.count_images() >= 3]
    assert len(good) >= 2, (len(tracks), len(ref_tracks), len(ref_good))
    assert abs(len(good) - len(ref_good)) <= 1
    assert abs(len(tracks) - len(ref_tracks)) <= 2
    far = [t for t in good if nearest_line_distance(t, ref_tracks) > 0.05]
    assert len(far) <= 1, [t.line for t in far]
    assert len(gt) == 6
