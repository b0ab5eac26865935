"""The localization datasets' glue (7Scenes, Cambridge, InLoc): each root
JAX file, loaded under a name of its own, against the port's twin in
``limap_tpu_torch/runners/<dataset>/`` on tiny layouts in tmp_path: the
same image collections, depth, file names and result filenames; the hloc
drivers import-gated in both."""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    out = {}
    for ds in ("7scenes", "cambridge", "inloc"):
        out[ds] = (_load(f"runners/{ds}/utils.py", f"jax_{ds}_utils_twin"),
                   importlib.import_module(
                       f"limap_tpu_torch.runners.{ds}.utils"))
    out["7scenes_loc"] = (
        _load("runners/7scenes/localization.py", "jax_7scenes_loc_twin"),
        importlib.import_module("limap_tpu_torch.runners.7scenes."
                                "localization"))
    return out


def same_collection(a, b, atol=1e-9):
    """Two packages' image collections: the same ids, names, cameras and
    poses."""
    da, db = a.as_dict(), b.as_dict()
    assert sorted(a.get_img_ids()) == sorted(b.get_img_ids())
    for i in a.get_img_ids():
        assert a.image_name(i) == b.image_name(i)
        np.testing.assert_allclose(np.asarray(a.campose(i).qvec),
                                   np.asarray(b.campose(i).qvec), atol=atol)
        np.testing.assert_allclose(np.asarray(a.campose(i).tvec),
                                   np.asarray(b.campose(i).tvec), atol=atol)
        np.testing.assert_allclose(np.asarray(a.cam(a.camimage(i).cam_id).K()),
                                   np.asarray(b.cam(b.camimage(i).cam_id).K()),
                                   atol=atol)
    assert len(da) == len(db)


LOC_CFGS = [
    {"ransac": {"method": "hybrid", "thres_point": 10.0, "thres_line": 10.0,
                "weight_line": 1.0},
     "2d_matcher": "superglue_endpoints", "epipolar_filter": False,
     "reprojection_filter": None, "line_cost_func": "PerpendicularDist"},
    {"ransac": {"method": "solver", "thres": 5.0, "weight_point": 1.0,
                "weight_line": 1.0},
     "2d_matcher": "epipolar", "epipolar_filter": True,
     "reprojection_filter": "Perpendicular", "line_cost_func": "Perp"},
]


@pytest.mark.parametrize("ds", ["7scenes", "cambridge", "inloc"])
@pytest.mark.parametrize("i", range(len(LOC_CFGS)))
def test_result_filenames(mods, ds, i):
    jax_mod, port_mod = mods[ds]
    cfg = LOC_CFGS[i]
    try:
        ref = jax_mod.get_result_filenames(cfg)
    except (KeyError, TypeError) as e:
        with pytest.raises(type(e)):
            port_mod.get_result_filenames(cfg)
        return
    assert port_mod.get_result_filenames(cfg) == ref


def _write_7scenes(tmp_path):
    import cv2
    scene = tmp_path / "stairs"
    rng = np.random.default_rng(0)
    for seq in (1, 2):
        d = scene / f"seq-{seq:02d}"
        d.mkdir(parents=True)
        for k in range(3):
            img = rng.integers(0, 255, (48, 64), np.uint8)
            cv2.imwrite(str(d / f"frame-{k:06d}.color.png"), img)
            T = np.eye(4)
            from scipy.spatial.transform import Rotation
            T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)
                                             * 0.1).as_matrix()
            T[:3, 3] = rng.normal(size=3)
            np.savetxt(d / f"frame-{k:06d}.pose.txt", T)
            depth = rng.integers(500, 4000, (48, 64)).astype(np.uint16)
            depth[0, 0] = 65535
            cv2.imwrite(str(d / f"frame-{k:06d}.depth.png"), depth)
    (scene / "TrainSplit.txt").write_text("sequence1\n")
    (scene / "TestSplit.txt").write_text("sequence2\n")
    return scene


def test_7scenes_reader_and_split(mods, tmp_path):
    pytest.importorskip("cv2")
    jax_loc, port_loc = mods["7scenes_loc"]
    scene = _write_7scenes(tmp_path)
    for split in ("TrainSplit.txt", "TestSplit.txt"):
        seqs = jax_loc._read_split(str(scene), split)
        assert port_loc._read_split(str(scene), split) == seqs
        ja, jn = jax_loc.read_scene_7scenes(str(scene), seqs, start_id=5)
        pa, pn = port_loc.read_scene_7scenes(str(scene), seqs, start_id=5)
        assert jn == pn
        same_collection(ja, pa, atol=1e-6)


def test_7scenes_depth_reader(mods, tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    jax_mod, port_mod = mods["7scenes"]
    import PIL.Image
    img = "seq-01/frame-000001.color.png"
    name = jax_mod.image_path_to_rendered_depth_path(img)
    assert port_mod.image_path_to_rendered_depth_path(img) == name
    depth = np.random.default_rng(1).integers(0, 4000, (48, 64))
    depth[0, :3] = [0, 2_000_000, 999_999]
    PIL.Image.fromarray(depth.astype(np.int32)).save(str(tmp_path / name))
    a = jax_mod.SevenScenesDepthReader(name, str(tmp_path)).read(name)
    b = port_mod.SevenScenesDepthReader(name, str(tmp_path)).read(name)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.isinf(a[0, :2]).all() and np.isfinite(a[0, 2])


def _write_scene_model(mod, tmp_path, cam_mod, ic_mod):
    K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    cams = {0: cam_mod.Camera(K=K, hw=(100, 100), cam_id=0)}
    images, p2d = {}, {}
    gt_p = np.array([[0.0, 0, 5], [1.0, 0.5, 6], [-1.0, 0.2, 4]])
    p3d = {i: {"xyz": gt_p[i], "image_ids": [], "point2D_idxs": []}
           for i in range(3)}
    for k in range(4):
        R, t = np.eye(3), np.array([0.3 * k, 0.0, 0.0])
        name = f"seq-01/frame-{k:06d}.color.png"
        images[k] = ic_mod.CameraImage(0, cam_mod.CameraPose(R=R, tvec=t),
                                       name)
        uv = (K @ (gt_p @ R.T + t).T).T
        p2d[k] = uv[:, :2] / uv[:, 2:]
        for pid in range(3):
            p3d[pid]["image_ids"].append(k)
            p3d[pid]["point2D_idxs"].append(pid)
    model = tmp_path / "model"
    mod.write_model_txt_full(str(model), cams, images, p2d, p3d)
    return model, images


def test_7scenes_reference_sfm_and_evaluate(mods, tmp_path):
    import limap_tpu.base.camera as jcam
    import limap_tpu.base.image_collection as jic
    import limap_tpu_torch.base.camera as pcam
    import limap_tpu_torch.base.image_collection as pic
    jax_mod, port_mod = mods["7scenes"]
    out = {}
    for tag, mod, cm, im in (("jax", jax_mod, jcam, jic),
                             ("port", port_mod, pcam, pic)):
        d = tmp_path / tag
        d.mkdir()
        model, images = _write_scene_model(mod, d, cm, im)
        bl = d / "test_list.txt"
        bl.write_text("seq-01/frame-000003.color.png\n")
        split = mod.create_reference_sfm(model, d / "ref", str(bl))
        ids = mod.get_train_test_ids_from_sfm(model, str(bl))
        res = d / "results.txt"
        lines = []
        for k, img in images.items():
            t = img.pose.tvec + (np.array([1.0, 0, 0]) if k == 3 else 0)
            lines.append(" ".join([img.image_name]
                                  + [str(v) for v in img.pose.qvec]
                                  + [str(v) for v in t]))
        res.write_text("\n".join(lines))
        out[tag] = (split, ids, mod.evaluate(res, model),
                    sorted(os.listdir(d / "ref")),
                    [(d / "ref" / f).read_text()
                     for f in sorted(os.listdir(d / "ref"))])
    (js, ji, je, jf, jt), (ps, pi, pe, pf, pt) = out["jax"], out["port"]
    assert (sorted(js[0]), js[1]) == (sorted(ps[0]), ps[1])
    assert (sorted(ji[0]), ji[1]) == (sorted(pi[0]), pi[1])
    assert jf == pf and jt == pt
    assert je.keys() == pe.keys()
    for k in je:
        assert np.allclose(je[k], pe[k], atol=1e-9), k


def test_cambridge_evaluate_and_query_list(mods, tmp_path):
    import limap_tpu.base.camera as jcam
    import limap_tpu.base.image_collection as jic
    import limap_tpu_torch.base.camera as pcam
    import limap_tpu_torch.base.image_collection as pic
    jax_mod, port_mod = mods["cambridge"]
    outs = {}
    for tag, mod, cm, im in (("jax", jax_mod, jcam, jic),
                             ("port", port_mod, pcam, pic)):
        poses_gt, id_to_name, lines = {}, {}, []
        for qid in range(4):
            pose = cm.CameraPose(R=np.eye(3),
                                 tvec=np.array([0.1 * qid, 0, 0]))
            poses_gt[qid] = pose
            id_to_name[qid] = f"seq1/frame{qid:05d}.png"
            t = pose.tvec + ([1.0, 0, 0] if qid == 3 else 0)
            lines.append(" ".join([f"frame{qid:05d}.png"]
                                  + [str(v) for v in pose.qvec]
                                  + [str(v) for v in t]))
        res = tmp_path / f"{tag}_results.txt"
        res.write_text("\n".join(lines))
        ev = mod.evaluate(str(res), poses_gt, list(range(4)), id_to_name)
        K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
        ic = im.ImageCollection({0: cm.Camera(K=K, hw=(96, 128), cam_id=0)},
                                {5: im.CameraImage(0, cm.CameraPose(),
                                                   "a/b/img5.png")})
        q = tmp_path / f"{tag}_q.txt"
        mod.create_query_list(ic, str(q))
        outs[tag] = (ev, q.read_text())
    (je, jq), (pe, pq) = outs["jax"], outs["port"]
    assert jq == pq
    assert je["recall"] == pe["recall"]
    assert abs(je["median_t"] - pe["median_t"]) < 1e-12


def test_inloc_dataset_and_p3d_reader(mods, tmp_path):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("scipy.io")
    from scipy.io import savemat
    jax_mod, port_mod = mods["inloc"]
    ds = tmp_path / "inloc"
    (ds / "database/scan1").mkdir(parents=True)
    (ds / "query/iphone7").mkdir(parents=True)
    img = np.full((60, 90), 128, np.uint8)
    cv2.imwrite(str(ds / "database/scan1/a.jpg"), img)
    cv2.imwrite(str(ds / "database/scan1/b.jpg"), img[:, :80])
    cv2.imwrite(str(ds / "query/iphone7/q.jpg"), img)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("query/iphone7/q.jpg database/scan1/a.jpg\n"
                     "query/iphone7/q.jpg database/scan1/b.jpg\n")

    def fake_scan_pose(dataset_dir, name):
        T = np.eye(4)
        T[:3, 3] = [1.0, 2.0, 3.0 + len(name)]
        return T

    outs = [mod.read_dataset_inloc({"max_image_dim": -1}, ds, str(pairs),
                                   get_scan_pose=fake_scan_pose)
            for mod in (jax_mod, port_mod)]
    (ja, *jrest), (pa, *prest) = outs
    assert jrest == prest
    same_collection(ja, pa, atol=1e-6)
    p3d = np.arange(24, dtype=np.float64).reshape(2, 4, 3)
    savemat(str(tmp_path / "im.jpg.mat"), {"XYZcut": p3d})
    a = jax_mod.InLocP3DReader(str(tmp_path / "im.jpg")).read_p3ds()
    b = port_mod.InLocP3DReader(str(tmp_path / "im.jpg")).read_p3ds()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hloc_drivers_are_import_gated(mods, tmp_path):
    assert "hloc" not in sys.modules
    for jax_mod, port_mod in (mods["cambridge"],):
        for mod in (jax_mod, port_mod):
            with pytest.raises(ImportError, match="hloc"):
                mod.run_hloc_cambridge({}, "imgs", None, {}, [], [], {},
                                       tmp_path / "res.txt")
    for mod in mods["inloc"]:
        with pytest.raises(ImportError, match="hloc"):
            mod.run_hloc_inloc({}, tmp_path, tmp_path / "p.txt",
                               tmp_path / "res.txt")
    for mod in mods["7scenes"]:
        with pytest.raises(ImportError, match="hloc"):
            mod.run_hloc_7scenes({}, tmp_path, "stairs",
                                 tmp_path / "res.txt", None)


def test_7scenes_localization_cli_runs_as_a_module():
    import subprocess
    out = subprocess.run(
        [sys.executable, "-m", "limap_tpu_torch.runners.7scenes.localization",
         "--help"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--hloc_log" in out.stdout
