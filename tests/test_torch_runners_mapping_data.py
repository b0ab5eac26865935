"""The mapping datasets' readers (ETH3D, ScanNet, Rome16K, Hypersim's
refine_sfm): each root JAX file, loaded under a name of its own, against
the port's twin in ``limap_tpu_torch/runners/<dataset>/`` on tiny
layouts in tmp_path: the same image collections, depth readers, point
tracks and file names.  refine_sfm refuses a COLMAP model whose points
have no 2D observations."""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from tests.test_torch_runners_localization_data import same_collection
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collection(pkg, n=3, names=None):
    cam = importlib.import_module(f"{pkg}.base.camera")
    ic = importlib.import_module(f"{pkg}.base.image_collection")
    K = np.array([[500.0, 0, 32], [0, 500.0, 24], [0, 0, 1]])
    cams = {1: cam.Camera(K=K, hw=(48, 64), cam_id=1)}
    rng = np.random.default_rng(0)
    images = {}
    for k in range(n):
        from scipy.spatial.transform import Rotation
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
        images[k + 1] = ic.CameraImage(
            1, cam.CameraPose(R=R, tvec=rng.normal(size=3)),
            names[k] if names else f"img_{k}.png")
    return ic.ImageCollection(cams, images)


def _write_colmap(pkg, path, imagecols, with_p2d=True):
    reader = importlib.import_module(f"{pkg}.pointsfm.colmap_reader")
    ids = imagecols.get_img_ids()
    pts = {p: {"xyz": np.array([0.1 * p, 0.2, 5.0]), "image_ids": ids,
               "point2D_idxs": [p] * len(ids)} for p in range(4)}
    p2d = {i: np.concatenate([np.random.default_rng(i).uniform(
        0, 60, (4, 2)), np.arange(4)[:, None]], 1) for i in ids} \
        if with_p2d else None
    reader.write_model_txt(str(path), imagecols, pts, p2d)


def test_eth3d_reader_and_depth(tmp_path):
    cv2 = pytest.importorskip("cv2")
    jax_mod = _load("runners/eth3d/ETH3D.py", "jax_eth3d_twin")
    port_mod = importlib.import_module("limap_tpu_torch.runners.eth3d.ETH3D")
    scene = tmp_path / "courtyard"
    names = ["dslr_images_undistorted/a.JPG", "dslr_images_undistorted/b.JPG",
             "dslr_images_undistorted/c.JPG"]
    _write_colmap("limap_tpu_torch", scene / "dslr_calibration_undistorted",
                  _collection("limap_tpu_torch", names=names))
    (scene / "images" / "dslr_images_undistorted").mkdir(parents=True)
    for sub in ("inpainted_depth", "ground_truth_depth"):
        d = scene / sub / "dslr_images_undistorted"
        d.mkdir(parents=True)
        depth = np.random.default_rng(1).integers(0, 2000, (48, 64))
        depth[0, 0] = 0
        for n in names:
            cv2.imwrite(str(scene / sub / f"{n}.png"),
                        depth.astype(np.uint16))
    ja, pa = jax_mod.ETH3D(str(tmp_path)), port_mod.ETH3D(str(tmp_path))
    jc = ja.read_imagecols("courtyard")
    pc = pa.read_imagecols("courtyard")
    same_collection(jc, pc)
    jp, pp = ja.read_points3d("courtyard"), pa.read_points3d("courtyard")
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_allclose(jp[k]["xyz"], pp[k]["xyz"])
        assert list(jp[k]["image_ids"]) == list(pp[k]["image_ids"])
    for inpainted in (True, False):
        jd = ja.read_depths("courtyard", jc, use_inpainted=inpainted)
        pd = pa.read_depths("courtyard", pc, use_inpainted=inpainted)
        for i in jc.get_img_ids():
            assert jd[i].filename == pd[i].filename
            a, b = jd[i].read(jd[i].filename), pd[i].read(pd[i].filename)
            np.testing.assert_array_equal(a, b)
            assert np.isinf(b[0, 0])


def _write_scannet(tmp_path, intrinsic_file):
    cv2 = pytest.importorskip("cv2")
    scene = tmp_path / "scene0000_00"
    for sub in ("color", "pose", "depth", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    rng = np.random.default_rng(2)
    for k in range(5):
        cv2.imwrite(str(scene / "color" / f"{k}.jpg"),
                    rng.integers(0, 255, (96, 128, 3), np.uint8))
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        if k == 3:
            T[0, 0] = np.inf        # an invalid pose is skipped
        np.savetxt(scene / "pose" / f"{k}.txt", T)
        cv2.imwrite(str(scene / "depth" / f"{k}.png"),
                    rng.integers(0, 5000, (96, 128)).astype(np.uint16))
    if intrinsic_file:
        M = np.eye(4)
        M[:3, :3] = [[110.0, 0, 63.5], [0, 111.0, 47.5], [0, 0, 1]]
        np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", M)
    else:
        (scene / "_info.txt").write_text(
            "fx_color = 110.0\nfy_color = 111.0\nmx_color = 63.5\n"
            "my_color = 47.5\n")
    return scene


@pytest.mark.parametrize("intrinsic_file", [True, False])
@pytest.mark.parametrize("max_dim,stride", [(-1, 1), (64, 2)])
def test_scannet_reader_and_depth(tmp_path, intrinsic_file, max_dim, stride):
    _write_scannet(tmp_path, intrinsic_file)
    jax_mod = _load("runners/scannet/ScanNet.py", "jax_scannet_twin")
    port_mod = importlib.import_module(
        "limap_tpu_torch.runners.scannet.ScanNet")
    cfg = {"stride": stride}
    outs = []
    for mod in (jax_mod, port_mod):
        ds = mod.ScanNet(str(tmp_path), max_image_dim=max_dim)
        outs.append(mod.read_scene_scannet(cfg, ds, "scene0000_00",
                                           load_depth=True))
    (jc, jd), (pc, pd) = outs
    same_collection(jc, pc)
    assert sorted(jd) == sorted(pd)
    for i in jd:
        assert jd[i].filename == pd[i].filename
        np.testing.assert_array_equal(jd[i].read(jd[i].filename),
                                      pd[i].read(pd[i].filename))


def test_rome16k_components_and_statistics(tmp_path, capsys):
    (tmp_path / "bundle" / "components").mkdir(parents=True)
    (tmp_path / "bundle" / "list.orig.txt").write_text(
        "".join(f"img{i}.jpg 0 500\n" for i in range(7)))
    (tmp_path / "bundle" / "components" / "comp.0.txt").write_text(
        "0 1 2")
    (tmp_path / "bundle" / "components" / "comp.1.txt").write_text(
        "3 4 5 6")
    jax_mod = _load("runners/rome16k/Rome16K.py", "jax_rome16k_twin")
    port_mod = importlib.import_module(
        "limap_tpu_torch.runners.rome16k.Rome16K")
    args = (str(tmp_path / "bundle" / "list.orig.txt"),
            str(tmp_path / "bundle" / "components"))
    a, b = jax_mod.Rome16K(*args), port_mod.Rome16K(*args)
    assert a.imname_list == b.imname_list
    assert a.components == b.components and a.component_map == \
        b.component_map
    assert a.count_components() == b.count_components() == 2
    stats = importlib.import_module(
        "limap_tpu_torch.runners.rome16k.statistics")
    stats.main(["-a", str(tmp_path), "--component_folder", "bundle/components"])
    assert capsys.readouterr().out.split() == ["1", "4", "0", "3"]


def test_refine_sfm_reads_colmap_observations(tmp_path):
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    _write_colmap("limap_tpu_torch", tmp_path / "model",
                  _collection("limap_tpu_torch"))
    imagecols, tracks = read_colmap_inputs(str(tmp_path / "model"))
    assert imagecols.NumImages() == 3 and len(tracks) == 4
    for p, t in enumerate(tracks):
        assert t.image_id_list == [1, 2, 3]
        for img_id, xy in zip(t.image_id_list, t.p2d_list):
            ref = np.random.default_rng(img_id).uniform(0, 60, (4, 2))[p]
            np.testing.assert_allclose(xy, ref, rtol=1e-6)


def test_refine_sfm_refuses_a_model_without_2d_observations(tmp_path):
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    _write_colmap("limap_tpu_torch", tmp_path / "model",
                  _collection("limap_tpu_torch"), with_p2d=False)
    with pytest.raises(ValueError, match="no 2D observations"):
        read_colmap_inputs(str(tmp_path / "model"))
    # the JAX runner refuses it with the same message (its main reads the
    # model the same way)
    src = open(os.path.join(ROOT, "runners/hypersim/refine_sfm.py")).read()
    assert "COLMAP model has no 2D observations for any point" in src


def test_refine_sfm_perturbs_as_the_jax_runner(tmp_path):
    """The noisy poses of refine_sfm's offline branch: the first two
    exact, the rest moved by the same draws as the JAX runner's."""
    from scipy.spatial.transform import Rotation
    from limap_tpu_torch.runners.hypersim.refine_sfm import perturb_poses
    gt = _collection("limap_tpu_torch", n=5)
    noisy = perturb_poses(gt, 0.01)
    rng = np.random.default_rng(0)
    for k, i in enumerate(gt.get_img_ids()):
        R, t = gt.campose(i).R(), gt.campose(i).tvec
        if k >= 2:
            R = Rotation.from_rotvec(rng.normal(size=3) * 0.005).as_matrix() \
                @ R
            t = t + rng.normal(size=3) * 0.01
        np.testing.assert_allclose(noisy.campose(i).R(), R, atol=1e-6)
        np.testing.assert_allclose(noisy.campose(i).tvec, t, atol=1e-12)


@pytest.mark.parametrize("cli", [
    "hypersim.triangulation", "hypersim.fitnmerge", "hypersim.refine_sfm",
    "eth3d.triangulation", "eth3d.fitnmerge", "scannet.triangulation",
    "scannet.fitnmerge", "rome16k.triangulation", "bundler_triangulation",
    "visualsfm_triangulation", "localization", "7scenes.localization",
    "cambridge.localization", "inloc.localization"])
def test_device_work_clis_take_device(cli):
    import argparse
    mod = importlib.import_module(f"limap_tpu_torch.runners.{cli}")
    seen = {}
    orig = argparse.ArgumentParser.parse_known_args

    def spy(self, args=None, namespace=None):
        seen["options"] = set(self._option_string_actions)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_known_args = spy
    try:
        with pytest.raises(SystemExit):
            mod.main([])
    finally:
        argparse.ArgumentParser.parse_known_args = orig
    assert "--device" in seen["options"], cli


def _undefined_names(path):
    """Names a module's functions load that nothing defines: not a
    builtin, a module-level name, or an argument or local of the
    top-level function (closures included) that loads it: a static check
    for NameErrors on paths the tests do not run, such as a dataset CLI's
    body."""
    import ast
    import builtins
    tree = ast.parse(open(path).read())
    module = set(dir(builtins)) | {"__file__", "__name__"}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            module |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            module.add(node.name)
        elif isinstance(node, ast.Assign):
            module |= {t.id for t in ast.walk(node) if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.If, ast.Try)):
            module |= {t.id for t in ast.walk(node)
                       if isinstance(t, ast.Name) and isinstance(t.ctx,
                                                                 ast.Store)}
            module |= {(a.asname or a.name).split(".")[0]
                       for n in ast.walk(node)
                       if isinstance(n, (ast.Import, ast.ImportFrom))
                       for a in n.names}
    missing = []

    def visit(fn, outer):
        local = set(outer)
        for n in ast.walk(fn):
            if isinstance(n, ast.arg):
                local.add(n.arg)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,
                                                                ast.Del)):
                local.add(n.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                local |= {(a.asname or a.name).split(".")[0]
                          for a in n.names}
            elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                local.add(n.name)
            elif isinstance(n, ast.ExceptHandler) and n.name:
                local.add(n.name)
        for n in ast.walk(fn):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in local and n.id not in module:
                missing.append((n.id, n.lineno))
    # a function with its nested closures is one scope here
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            visit(node, set())
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    visit(item, set())
    return missing


CLI_FILES = sorted(
    os.path.relpath(p, ROOT) for d in ("runners", "scripts")
    for p in __import__("glob").glob(
        os.path.join(ROOT, "limap_tpu_torch", d, "**", "*.py"),
        recursive=True))


@pytest.mark.parametrize("path", CLI_FILES)
def test_cli_modules_name_only_what_they_define(path):
    assert _undefined_names(os.path.join(ROOT, path)) == []
