"""The port's evaluation scripts against the JAX package's root scripts
on the same files, on the CPU: ``eval_tnt`` on one finaltracks folder and
the same GT cloud written as an ascii and a binary little-endian
``.ply`` (with and without an alignment) prints the same numbers;
``eval_hypersim``'s ``build_gt_cloud`` and the Hypersim loader's
``raydepth2depth`` and ``read_scene_hypersim`` (a two-frame scene in
the public layout, written here) give the same arrays."""

import csv
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import limap_tpu.base.camera as jcam
import limap_tpu.base.image_collection as jic
from limap_tpu.base.depth_reader_base import \
    ArrayDepthReader as JArrayDepthReader
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.depth_reader_base import ArrayDepthReader
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.base.linetrack import LineTrack
from limap_tpu_torch.runners.hypersim import loader as ploader
from limap_tpu_torch.scripts import eval_hypersim as peh
from limap_tpu_torch.scripts import eval_tnt as pet
from limap_tpu_torch.util import io as pio

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return (_load("scripts/eval_tnt.py", "jax_eval_tnt"),
            _load("scripts/eval_hypersim.py", "jax_eval_hypersim"),
            _load("runners/hypersim/loader.py", "jax_hypersim_loader"))


def _write_ply(path, pts, binary):
    head = ("ply\nformat {} 1.0\nelement vertex {}\nproperty float x\n"
            "property float y\nproperty float z\nend_header\n").format(
                "binary_little_endian" if binary else "ascii", len(pts))
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(pts, "<f4").tobytes())
        else:
            f.write("".join(f"{x} {y} {z}\n" for x, y, z in pts).encode())


@pytest.fixture(scope="module")
def tnt_inputs(tmp_path_factory):
    """A finaltracks folder of 9 tracks (7 seen in 4 or more images) near
    a GT cloud of 3000 points on three lines, the cloud as ascii and
    binary .ply, and a Sim3 alignment."""
    tmp = tmp_path_factory.mktemp("tnt")
    rng = np.random.default_rng(0)
    t = rng.uniform(size=(1000, 1))
    ends = rng.normal(size=(3, 2, 3)) * 2
    cloud = np.concatenate([e[0] + t * (e[1] - e[0]) for e in ends])
    tracks = []
    for k in range(9):
        e = ends[k % 3]
        s0, s1 = rng.uniform(0, 0.4), rng.uniform(0.6, 1)
        line = np.stack([e[0] + s0 * (e[1] - e[0]), e[0] + s1 * (e[1] - e[0])])
        line = line + rng.normal(0, 0.004 * (k + 1), (2, 3))
        n = 2 + k if k < 7 else 3 - (k - 7)
        n = max(n, 4) if k < 7 else n
        tracks.append(LineTrack(line=line, image_id_list=list(range(n)),
                                line_id_list=[k] * n,
                                line2d_list=[np.zeros((2, 2))] * n))
    pio.save_folder_linetracks_with_info(str(tmp / "finaltracks"), tracks)
    _write_ply(tmp / "ascii.ply", cloud, False)
    _write_ply(tmp / "binary.ply", cloud, True)
    A = np.concatenate([Rotation.from_rotvec([0, 0, 1e-3]).as_matrix(),
                        [[1e-3], [0], [0]]], 1)
    np.savetxt(tmp / "alignment.txt", A)
    return tmp


@pytest.mark.parametrize("ply", ["ascii.ply", "binary.ply"])
@pytest.mark.parametrize("aligned", [False, True])
def test_eval_tnt_prints_the_same_numbers(tnt_inputs, jax_scripts, ply,
                                          aligned, capsys, monkeypatch):
    args = ["-i", str(tnt_inputs / "finaltracks"), "--gt_ply",
            str(tnt_inputs / ply)]
    if aligned:
        args += ["--alignment", str(tnt_inputs / "alignment.txt")]
    monkeypatch.setattr(sys, "argv", ["eval_tnt.py"] + args)
    jax_scripts[0].main()
    jax_out = capsys.readouterr().out
    pet.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    assert port_out.startswith("7 lines, GT cloud 3000 points")
    assert len(port_out.strip().split("\n")) == 5


def test_read_ply_xyz(tnt_inputs, jax_scripts):
    a = pet.read_ply_xyz(str(tnt_inputs / "ascii.ply"))
    b = pet.read_ply_xyz(str(tnt_inputs / "binary.ply"))
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(
        b, jax_scripts[0].read_ply_xyz(str(tnt_inputs / "binary.ply")))


def test_build_gt_cloud(jax_scripts):
    """Three posed views of 40 x 50 with depth maps, every 4th pixel
    unprojected: the same float32 cloud (the rotations pass through
    float32 on both sides; 1e-5 m)."""
    rng = np.random.default_rng(1)
    K = np.array([[60.0, 0, 25], [0, 62, 20], [0, 0, 1]])
    imgs, jimgs, depths, jdepths = {}, {}, {}, {}
    for i in range(3):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.2).as_matrix()
        t = rng.normal(size=3)
        imgs[i] = CameraImage(0, CameraPose(R=R, tvec=t))
        jimgs[i] = jic.CameraImage(0, jcam.CameraPose(R=R, tvec=t))
        d = rng.uniform(2, 5, (40, 50)).astype(np.float32)
        depths[i], jdepths[i] = ArrayDepthReader(d), JArrayDepthReader(d)
    cols = ImageCollection({0: Camera(K=K, hw=(40, 50), cam_id=0)}, imgs)
    jcols = jic.ImageCollection({0: jcam.Camera(K=K, hw=(40, 50),
                                                cam_id=0)}, jimgs)
    got = peh.build_gt_cloud(cols, depths)
    ref = jax_scripts[1].build_gt_cloud(jcols, jdepths)
    assert got.shape == (3 * 10 * 13, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_raydepth2depth(jax_scripts):
    rng = np.random.default_rng(2)
    K = np.array([[100.0, 0, 31], [0, 110, 24], [0, 0, 1]])
    ray = rng.uniform(1, 9, (48, 64))
    np.testing.assert_array_equal(ploader.raydepth2depth(ray, K),
                                  jax_scripts[2].raydepth2depth(ray, K))


def _hypersim_scene(root, n=2):
    """The public Hypersim layout for one scene and camera: metadata,
    keyframe positions and orientations (HDF5), the frames' images and
    ray-depth maps."""
    import h5py
    rng = np.random.default_rng(3)
    scene = root / "ai_001_001"
    detail = scene / "_detail" / "cam_00"
    os.makedirs(detail)
    with open(scene / "_detail" / "metadata_scene.csv", "w") as f:
        w = csv.writer(f)
        w.writerow(["parameter_name", "parameter_value"])
        w.writerow(["meters_per_asset_unit", "0.0254"])
    with h5py.File(detail / "camera_keyframe_positions.hdf5", "w") as f:
        f["dataset"] = rng.normal(size=(n, 3)) * 20
    with h5py.File(detail / "camera_keyframe_orientations.hdf5", "w") as f:
        f["dataset"] = Rotation.from_rotvec(rng.normal(size=(n, 3))
                                            ).as_matrix()
    for d in ("final_preview", "geometry_hdf5"):
        os.makedirs(scene / "images" / f"scene_cam_00_{d}")
    for i in range(n):
        (scene / "images" / "scene_cam_00_final_preview"
         / f"frame.{i:04d}.color.jpg").write_bytes(b"")
        with h5py.File(scene / "images" / "scene_cam_00_geometry_hdf5"
                       / f"frame.{i:04d}.depth_meters.hdf5", "w") as f:
            f["dataset"] = rng.uniform(1, 5, (768, 1024)).astype(np.float32)
    return root


@pytest.mark.parametrize("max_dim", [512, -1])
def test_read_scene_hypersim(tmp_path, jax_scripts, max_dim):
    """The same views and depth maps at half size.  With
    ``max_image_dim`` -1 (eval_hypersim's setting: keep the size) JAX's
    loader scales the images to -1 x -1 pixels and its depth reader
    fails; the port keeps 768 x 1024 and is held to JAX at that size by
    asking JAX for it (max_image_dim 1024)."""
    root = _hypersim_scene(tmp_path)
    cfg = {"max_image_dim": max_dim, "input_n_views": 5}
    cols, depths = ploader.read_scene_hypersim(
        cfg, ploader.Hypersim(str(root)), "ai_001_001", load_depth=True)
    jl = jax_scripts[2]
    if max_dim < 0:
        broken = jl.Hypersim(str(root))
        broken.set_max_dim(max_dim)
        assert (broken.h, broken.w) == (-1, -1)
        assert (cols.cam(0).h(), cols.cam(0).w()) == (768, 1024)
        cfg = dict(cfg, max_image_dim=1024)
    jcols, jdepths = jl.read_scene_hypersim(
        cfg, jl.Hypersim(str(root)), "ai_001_001", load_depth=True)
    assert cols.get_img_ids() == jcols.get_img_ids() == [0, 1]
    a, b = cols.as_dict(), jcols.as_dict()
    assert a["images"][1]["image_name"] == b["images"][1]["image_name"]
    for i in (0, 1):
        np.testing.assert_array_equal(a["images"][i]["pose"]["tvec"],
                                      b["images"][i]["pose"]["tvec"])
        np.testing.assert_array_equal(depths[i].read_depth(),
                                      jdepths[i].read_depth())
    np.testing.assert_array_equal(cols.cam(0).K(), jcols.cam(0).K())
