"""The port's point-SfM modules (limap_tpu_torch/pointsfm) against the
JAX package's (limap_tpu/pointsfm): the COLMAP text and binary readers,
the Bundler and VisualSfM readers, the SfM model's neighbours and ranges,
SfM with known poses and the external hloc/pycolmap driver, on the CPU.
Tolerances: equal ids, names and lists; float64 parameters within 1e-12;
triangulated points within 1e-4 m (float32 rays at ~8 m)."""

import os
import struct
import sys
import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import Camera as RefCamera
from limap_tpu.base.camera import CameraPose as RefPose
from limap_tpu.base.image_collection import CameraImage as RefImage
from limap_tpu.base.image_collection import ImageCollection as RefCollection
from limap_tpu.pointsfm import colmap_reader as ref_reader
from limap_tpu.pointsfm import readers as ref_readers
from limap_tpu.pointsfm import sfm as ref_sfm
from limap_tpu.pointsfm import sfm_model as ref_model
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.pointsfm import (ReadInfos, ReadModelBundler,
                                      ReadModelVisualSfM, ReadPointTracks,
                                      SfmModel, compute_metainfos, read_model,
                                      run_colmap_sfm_with_known_poses,
                                      run_sfm_with_known_poses,
                                      write_model_txt)
from limap_tpu_torch.pointsfm.colmap_sfm import write_pairs_from_neighbors
from torch_threads import two_torch_threads  # noqa: F401


def ref_collection(rng, n_views=5):
    """A JAX-package collection of two cameras (one distorted) and posed
    images with names."""
    cams = {1: RefCamera("PINHOLE", [500.0, 510.0, 320.0, 240.0], cam_id=1,
                         hw=(480, 640)),
            3: RefCamera("SIMPLE_RADIAL", [400.0, 200.0, 150.0, 0.05],
                         cam_id=3, hw=(300, 400))}
    images = {}
    for k in range(n_views):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
        images[10 + 2 * k] = RefImage(1 if k % 2 else 3, RefPose(
            R=R, tvec=rng.normal(size=3)), f"im_{k}.png")
    return RefCollection(cams, images)


def points(rng, img_ids, n=30):
    return {100 + p: {"xyz": rng.normal(size=3) + [0, 0, 8],
                      "image_ids": sorted(rng.choice(img_ids, 3,
                                                     replace=False).tolist()),
                      "point2D_idxs": [int(x) for x in rng.integers(0, 50, 3)]}
            for p in range(n)}


def write_model_bin(path, cams, images, pts, p2d):
    """The COLMAP binary model of the same content (the documented
    layout), packed here."""
    os.makedirs(path, exist_ok=True)
    model_ids = {"PINHOLE": 1, "SIMPLE_RADIAL": 2}
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, cam in cams.items():
            f.write(struct.pack("<iiQQ", cid, model_ids[cam.model_name],
                                cam.w(), cam.h()))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<I", iid))
            f.write(struct.pack("<4d", *im.pose.qvec))
            f.write(struct.pack("<3d", *im.pose.tvec))
            f.write(struct.pack("<I", im.cam_id))
            f.write(im.image_name.encode() + b"\x00")
            obs = p2d[iid]
            f.write(struct.pack("<Q", len(obs)))
            for x, y, pid in obs:
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, rec in pts.items():
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<3d", *rec["xyz"]))
            f.write(bytes(3) + struct.pack("<d", 0.0))
            ids = rec["image_ids"]
            f.write(struct.pack("<Q", len(ids)))
            for i, j in zip(ids, rec["point2D_idxs"]):
                f.write(struct.pack("<ii", i, j))


def assert_same_model(port, ref):
    (pc, pi, pp2, pp3), (rc, ri, rp2, rp3) = port, ref
    assert sorted(pc) == sorted(rc) and sorted(pi) == sorted(ri)
    for cid in rc:
        assert pc[cid].model_id == rc[cid].model_id
        assert (pc[cid].h(), pc[cid].w()) == (rc[cid].h(), rc[cid].w())
        np.testing.assert_allclose(pc[cid].params, rc[cid].params,
                                   rtol=1e-12)
    for iid in ri:
        assert pi[iid].cam_id == ri[iid].cam_id
        assert pi[iid].image_name == ri[iid].image_name
        np.testing.assert_allclose(pi[iid].pose.qvec, ri[iid].pose.qvec,
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(pi[iid].pose.tvec, ri[iid].pose.tvec,
                                   rtol=1e-12)
    assert sorted(pp2) == sorted(rp2)
    for iid in rp2:
        np.testing.assert_array_equal(pp2[iid], rp2[iid])
    assert list(pp3) == list(rp3)
    for pid in rp3:
        np.testing.assert_array_equal(pp3[pid]["xyz"], rp3[pid]["xyz"])
        assert pp3[pid]["image_ids"] == rp3[pid]["image_ids"]
        assert pp3[pid]["point2D_idxs"] == rp3[pid]["point2D_idxs"]


def test_text_reader_reads_the_reference_writer(rng, tmp_path):
    cols = ref_collection(rng)
    pts = points(rng, cols.get_img_ids())
    ref_reader.write_model_txt(str(tmp_path / "m"), cols, pts)
    assert_same_model(read_model(str(tmp_path / "m")),
                      ref_reader.read_model(str(tmp_path / "m")))
    port = ReadInfos(str(tmp_path / "m"), "imgs")
    ref = ref_reader.ReadInfos(str(tmp_path / "m"), "imgs")
    assert port.as_dict() == ref.as_dict()
    assert port.image_name(10) == os.path.join("imgs", "im_0.png")
    assert list(ReadPointTracks(str(tmp_path / "m"))) == list(pts)
    # and the port's writer writes what the reference writes (the
    # quaternions renormalized once more by the collection's round trip)
    write_model_txt(str(tmp_path / "p"), ImageCollection.from_dict(
        cols.as_dict()), pts)
    for name in ("cameras.txt", "points3D.txt"):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "m" / name).read_text()
    assert_same_model(read_model(str(tmp_path / "p")),
                      ref_reader.read_model(str(tmp_path / "m")))


def test_binary_reader_reads_a_packed_model(rng, tmp_path):
    cols = ref_collection(rng)
    pts = points(rng, cols.get_img_ids())
    p2d = {iid: [(rng.uniform(0, 400), rng.uniform(0, 300),
                  int(rng.integers(-1, 130))) for _ in range(k)]
           for k, iid in enumerate(cols.get_img_ids())}
    write_model_bin(str(tmp_path / "b"), cols.cameras, cols.images, pts, p2d)
    port = read_model(str(tmp_path / "b"))
    assert_same_model(port, ref_reader.read_model(str(tmp_path / "b")))
    assert port[2][10].shape == (0, 3) and port[2][12].shape == (1, 3)
    with pytest.raises(FileNotFoundError):
        read_model(str(tmp_path / "none"))


def test_bundler_and_visualsfm_readers_equal_reference(rng, tmp_path):
    with open(tmp_path / "bundle.list.txt", "w") as f:
        f.write("a.jpg\nb.jpg\nc.jpg\n")
    lines = ["# Bundle file v0.3", "3 2"]
    for k in range(3):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.2).as_matrix()
        lines.append(f"{0.0 if k == 1 else 500.0 + k} 0.01 -0.002")
        lines += [" ".join(str(v) for v in r) for r in R]
        lines.append(" ".join(str(v) for v in rng.normal(size=3)))
    for p in range(2):
        lines += [" ".join(str(v) for v in rng.normal(size=3)), "255 0 0",
                  "2 0 5 1.0 2.0 2 7 3.0 4.0"]
    (tmp_path / "bundle.out").write_text("\n".join(lines) + "\n")
    (cols, pts), (rcols, rpts) = (ReadModelBundler(str(tmp_path)),
                                  ref_readers.ReadModelBundler(str(tmp_path)))
    assert cols.get_img_ids() == rcols.get_img_ids() == [0, 2]
    for i in (0, 2):
        np.testing.assert_allclose(cols.campose(i).qvec,
                                   rcols.campose(i).qvec, atol=1e-7)
        np.testing.assert_allclose(cols.campose(i).tvec,
                                   rcols.campose(i).tvec)
    assert [p["image_ids"] for p in pts.values()] == \
        [p["image_ids"] for p in rpts.values()]

    q = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_quat()[[3, 0, 1, 2]]
    nvm = ["NVM_V3", "", "2",
           f"x.jpg 600 {' '.join(map(str, q))} 1 2 3 0.01 0",
           "y.jpg 610 1 0 0 0 -1 0 2 -0.02 0", "", "1",
           "0.5 0.6 7 255 0 0 2 0 1 10 20 1 2 30 40"]
    (tmp_path / "reconstruction.nvm").write_text("\n".join(nvm) + "\n")
    (cols, pts), (rcols, rpts) = (ReadModelVisualSfM(str(tmp_path)),
                                  ref_readers.ReadModelVisualSfM(
                                      str(tmp_path)))
    for i in (0, 1):
        np.testing.assert_allclose(cols.cam(i).params, rcols.cam(i).params)
        np.testing.assert_allclose(cols.campose(i).tvec,
                                   rcols.campose(i).tvec, atol=1e-6)
        assert cols.image_name(i) == rcols.image_name(i)
    assert pts[0]["image_ids"] == rpts[0]["image_ids"] == [0, 1]


def sfm_model_pair(rng, n_images=14, n_points=400):
    port, ref = SfmModel(), ref_model.SfmModel()
    centers = rng.normal(size=(n_images, 3)) * 2
    for m in (port, ref):
        for i in range(n_images):
            m.add_image(centers[i], 50 + 3 * i)
    for _ in range(n_points):
        t = rng.choice(n_images, rng.integers(1, 9), replace=False).tolist()
        if rng.random() < 0.1:
            t = t + t[:1]          # an image listed twice
        xyz = rng.normal(size=3) * 3 + [0, 0, 6]
        port.add_point(xyz, t)
        ref.add_point(xyz, t)
    return port, ref


@pytest.mark.parametrize("neighbor_type", ["dice", "iou", "overlap"])
def test_sfm_model_neighbors_and_ranges_equal_reference(rng, neighbor_type):
    port, ref = sfm_model_pair(rng)
    np.testing.assert_array_equal(port.compute_shared_points(),
                                  ref.compute_shared_points())
    np.testing.assert_array_equal(port.compute_num_points(),
                                  ref.compute_num_points())
    np.testing.assert_allclose(port.compute_triangulation_angles(),
                               ref.compute_triangulation_angles(),
                               atol=1e-12)
    for angle in (1.0, 8.0):
        cfg = {"neighbor_type": neighbor_type,
               "min_triangulation_angle": angle,
               "ranges": {"range_robust": [0.1, 0.9], "k_stretch": 1.5}}
        n_p, r_p = compute_metainfos(cfg, port, 6)
        n_r, r_r = ref_model.compute_metainfos(cfg, ref, 6)
        assert n_p == n_r
        np.testing.assert_array_equal(np.asarray(r_p), np.asarray(r_r))


def test_sfm_model_of_a_collection_and_empty_model(rng):
    cols = ref_collection(rng)
    pts = points(rng, cols.get_img_ids() + [999])
    port = SfmModel.from_imagecols_and_points(
        ImageCollection.from_dict(cols.as_dict()), pts)
    ref = ref_model.SfmModel.from_imagecols_and_points(cols, pts)
    assert port.tracks == ref.tracks
    assert port.reg_image_ids == ref.reg_image_ids
    lo, hi = SfmModel().ComputeRanges()
    assert (lo == -1e9).all() and (hi == 1e9).all()


def sfm_scene(rng, n_views=6, n_points=40):
    """Known poses and one descriptor a 3D point, shared by its views
    (tests/test_pointsfm_sfm.py's scene, projected in float32)."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cams = {0: RefCamera(K=K, hw=(480, 640), cam_id=0)}
    images = {}
    for k in range(n_views):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.03).as_matrix()
        images[k] = RefImage(0, RefPose(R=R, tvec=np.array(
            [0.5 * k, 0.02 * k, 0.0])))
    cols = RefCollection(cams, images)
    pts = rng.normal(size=(n_points, 3))
    pts[:, 2] += 8
    desc = np.eye(n_points, 64)
    features = {}
    for k in range(n_views):
        pose = cols.campose(k)
        pc = pts @ pose.R().T + pose.tvec
        p2d = (pc[:, :2] / pc[:, 2:] * 500 + [320, 240]).astype(np.float32)
        inside = ((p2d[:, 0] > 5) & (p2d[:, 0] < 635)
                  & (p2d[:, 1] > 5) & (p2d[:, 1] < 475))
        features[k] = {"keypoints": p2d[inside], "descriptors": desc[inside],
                       "scores": np.ones(int(inside.sum()))}
    return cols, features, pts


def test_sfm_with_known_poses_equals_reference(rng):
    cols, features, gt = sfm_scene(rng)
    port_cols = ImageCollection.from_dict(cols.as_dict())
    for kw in ({}, {"min_track_length": 3, "pair_ids": [(0, 1), (1, 2),
                                                        (0, 3), (4, 5)]}):
        port = run_sfm_with_known_poses(port_cols, features=features,
                                        device="cpu", **kw)
        ref = ref_sfm.run_sfm_with_known_poses(cols, features=features,
                                               **kw)
        assert list(port) == list(ref) and len(port) >= 10
        for pid in ref:
            assert port[pid]["image_ids"] == ref[pid]["image_ids"]
            np.testing.assert_allclose(port[pid]["xyz"], ref[pid]["xyz"],
                                       atol=1e-4)
            assert sorted(port[pid]["p2ds"]) == sorted(ref[pid]["p2ds"])
    xyz = np.stack([p["xyz"] for p in port.values()])
    assert np.linalg.norm(xyz[:, None] - gt[None], axis=-1).min(1).max() < 0.1
    # given features, the SuperPoint weights are not read (as in JAX)
    same = run_sfm_with_known_poses(port_cols, features=features,
                                    weight_path="superpoint.pth",
                                    device="cpu", **kw)
    assert list(same) == list(port)


def test_colmap_sfm_import_gating_and_pairs(tmp_path):
    cols = ImageCollection.from_dict(ref_collection(
        np.random.default_rng(1), 3).as_dict())
    assert "hloc" not in sys.modules
    with pytest.raises(ImportError, match="run_sfm_with_known_poses"):
        run_colmap_sfm_with_known_poses({}, cols, str(tmp_path / "out"))
    write_pairs_from_neighbors(str(tmp_path / "pairs.txt"), cols,
                               {10: [12, 14], 12: [10], 14: [10]})
    assert (tmp_path / "pairs.txt").read_text().splitlines() == [
        "im_0.png im_1.png", "im_0.png im_2.png"]


def test_colmap_sfm_mocked_drive_sequence(tmp_path, monkeypatch):
    """With fake hloc and pycolmap modules the driver writes the known
    poses, extracts, matches over the neighbour pairs and triangulates,
    then reads the model back."""
    calls = {}
    hloc = types.ModuleType("hloc")
    ef = types.ModuleType("hloc.extract_features")
    ef.confs = {"superpoint_aachen": {"output": "feats-spp"}}
    ef.main = lambda conf, image_dir, outputs: calls.setdefault(
        "extract", outputs / "feats.h5")
    mf = types.ModuleType("hloc.match_features")
    mf.confs = {"NN-superpoint": {"output": "matches-nn"}}
    mf.main = lambda conf, pairs, feature_out, outputs: calls.setdefault(
        "match", str(pairs))
    tr = types.ModuleType("hloc.triangulation")

    def tr_main(sfm_dir, ref_model_dir, image_dir, pairs, feats, matches):
        import shutil
        calls["triangulate"] = str(ref_model_dir)
        shutil.copytree(ref_model_dir, sfm_dir)

    tr.main = tr_main
    hloc.extract_features, hloc.match_features, hloc.triangulation = \
        ef, mf, tr
    for name, mod in (("hloc", hloc), ("hloc.extract_features", ef),
                      ("hloc.match_features", mf),
                      ("hloc.triangulation", tr),
                      ("pycolmap", types.ModuleType("pycolmap"))):
        monkeypatch.setitem(sys.modules, name, mod)
    cols = ImageCollection.from_dict(ref_collection(
        np.random.default_rng(2), 3).as_dict())
    out = run_colmap_sfm_with_known_poses(
        {"hloc": {"descriptor": "superpoint_aachen",
                  "matcher": "NN-superpoint"}}, cols, str(tmp_path / "out"),
        neighbors={10: [12], 12: [14], 14: []})
    assert set(calls) == {"extract", "match", "triangulate"}
    assert calls["match"].endswith("pairs-from-neighbors.txt")
    assert out == {}
    assert (tmp_path / "out" / "reference_model" / "images.txt").exists()
