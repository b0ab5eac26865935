"""The port's host API of the base containers and helpers against the
JAX package's on the same numpy inputs (CPU): the camera, image
collection, track, segment and pose methods, ``count_component_sizes``,
``base/align.py``, ``base/graph.py``, ``util/geometry.py`` and the
image-name and Line3D++ files across the two packages (the counterparts
of tests/test_pose.py and tests/test_io_l3dpp.py).  fp32 device values
within 1e-5, host float64 values within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import limap_tpu.base.align as jalign
import limap_tpu.base.camera as jcam
import limap_tpu.base.graph as jgraph
import limap_tpu.base.image_collection as jic
import limap_tpu.base.infinite_line as jinf
import limap_tpu.base.linetrack as jlt
import limap_tpu.base.pose as jpose
import limap_tpu.util.geometry as jgeo
from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.ops.connected_components import \
    count_component_sizes as jcount
from limap_tpu.util import io as jio
from limap_tpu_torch.base import align, graph
from limap_tpu_torch.base import camera as pcam
from limap_tpu_torch.base import image_collection as pic
from limap_tpu_torch.base import linetrack as plt_
from limap_tpu_torch.base import pose as ppose
from limap_tpu_torch.base.infinite_line import get_direction_from_vp
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops import count_component_sizes
from limap_tpu_torch.util import geometry as pgeo
from limap_tpu_torch.util import io as pio
from torch_threads import two_torch_threads  # noqa: F401

F32, F64 = 1e-5, 1e-9


def _collection(mod_cam, mod_ic, rng, n=5):
    """Two cameras (one uninitialized), n images (one unposed)."""
    cams = {0: mod_cam.Camera(K=np.array([[500.0, 0, 320], [0, 510, 240],
                                          [0, 0, 1]]), hw=(480, 640),
                              cam_id=0),
            3: mod_cam.Camera(model=0, params=[0.0, 0, 0], hw=(200, 300),
                              cam_id=3)}
    imgs = {}
    for i in range(n):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
        pose = mod_cam.CameraPose(R=R, tvec=rng.normal(size=3)) \
            if i != 2 else mod_cam.CameraPose(initialized=False)
        imgs[10 + i] = mod_ic.CameraImage(0 if i < 4 else 3, pose,
                                          f"img_{i}.png")
    return mod_ic.ImageCollection(cams, imgs)


@pytest.fixture()
def cols():
    return (_collection(jcam, jic, np.random.default_rng(0)),
            _collection(pcam, pic, np.random.default_rng(0)))


def _same(a, b, tol=F64):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, tol)
    elif isinstance(a, (str, bool, int, type(None))):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=tol)


def _dump(col):
    return col.as_dict()


def test_camera_and_view_methods(cols):
    jc, pc = cols
    p3d = np.array([0.3, -0.2, 4.0])
    for i in (10, 11, 13):          # posed, on the initialized camera
        jv, pv = jc.camview(i), pc.camview(i)
        # float32 rotation matrices on both sides, host arithmetic after
        _same(jv.matrix(), pv.matrix(), 1e-6)
        _same(jv.projection(p3d), pv.projection(p3d), 1e-4)
        _same(jv.ray_direction([100.0, 50.0]), pv.ray_direction(
            [100.0, 50.0]), 1e-7)
        _same(jv.pose.projdepth(p3d), pv.pose.projdepth(p3d), 1e-6)
        _same(jv.as_dict(), pv.as_dict())
        back = pcam.CameraView.from_dict(jv.as_dict())
        _same(back.as_dict(), jv.as_dict())
        _same(jc.camimage(i).R(), pc.camimage(i).R(), 0)
        _same(jc.camimage(i).T(), pc.camimage(i).T(), 0)
    for depth in (1.0, 7.5):
        _same(jc.cam(0).uncertainty(depth), pc.cam(0).uncertainty(depth))
        _same(jc.cam(0).uncertainty(depth, 2.0),
              pc.cam(0).uncertainty(depth, 2.0))
    ids = [10, 11, 13]
    jb = jcam.CameraViewsBatch.from_views([jc.camview(i) for i in ids])
    pb = pcam.CameraViewsBatch.from_views([pc.camview(i) for i in ids],
                                          device="cpu")
    _same(np.asarray(jb.R()), pb.R().numpy(), F32)
    _same(np.asarray(jb.K()), pb.K().numpy(), 0)


@pytest.mark.parametrize("method", [
    "NumCameras", "get_cameras", "get_images", "get_map_locations",
    "get_image_name_list", "get_image_name_dict", "exist_cam",
    "get_first_image_id_by_camera_id", "IsUndistortedCameraModel",
    "subset_by_camera_ids", "subset_initialized", "from_views",
    "apply_similarity_transform", "change_image", "set_camera_params",
    "init_uninitialized_cameras", "uninitialize_poses",
    "uninitialize_intrinsics"])
def test_image_collection_methods(cols, method):
    """Each of the 18 methods, on both packages' copies of one
    collection: the same result, and the same collection after it."""
    jc, pc = cols
    R = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    calls = {
        "NumCameras": lambda c, m: c.NumCameras(),
        "get_cameras": lambda c, m: [x.as_dict() for x in c.get_cameras()],
        "get_images": lambda c, m: [x.as_dict() for x in c.get_images()],
        "get_map_locations": lambda c, m: c.get_map_locations(),
        "get_image_name_list": lambda c, m: c.get_image_name_list(),
        "get_image_name_dict": lambda c, m: c.get_image_name_dict(),
        "exist_cam": lambda c, m: [c.exist_cam(3), c.exist_cam(1)],
        "get_first_image_id_by_camera_id": lambda c, m: [
            c.get_first_image_id_by_camera_id(k) for k in (0, 3, 7)],
        "IsUndistortedCameraModel": lambda c, m: c.IsUndistortedCameraModel(),
        "subset_by_camera_ids": lambda c, m: _dump(
            c.subset_by_camera_ids([3])),
        "subset_initialized": lambda c, m: _dump(c.subset_initialized()),
        "from_views": lambda c, m: _dump(m[1].ImageCollection.from_views(
            c.get_camviews())),
        "apply_similarity_transform": lambda c, m: _dump(
            c.apply_similarity_transform(1.7, R, [0.5, -1.0, 2.0])),
        "change_image": lambda c, m: c.change_image(11, m[1].CameraImage(
            3, m[0].CameraPose(tvec=[1.0, 2, 3]), "new.png")),
        "set_camera_params": lambda c, m: c.set_camera_params(
            0, [400.0, 410, 300, 200]),
        "init_uninitialized_cameras": lambda c, m:
            c.init_uninitialized_cameras(),
        "uninitialize_poses": lambda c, m: c.uninitialize_poses(),
        "uninitialize_intrinsics": lambda c, m: c.uninitialize_intrinsics(),
    }
    # the rotations pass through float32 on both sides
    tol = 1e-5 if method in ("get_map_locations",
                             "apply_similarity_transform") else F64
    _same(calls[method](jc, (jcam, jic)), calls[method](pc, (pcam, pic)),
          tol)
    _same(_dump(jc), _dump(pc), tol)


def _tracks(mod, rng, n=4):
    out = []
    for k in range(n):
        imgs = list(rng.integers(0, 5, 2 + k))
        out.append(mod.LineTrack(
            line=rng.normal(size=(2, 3)), image_id_list=imgs,
            line_id_list=list(range(len(imgs))),
            line2d_list=[rng.normal(size=(2, 2)) for _ in imgs],
            line3d_list=[rng.normal(size=(2, 3)) for _ in imgs],
            score_list=list(rng.uniform(size=len(imgs)))))
    return out


def test_linetrack_and_batches():
    jt = _tracks(jlt, np.random.default_rng(1))
    pt = _tracks(plt_, np.random.default_rng(1))
    for a, b in zip(jt, pt):
        assert a.GetSortedImageIds() == b.GetSortedImageIds()
        assert [a.HasImage(i) for i in range(6)] \
            == [b.HasImage(i) for i in range(6)]
        assert a.GetIdMap() == b.GetIdMap()
        _same(a.start, b.start, 0)
        _same(a.end, b.end, 0)
    id2idx = {i: i for i in range(5)}
    jb = jlt.tracks_to_batch(jt, id2idx)
    pb = plt_.tracks_to_batch(pt, id2idx, device="cpu")
    assert pb.num_tracks == len(pt) and pb.max_supports >= 5
    _same(pb.count_lines().numpy(), [t.count_lines() for t in pt], 0)
    _same(np.asarray(jb.count_lines())[:len(jt)],
          pb.count_lines().numpy(), 0)
    ti, fields = plt_.HostTrackBatch.download(pb).flat_supports()
    jti, jfields = jlt.HostTrackBatch.download(jb).flat_supports()
    keep = jti < len(jt)
    _same(ti, jti[keep], 0)
    for a, b in zip(fields, jfields):
        _same(a, np.asarray(b)[keep], F32)


def test_segments_methods():
    rng = np.random.default_rng(2)
    for D in (2, 3):
        s, e = rng.normal(size=(2, 7, D)).astype(np.float32)
        p = rng.normal(size=(7, D)).astype(np.float32) * 2
        js = JSegments(jnp.asarray(s), jnp.asarray(e))
        ps = Segments(torch.as_tensor(s), torch.as_tensor(e))
        pairs = [(js.point_projection(jnp.asarray(p)),
                  ps.point_projection(torch.as_tensor(p))),
                 (js.point_distance(jnp.asarray(p)),
                  ps.point_distance(torch.as_tensor(p))),
                 (js.as_array(), ps.as_array()), (js.as_flat(), ps.as_flat()),
                 (js.select(np.array([3, 0])).as_flat(),
                  ps.select(torch.tensor([3, 0])).as_flat())]
        if D == 2:
            pairs.append((js.perp_direction(), ps.perp_direction()))
        for a, b in pairs:
            _same(np.asarray(a), b.numpy(), F32)


def test_pose_center_projdepth_and_vp_direction():
    """The counterpart of tests/test_pose.py::test_pose_center_projdepth,
    and the camera-frame direction of a vanishing point."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(8, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t, p = rng.normal(size=(2, 8, 3))
    q32, t32, p32 = (x.astype(np.float32) for x in (q, t, p))
    C = ppose.pose_center(*map(torch.as_tensor, (q32, t32))).numpy()
    R = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    _same(C, -np.einsum("nji,nj->ni", R, t), F32)
    _same(C, np.asarray(jpose.pose_center(jnp.asarray(q32),
                                          jnp.asarray(t32))), F32)
    d = ppose.projdepth(*map(torch.as_tensor, (q32, t32, p32))).numpy()
    _same(d, (np.einsum("nij,nj->ni", R, p) + t)[:, 2], F32)
    _same(d, np.asarray(jpose.projdepth(*map(jnp.asarray,
                                             (q32, t32, p32)))), F32)
    vp = rng.normal(size=(8, 3)).astype(np.float32)
    kvec = np.array([500.0, 510, 320, 240], np.float32)
    _same(get_direction_from_vp(torch.as_tensor(vp),
                                torch.as_tensor(kvec)).numpy(),
          np.asarray(jinf.get_direction_from_vp(jnp.asarray(vp),
                                                jnp.asarray(kvec))), F32)


def test_count_component_sizes():
    labels = np.array([0, 2, 2, -1, 1, 2, -1, 0, 3], np.int32)
    for n in (4, 6):
        _same(count_component_sizes(torch.as_tensor(labels), n).numpy(),
              np.asarray(jcount(jnp.asarray(labels), n)), 0)


def test_align_umeyama_and_transforms(cols):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 20))
    R = Rotation.from_rotvec([0.2, 0.5, -0.3]).as_matrix()
    y = 2.5 * R @ x + np.array([[1.0], [-2.0], [0.5]]) \
        + rng.normal(0, 1e-3, (3, 20))
    _same(align.umeyama_alignment(x, y), jalign.umeyama_alignment(x, y))
    jc, pc = cols
    dst_j = jc.apply_similarity_transform(0.8, R, [1.0, 0.0, -1.0])
    dst_p = pc.apply_similarity_transform(0.8, R, [1.0, 0.0, -1.0])
    (tj, cj), (tp, cp) = (jalign.align_imagecols_umeyama(jc, dst_j),
                          align.align_imagecols_umeyama(pc, dst_p))
    _same(tj, tp, 1e-5)
    _same(_dump(cj), _dump(cp), 1e-5)
    Rt, tt, s = tp
    jt = _tracks(jlt, np.random.default_rng(5))
    pt = _tracks(plt_, np.random.default_rng(5))
    for a, b in zip(jalign.transform_linetracks(jt, Rt, tt, s),
                    align.transform_linetracks(pt, Rt, tt, s)):
        _same(a.line, b.line)
        _same(a.line3d_list, b.line3d_list)


def test_graph():
    out = []
    for mod in (jgraph, graph):
        g = mod.Graph()
        nodes = [g.FindOrCreateNode(i % 3, i) for i in range(8)]
        assert g.FindOrCreateNode(0, 0) is nodes[0]
        for a, b, s in ((0, 1, 0.5), (1, 2, 0.9), (4, 5, 0.3), (6, 5, 1.0)):
            g.AddEdge(nodes[a], nodes[b], s)
        labels = mod.compute_track_labels(g)
        out.append((labels.tolist(), g.GetNodeID(1, 4), g.GetNodeID(9, 9),
                    [mod.union_find_get_root(i, [-1, 0, 1, -1, 3])
                     for i in range(5)],
                    [(e.node_idx1, e.node_idx2, e.sim)
                     for e in g.undirected_edges],
                    [(n.out_edges, n.in_edges) for n in g.nodes]))
        g.Clear()
        assert not g.nodes
    assert out[0] == out[1]
    assert out[1][0] == [0, 0, 0, -1, 1, 1, 1, -1]


def test_util_geometry():
    rng = np.random.default_rng(6)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    F = rng.normal(size=(3, 3))
    P = rng.normal(size=(5, 3))
    for name, args, tol in (
            ("to_homogeneous", (P,), 0), ("to_cartesian", (P,), 0),
            ("rotation_from_quaternion", (q,), F32),
            ("quaternion_from_rotation",
             (Rotation.from_quat(q[[1, 2, 3, 0]]).as_matrix(),), F32),
            ("skew_symmetric", (P[0],), 0),
            ("compute_epipolar_line", (F, P[0, :2]), F64)):
        _same(getattr(jgeo, name)(*args), getattr(pgeo, name)(*args), tol)
    for alpha in (0.0, 0.3, 1.0):
        a = jgeo.interpolate_pose(jcam.CameraPose(qvec=q, tvec=P[0]),
                                  jcam.CameraPose(tvec=P[1]), alpha)
        b = pgeo.interpolate_pose(pcam.CameraPose(qvec=q, tvec=P[0]),
                                  pcam.CameraPose(tvec=P[1]), alpha)
        _same(a.as_dict(), b.as_dict())


def test_imname_files_cross_read(tmp_path):
    names = {3: "a.png", 0: "dir/b c.jpg", 7: ""}
    pio.save_txt_imname_dict(str(tmp_path / "p.txt"), names)
    jio.save_txt_imname_dict(str(tmp_path / "j.txt"), names)
    assert jio.read_txt_imname_dict(str(tmp_path / "p.txt")) == names
    assert pio.read_txt_imname_dict(str(tmp_path / "j.txt")) == names
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_read_txt_line3dpp(tmp_path):
    """The record of tests/test_io_l3dpp.py, read by both packages."""
    rec = ["2", "0 0 5 1 0 5", "1 0 5 2 0 5", "3", "0 4 10 10 50 10",
           "1 7 12 12 52 12", "2 9 14 14 54 14"]
    rec2 = ["1", "0 1 6 0 2 6", "2", "0 2 20 20 20 60", "1 3 22 20 22 60"]
    fname = tmp_path / "Line3D++_result.txt"
    fname.write_text(" ".join(rec) + "\n" + " ".join(rec2) + "\n")
    tracks, ids, counts, mergemat = pio.read_txt_Line3Dpp(str(fname))
    jtracks, jids, jcounts, jmerge = jio.read_txt_Line3Dpp(str(fname))
    assert len(tracks) == 2 and ids == jids == [0, 0, 1]
    assert counts == jcounts == [3, 3, 2]
    _same(mergemat, jmerge, 0)
    for a, b in zip(tracks, jtracks):
        _same(a.as_dict(), b.as_dict())
    assert tracks[0].line_id_list == [4, 7, 9]
    _same(tracks[0].line2d_list[0], [[10, 10], [50, 10]], 0)


def test_save_l3dpp(tmp_path, cols):
    """The port writes Line3D++'s input files: one a view, named by the
    view's id (or its rank for Tanks and Temples names) and the first
    camera's size.  JAX's writer asks the camera for an ``hw`` it does
    not have and raises: the port does not follow it."""
    jc, pc = cols
    segs = {i: np.arange(8, dtype=np.float64).reshape(2, 4) + i
            for i in pc.get_img_ids()}
    pio.save_l3dpp(str(tmp_path / "l3d"), pc, segs)
    files = sorted(p.name for p in (tmp_path / "l3d").iterdir())
    assert files == [f"segments_L3D++_{i}_640x480_3000.txt"
                     for i in sorted(pc.get_img_ids())]
    lines = (tmp_path / "l3d" / files[1]).read_text().split("\n")
    assert lines[0] == "2" and lines[1] == "11.0 12.0 13.0 14.0"
    with pytest.raises(AttributeError, match="hw"):
        jio.save_l3dpp(str(tmp_path / "jax"), jc, segs)
    for k, i in enumerate(pc.get_img_ids()):
        pc.change_image_name(i, f"0000{9 - k}.jpg")
    pio.save_l3dpp(str(tmp_path / "tnt"), pc, segs)
    assert sorted(p.name for p in (tmp_path / "tnt").iterdir()) == [
        f"segments_L3D++_{k}_640x480_3000.txt" for k in range(5)]
    first = (tmp_path / "tnt" / "segments_L3D++_4_640x480_3000.txt")
    assert first.read_text().split("\n")[1] == "10.0 11.0 12.0 13.0"
