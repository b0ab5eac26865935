"""VP triangulation in the port against the JAX package, on the CPU: the
two VP functions, the frame of the neighbour line's VP, the triangulator
with the VP banks, and the COLMAP path of the runner with use_vp, a
point model and a distorted camera.

The JAX package turns the neighbour line's VP into a direction with the
own view (limap_tpu/triangulation/triangulator.py:307-311); a VP is in
its own image's pixels, so the port uses the neighbour's view
(test_neighbour_vp_needs_its_own_view).  Where the package and the port
are compared, every view has the same rotation and intrinsics, so both
conventions give the same direction.  Tolerances: directions 1e-6,
triangulated endpoints 1e-4 m, edge tables and supports equal."""

import copy
import os

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.pointsfm import ReadInfos as ref_read_infos
from limap_tpu.pointsfm import ReadPointTracks as ref_read_points
from limap_tpu.runners import line_triangulation as ref_line_triangulation
from limap_tpu.triangulation import functions as jfun
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu.vplib import VPResult as JResult
import jax.numpy as jnp
from limap_tpu_torch.base.camera import Camera, CameraPose, CameraViewsBatch
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.pointsfm import (ReadInfos, ReadPointTracks,
                                      write_model_txt)
from limap_tpu_torch.runners import line_triangulation
from limap_tpu_torch.testing import pipeline
from limap_tpu_torch.triangulation import functions as pfun
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)
from limap_tpu_torch.vplib import VPResult

from test_torch_edge_cases import jax_collection
from test_torch_runner import nearest_line_distance, small_cfg
from torch_threads import two_torch_threads  # noqa: F401

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
KVEC = np.array([500.0, 500.0, 320.0, 240.0])


def quat(R):
    return Rotation.from_matrix(R).as_quat()[[3, 0, 1, 2]]


def views(R, t, lib):
    """(kvec, qvec, tvec) float32 of views [n] in torch or jnp."""
    R, t = np.asarray(R).reshape(-1, 3, 3), np.asarray(t).reshape(-1, 3)
    arrs = [np.tile(KVEC, (len(R), 1)), np.stack([quat(r) for r in R]), t]
    return [lib(np.asarray(a, np.float32)) for a in arrs]


def test_vp_functions_equal_reference(rng):
    n = 200
    R = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.2).as_matrix()
    t = rng.normal(size=(n, 3))
    vp = rng.normal(size=(n, 3)) * [300.0, 300.0, 1.0]
    pv = CameraViewsBatch(*views(R, t, torch.as_tensor))
    jv = JViews(*views(R, t, jnp.asarray))
    np.testing.assert_allclose(
        pfun.get_direction_from_vp(torch.as_tensor(vp, dtype=torch.float32),
                                   pv).numpy(),
        np.asarray(jfun.get_direction_from_vp(jnp.asarray(vp, jnp.float32),
                                              jv)), atol=1e-6)
    # two views of random lines, each triangulated along its direction
    R2 = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.1).as_matrix()
    t2 = t + rng.normal(size=(n, 3))
    seg = rng.uniform([50, 50, 50, 50], [590, 430, 590, 430], (n, 4))
    seg2 = seg + rng.normal(size=(n, 4)) * 20
    d = rng.normal(size=(n, 3))
    p1, p2 = pv, CameraViewsBatch(*views(R2, t2, torch.as_tensor))
    j2 = JViews(*views(R2, t2, jnp.asarray))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    g = lambda a: jnp.asarray(a, jnp.float32)
    out = pfun.triangulate_line_with_direction(
        Segments(f(seg[:, :2]), f(seg[:, 2:])), p1,
        Segments(f(seg2[:, :2]), f(seg2[:, 2:])), p2, f(d))
    ref = jfun.triangulate_line_with_direction(
        JSegments(g(seg[:, :2]), g(seg[:, 2:])), jv,
        JSegments(g(seg2[:, :2]), g(seg2[:, 2:])), j2, g(d))
    ok = np.asarray(ref.score) > 0
    assert 20 < ok.sum() < n
    np.testing.assert_array_equal(out.score.numpy(), np.asarray(ref.score))
    depth = np.abs(np.asarray(ref.depths)).max(-1, keepdims=True)
    for a, b in ((out.start, ref.start), (out.end, ref.end)):
        err = np.abs(a.numpy() - np.asarray(b)) / np.maximum(depth, 1.0)
        assert err[ok].max() < 1e-4


def test_neighbour_vp_needs_its_own_view():
    """A GT line seen by two views with different rotations: its exact VP
    in view 2 turns into the GT direction with view 2's R and K (the
    port), not with view 1's (the JAX package's VP bank 2)."""
    R1, t1 = np.eye(3), np.zeros(3)
    R2 = Rotation.from_rotvec([0.1, -0.3, 0.05]).as_matrix()
    t2 = -R2 @ np.array([1.0, 0.2, 0.0])
    P = np.array([[-1.0, 0.5, 6.0], [1.5, -0.3, 7.0]])
    d = (P[1] - P[0]) / np.linalg.norm(P[1] - P[0])
    vp2 = K @ R2 @ d

    def proj(R, t, X):
        x = K @ (R @ X + t)
        return x[:2] / x[2]

    v1 = CameraViewsBatch(*views(R1, t1, torch.as_tensor))
    v2 = CameraViewsBatch(*views(R2, t2, torch.as_tensor))
    vp = torch.as_tensor(vp2, dtype=torch.float32)[None]
    angle = lambda v: np.degrees(np.arccos(min(1.0, abs(
        float(pfun.get_direction_from_vp(vp, v)[0] @ torch.as_tensor(
            d, dtype=torch.float32))))))
    assert angle(v2) < 1e-3
    assert angle(v1) > 10.0
    # the JAX package's view-1 conversion gives the same miss
    jd = np.asarray(jfun.get_direction_from_vp(
        jnp.asarray(vp2, jnp.float32)[None], JViews(*views(
            R1, t1, jnp.asarray))))[0]
    assert np.degrees(np.arccos(min(1.0, abs(jd @ d)))) > 10.0
    # triangulated along view 2's direction, the line is the GT line
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    l1 = Segments(f(proj(R1, t1, P[0])), f(proj(R1, t1, P[1])))
    l2 = Segments(f(proj(R2, t2, P[0])), f(proj(R2, t2, P[1])))
    tri = pfun.triangulate_line_with_direction(
        l1, v1, l2, v2, pfun.get_direction_from_vp(vp, v2))
    np.testing.assert_allclose(tri.start[0].numpy(), P[0], atol=1e-4)
    np.testing.assert_allclose(tri.end[0].numpy(), P[1], atol=1e-4)


def translation_scene(rng, n_views=6, n_lines=40, noise=0.2):
    """Views that share R = I and K; lines 0, 3, 6, ... share line 0's
    direction and lines 1, 4, 7, ... line 1's, the others are random;
    each view's VPs are the exact K d of the two shared directions, the
    others unlabelled; identity matches with every other view."""
    images = {k: CameraImage(0, CameraPose(tvec=np.array(
        [-0.5 * k, 0.1 * (k % 3), 0.05 * k]))) for k in range(n_views)}
    cols = ImageCollection({0: Camera(K=K, hw=(480, 640), cam_id=0)}, images)
    start = rng.normal(size=(n_lines, 3)) * [2.0, 1.5, 1.0] + [1.2, 0, 9]
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    labels = np.where(np.arange(n_lines) % 3 == 2, -1,
                      np.arange(n_lines) % 3)
    d[labels >= 0] = d[labels[labels >= 0]]
    end = start + d * rng.uniform(1.0, 3.0, (n_lines, 1))
    segs, vps = {}, {}
    for k in range(n_views):
        t = images[k].pose.tvec
        x1 = (K @ (start + t).T).T
        x2 = (K @ (end + t).T).T
        segs[k] = (np.concatenate([x1[:, :2] / x1[:, 2:],
                                   x2[:, :2] / x2[:, 2:]], 1)
                   + rng.normal(0, noise, (n_lines, 4))).astype(np.float32)
        vps[k] = (labels, (K @ d[[0, 1]].T).T)
    m = np.stack([np.arange(n_lines)] * 2, 1)
    matches = {i: {j: m for j in range(n_views) if j != i}
               for i in range(n_views)}
    return cols, segs, matches, vps


@pytest.mark.parametrize("options", [{}, {"disable_algebraic_triangulation":
                                          True}], ids=["algebraic+vp", "vp"])
def test_triangulator_with_vp_matches_reference(rng, options):
    cols, segs, matches, vps = translation_scene(rng)
    cfg = dict(max_tris_per_node=8, use_vp=True, **options)
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    jt = JTri(JCfg(**cfg))
    pt.init(segs, cols)
    jt.init(segs, jax_collection(cols))
    pt.init_vp_results({k: VPResult(*v) for k, v in vps.items()})
    jt.init_vp_results({k: JResult(*v) for k, v in vps.items()})
    pt.triangulate_all(matches)
    jt.triangulate_all(matches)
    _, outs, _ = jt._dev_results
    ref_f = np.concatenate([np.asarray(o[1]) for o in outs])[:6]
    ref_i = np.concatenate([np.asarray(o[2]) for o in outs])[:6]
    floats, ints, _ = pt._tables()
    np.testing.assert_array_equal(ints.numpy(), ref_i)
    scored = ref_f[..., 9] > 0
    assert scored.sum() > 100
    depth = np.maximum(np.abs(ref_f[..., 6:8]).max(-1), 1.0)
    err = np.abs(floats.numpy()[..., :6] - ref_f[..., :6]).max(-1) / depth
    assert err[scored].max() < 1e-4
    np.testing.assert_allclose(floats.numpy()[..., 9][scored],
                               ref_f[..., 9][scored], atol=2e-3)
    pb, jb = pt.compute_track_batch(), jt.compute_track_batch()
    assert int(pb.track_mask.sum()) == int(np.asarray(jb.track_mask).sum()) > 5
    for f in ("img_index", "line_ids", "mask"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_exhaustive_matcher_with_vp_is_refused(rng, tmp_path):
    cols, segs, matches, vps = translation_scene(rng, n_views=3, n_lines=6)
    pt = GlobalLineTriangulator(TriangulatorConfig(use_vp=True),
                                device="cpu")
    pt.init(segs, cols)
    pt.init_vp_results({k: VPResult(*v) for k, v in vps.items()})
    with pytest.raises(NotImplementedError, match="queue 2"):
        pt.triangulate_all_exhaustive({i: sorted(m) for i, m in
                                       matches.items()})
    off = GlobalLineTriangulator(TriangulatorConfig(
        disable_algebraic_triangulation=True), device="cpu")
    off.init(segs, cols)
    with pytest.raises(ValueError, match="no proposal bank"):
        off.triangulate_all(matches)


def facade_model(rng, folder, n_views=6, k1=0.04):
    """Six views of 240x320 sharing R = I and a SIMPLE_RADIAL camera,
    rendered with that distortion, a wall of horizontal and vertical
    lines, and a COLMAP text model of the views and of wall points."""
    H, W = 240, 320
    f = 300.0
    cam = Camera("SIMPLE_RADIAL", [f, W / 2, H / 2, k1], cam_id=0,
                 hw=(H, W))
    gt = []
    for i in range(8):
        y = -2.6 + 5.2 * i / 7
        gt.append([[rng.uniform(-4, -2.5), y, 10], [rng.uniform(1.5, 3.5),
                                                     y, 10]])
    for i in range(6):
        x = -3.5 + 6.5 * i / 5
        gt.append([[x, rng.uniform(-3, -1.5), 10], [x, rng.uniform(1, 3),
                                                     10]])
    gt = np.asarray(gt)
    images = {}
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for k in range(n_views):
        t = -np.array([1.2 * (k - 3), 0.5 * ((k % 2) - 0.5) + 0.2 * k,
                       0.3 * k])
        img = np.full((H, W), 230, np.uint8)
        for li, line in enumerate(gt):
            p1, p2 = ((K_small(f, W, H) @ (X + t))[:2]
                      / (X + t)[2] for X in line)
            pipeline.draw_line(img, p1.astype(int), p2.astype(int),
                               20 + (li * 37) % 180)
        # distort: each distorted pixel shows its pinhole pixel
        inv_x, inv_y = distortion_inverse(xs, ys, f, W, H, k1)
        dist = cv2.remap(img, inv_x, inv_y, cv2.INTER_LINEAR,
                         borderValue=230)
        noise = rng.normal(size=(H, W)) * 2
        dist = np.clip(dist + noise, 0, 255).astype(np.uint8)
        name = f"img_{k}.png"
        cv2.imwrite(os.path.join(folder, name), dist)
        images[k] = CameraImage(0, CameraPose(tvec=t), name)
    cols = ImageCollection({0: cam}, images)
    pts = {p: {"xyz": np.array([rng.uniform(-4, 3.5), rng.uniform(-3, 3),
                                rng.uniform(8.5, 11.5)]),
               "image_ids": list(range(n_views))} for p in range(80)}
    write_model_txt(os.path.join(folder, "sparse"), cols, pts)
    return os.path.join(folder, "sparse"), gt


def K_small(f, W, H):
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])


def distortion_inverse(xs, ys, f, W, H, k1):
    """For each distorted pixel the pinhole pixel it shows (a few
    fixed-point steps of the SIMPLE_RADIAL model)."""
    ud, vd = (xs - W / 2) / f, (ys - H / 2) / f
    u, v = ud.copy(), vd.copy()
    for _ in range(10):
        r2 = u * u + v * v
        u, v = ud / (1 + k1 * r2), vd / (1 + k1 * r2)
    return ((u * f + W / 2).astype(np.float32),
            (v * f + H / 2).astype(np.float32))


def test_runner_with_vp_point_model_and_distortion_matches_reference(
        rng, tmp_path, monkeypatch):
    """The COLMAP path: a SIMPLE_RADIAL model read by each package,
    undistorted, neighbours and ranges from its points, VP detection and
    the VP banks; as many good tracks (one of slack), every good line
    within 5 cm of a reference line, as tests/test_torch_runner.py holds
    the runner (a stroke gives two near-tied segments, and a score or
    filter threshold may fall either way).  The JAX
    package's runner gets the port's undistorted images and camera: its
    own undistortion writes the first image of a camera only (ROADMAP.md
    section 3; tests/test_torch_undistortion.py holds the images to its
    OpenCV calls), and the port's VP labels and VPs: the two packages
    draw their hypotheses from different generators
    (test_torch_vplib.py holds the detectors to each other on the same
    hypotheses)."""
    import limap_tpu.vplib
    model, gt = facade_model(rng, str(tmp_path))
    seen = {}
    port_init = GlobalLineTriangulator.init_vp_results

    def record(self, vpresults):
        seen.update(vpresults)
        return port_init(self, vpresults)

    class Replay:
        def detect_vp_all_images(self, segs, camviews=None):
            assert sorted(segs) == sorted(seen)
            return {i: JResult(seen[i].labels, seen[i].vps) for i in segs}

    monkeypatch.setattr(GlobalLineTriangulator, "init_vp_results", record)
    monkeypatch.setattr(limap_tpu.vplib, "get_vp_detector",
                        lambda cfg, n_jobs=1: Replay())
    cfg = small_cfg(tmp_path / "port")
    cfg["triangulation"]["use_vp"] = True
    cfg["triangulation"]["vpdet_config"]["min_num_supports"] = 4
    # the line BA is held to JAX elsewhere (test_torch_runner.py)
    cfg["refinement"]["disable"] = True
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg["output_dir"] = str(tmp_path / "ref")
    cols = ReadInfos(model, str(tmp_path))
    assert not cols.IsUndistorted()
    tracks = line_triangulation(cfg, cols, points3d=ReadPointTracks(model),
                                device="cpu")
    und = np.load(tmp_path / "port" / "imagecols.npy",
                  allow_pickle=True).item()
    assert all(os.path.exists(im["image_name"])
               for im in und["images"].values())
    assert sum(r.count_vps() for r in seen.values()) >= 2 * len(seen)
    ref_cols = ref_read_infos(model, str(tmp_path))
    ref_cols = type(ref_cols).from_dict(und)
    ref = ref_line_triangulation(ref_cfg, ref_cols,
                                 points3d=ref_read_points(model))
    good = [t for t in tracks if t.count_images() >= 3]
    ref_good = [t for t in ref if t.count_images() >= 3]
    assert len(good) >= 8
    assert abs(len(good) - len(ref_good)) <= 1
    assert abs(len(tracks) - len(ref)) <= 2
    far = [t for t in good if nearest_line_distance(t, ref) > 0.05]
    assert len(far) <= 1, [t.line for t in far]
    with open(tmp_path / "port" / "metainfos.txt") as a, \
            open(tmp_path / "ref" / "metainfos.txt") as b:
        assert a.read() == b.read()
