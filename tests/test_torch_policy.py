"""The port's rules: it imports neither JAX nor the JAX package, and its
entry points run on the GPU unless the caller asks for the CPU."""

import pathlib
import re

import numpy as np
import pytest
import torch

import limap_tpu_torch
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.base.linetrack import batch_from_flat_supports
from limap_tpu_torch.evaluation.evaluator import PointCloudEvaluator
from limap_tpu_torch.merging.merging import compact_track_batch
from limap_tpu_torch.testing.synthetic import build_scene
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)
from torch_threads import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+limap_tpu(\.|\s|$|,)"
    r"|from\s+limap_tpu(\.|\s))", re.M)


def _port_files():
    files = sorted((ROOT / "limap_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    covered = {str(f.relative_to(ROOT)) for f in files}
    for new in ("line2d/base.py", "line2d/tpu_lsd.py", "line2d/endpoints.py",
                "line2d/lsd.py", "line2d/line_utils.py",
                "runners/functions.py", "runners/line_triangulation.py",
                "testing/pipeline.py", "util/config.py", "util/io.py",
                "util/profiler.py", "ops/polynomial.py",
                "ops/trace_roots.py", "ops/pose_score.py",
                "ops/epipolar_iou.py", "estimators/p3p.py",
                "estimators/pnl_solvers.py", "estimators/absolute_pose.py",
                "optimize/hybrid_localization.py", "base/functions.py",
                "util/evaluation.py", "runners/hybrid_localization.py",
                "testing/localization.py", "testing/kernel_checks.py",
                "base/depth_reader_base.py", "base/p3d_reader_base.py",
                "ops/line_ransac.py", "ops/linker_edges.py",
                "fitting/fitting.py", "runners/line_fitnmerge.py",
                "testing/fitnmerge.py", "testing/fitnmerge_checks.py",
                "ops/tri_propose.py", "ops/tri_score.py",
                "merging/strategies.py", "ops/vp_detect.py",
                "pointsfm/colmap_reader.py", "pointsfm/sfm_model.py",
                "pointsfm/readers.py", "pointsfm/sfm.py",
                "pointsfm/colmap_sfm.py", "undistortion/undistort.py",
                "vplib/jlinkage.py", "vplib/progressivex.py",
                "vplib/vptrack.py", "point2d/superpoint.py",
                "point2d/matching.py", "runners/colmap_triangulation.py",
                "testing/vp_checks.py", "structures/pl_bipartite.py",
                "structures/vpline_bipartite.py", "features/featuremap.py",
                "features/extractors.py", "ops/lm_line_refine.py",
                "ops/lm_assoc.py", "optimize/line_refinement.py",
                "optimize/global_pl_association.py",
                "runners/pointline_association.py", "runners/refinement.py",
                "ops/mesh_distance.py", "evaluation/mesh_evaluator.py",
                "testing/evaluation.py", "base/align.py", "base/graph.py",
                "util/geometry.py", "visualize/trackvis.py",
                "visualize/vis_bipartite.py", "visualize/vis_lines.py",
                "visualize/vis_matches.py", "visualize/vis_utils.py",
                "scripts/eval_tnt.py", "scripts/eval_hypersim.py",
                "runners/hypersim/loader.py", "parallel/sharded_ba.py",
                "parallel/hybrid_ba_driver.py", "ops/hybrid_ba.py",
                "testing/hybrid_checks.py", "runners/hypersim/refine_sfm.py",
                "runners/localization.py", "ops/log_sinkhorn.py",
                "ops/sample_descriptors.py", "ops/sold2_lines.py",
                "point2d/superglue.py", "line2d/sold2/nets.py",
                "line2d/sold2/detection.py", "line2d/sold2/sold2.py",
                "testing/learned.py", "testing/learned_checks.py"):
        assert "limap_tpu_torch/" + new in covered, new
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_forbidden_pattern_matches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import limap_tpu",
                 "from limap_tpu.base import x", "  import jax.numpy as jnp"):
        assert FORBIDDEN.search(line), line
    for line in ("from limap_tpu_torch.base import x",
                 "import limap_tpu_torch", "# import jax is not allowed",
                 "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _scene():
    return build_scene(3, 8, 2, device="cpu")


def test_resolve_device(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        limap_tpu_torch.resolve_device(None)
    assert limap_tpu_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["triangulator", "evaluator", "views",
                                   "batch", "compact", "scene"])
def test_entry_points_raise_without_gpu(no_gpu, entry):
    imagecols, segs, _, gt = _scene()
    z = np.zeros(1, np.int64)
    calls = {
        "scene": lambda: build_scene(3, 8, 2),
        "triangulator": lambda: GlobalLineTriangulator(TriangulatorConfig()),
        "evaluator": lambda: PointCloudEvaluator(gt.reshape(-1, 3)),
        "views": lambda: imagecols.batch(),
        "batch": lambda: batch_from_flat_supports(
            z, z, z, z, np.zeros((1, 2, 2)), np.zeros((1, 2, 3)),
            np.zeros(1)),
        "compact": None,
    }
    if entry == "compact":
        _, host = batch_from_flat_supports(
            z, z, z, z, np.zeros((1, 2, 2)), np.zeros((1, 2, 3)),
            np.zeros(1), return_host=True, device="cpu")
        calls["compact"] = lambda: compact_track_batch(host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    imagecols, segs, nbrs, gt = _scene()
    assert isinstance(imagecols, ImageCollection)
    tri = GlobalLineTriangulator(TriangulatorConfig(), device="cpu")
    tri.init(segs, imagecols)
    tri.triangulate_all(nbrs)
    assert tri._l2d_packed.device.type == "cpu"
    ev = PointCloudEvaluator(gt.reshape(-1, 3), device="cpu")
    assert ev.points.device.type == "cpu"


def _front_end_calls():
    from limap_tpu_torch.base.linetrack import tracks_to_batch
    from limap_tpu_torch.line2d import endpoints, get_detector, \
        get_extractor, get_matcher
    from limap_tpu_torch.line2d.tpu_lsd import detect_segments
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.config import default_triangulation_config
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 40)).astype(np.uint8)
    imgs = {0: img, 1: img[::-1].copy()}
    segs = {i: rng.uniform(4, 28, (3, 4)) for i in imgs}
    nbrs = {0: [1], 1: [0]}
    scene = pipeline.build_scene(n_views=2, n_lines=4, hw=(40, 60),
                                 n_neighbors=1)

    def runner(device):
        cfg = default_triangulation_config()
        cfg["output_dir"] = "tmp/test_torch_policy_runner"
        return line_triangulation(cfg, scene[0], scene[2], device=device)

    return {
        "detect_segments": lambda d: detect_segments(img, device=d),
        "tpu_lsd": lambda d: get_detector({"method": "tpu_lsd"}, device=d),
        "patch_endpoints": lambda d: get_extractor(
            {"method": "patch_endpoints"}, device=d),
        "nn_endpoints": lambda d: get_matcher(
            {"method": "nn_endpoints"}, None, device=d),
        "descinfos": lambda d: endpoints.compute_descinfos_batch(
            imgs, segs, device=d),
        "upload": lambda d: endpoints.upload_image_u8(img, device=d),
        "match_neighbors": lambda d: endpoints.match_all_neighbors_batched(
            imgs, segs, nbrs, device=d),
        "match_pairs": lambda d: endpoints.batched_match_pairs(
            {}, [], device=d),
        "tracks_to_batch": lambda d: tracks_to_batch([], {}, device=d),
        "pipeline": lambda d: pipeline.run(scene=scene, device=d),
        "runner": runner,
    }


FRONT_END = ["detect_segments", "tpu_lsd", "patch_endpoints", "nn_endpoints",
             "descinfos", "upload", "match_neighbors", "match_pairs",
             "tracks_to_batch", "pipeline", "runner"]


@pytest.mark.parametrize("entry", FRONT_END)
def test_front_end_entry_points_raise_without_gpu(no_gpu, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _front_end_calls()[entry](None)


@pytest.mark.parametrize("entry", ["detect_segments", "descinfos", "upload",
                                   "match_neighbors", "tpu_lsd"])
def test_front_end_entry_points_run_on_cpu_when_asked(no_gpu, entry):
    out = _front_end_calls()[entry]("cpu")
    if entry == "upload":
        assert out.device.type == "cpu" and out.dtype == torch.uint8
    if entry == "match_neighbors":
        assert set(out) == {0, 1}


def _localization_calls():
    import importlib
    from limap_tpu_torch.base.camera import Camera, CameraPose
    from limap_tpu_torch.estimators import pl_estimate_absolute_pose
    from limap_tpu_torch.optimize.hybrid_localization import solve_jointloc
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.config import default_localization_config
    runner = importlib.import_module(
        "limap_tpu_torch.runners.hybrid_localization")
    rng = np.random.default_rng(0)
    cam = Camera(K=np.array([[100.0, 0, 30], [0, 100.0, 20], [0, 0, 1]]),
                 hw=(40, 60))
    pose = CameraPose()
    p3 = rng.normal(size=(6, 3)) + [0.0, 0.0, 5.0]
    p2 = p3[:, :2] / p3[:, 2:] * 100.0 + [30.0, 20.0]
    l3 = rng.normal(size=(4, 2, 3)) + [0.0, 0.0, 5.0]
    l2 = l3[..., :2] / l3[..., 2:] * 100.0 + [30.0, 20.0]
    segs = rng.uniform(0, 40, (5, 4))
    scene = pipeline.build_scene(n_views=2, n_lines=4, hw=(40, 60),
                                 n_neighbors=1)

    def localize(device):
        cfg = default_localization_config()
        cfg["output_dir"] = "tmp/test_torch_policy_localization"
        db, q = scene[0].subset_by_image_ids([0]), \
            scene[0].subset_by_image_ids([1])
        return runner.hybrid_localization(cfg, db, q, {1: (p3, p2)}, [],
                                          {1: [0]}, device=device)

    return {
        "estimate": lambda d: pl_estimate_absolute_pose(
            {"ransac": {"n_hypotheses": 16, "lo_topk": 1}}, l3,
            np.arange(4), l2, p3, p2, cam, device=d),
        "jointloc": lambda d: solve_jointloc(
            l3[:, 0], l3[:, 1], l2[:, 0], l2[:, 1], p3, p2, cam.kvec(),
            pose.qvec, pose.tvec, num_iterations=2, device=d),
        "epipolar": lambda d: runner.match_line_2to2_epipolar_iou(
            segs, segs, cam, pose, cam, CameraPose(tvec=(1.0, 0, 0)),
            device=d),
        "runner": localize,
    }


LOCALIZATION = ["estimate", "jointloc", "epipolar", "runner"]


@pytest.mark.parametrize("entry", LOCALIZATION)
def test_localization_entry_points_raise_without_gpu(no_gpu, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _localization_calls()[entry](None)


@pytest.mark.parametrize("entry", ["estimate", "jointloc", "epipolar"])
def test_localization_entry_points_run_on_cpu_when_asked(no_gpu, entry):
    out = _localization_calls()[entry]("cpu")
    assert out is not None


# Public names of the JAX package's subpackages that the port does not
# have yet, each with the ROADMAP queue-1 item that brings it.  Every
# other name of a JAX subpackage's __all__ must be exported by the port's
# subpackage of the same name.
QUEUED_NAMES = {
    "point2d": {},
    "parallel": {},
}
SUBPACKAGES = ("base", "merging", "optimize", "evaluation", "ops", "util",
               "runners", "fitting", "estimators", "line2d", "pointsfm",
               "undistortion", "vplib", "point2d", "structures", "features",
               "visualize", "parallel")


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackages_export_the_jax_public_names(name):
    import importlib
    ref = importlib.import_module(f"limap_tpu.{name}")
    port = importlib.import_module(f"limap_tpu_torch.{name}")
    queued = QUEUED_NAMES.get(name, {})
    missing = [n for n in ref.__all__
               if n not in queued and not (n in port.__all__
                                           and hasattr(port, n))]
    assert not missing, missing
    # a queued name really is missing, so the list stays true
    assert not [n for n in queued if hasattr(port, n)]


def _colmap_vp_calls(tmp):
    from limap_tpu_torch.pointsfm import (ReadInfos, ReadPointTracks,
                                          run_sfm_with_known_poses)
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.runners.functions import compute_sfminfos
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.vplib import (JLinkage, ProgressiveX,
                                       get_vp_detector)
    model, image_dir, _ = pipeline.write_colmap_scene(
        str(tmp), n_views=3, n_lines=6, hw=(40, 60), n_points=40)
    cols = ReadInfos(model, image_dir)
    feats = {i: {"keypoints": np.zeros((0, 2), np.float32),
                 "descriptors": np.zeros((0, 64))} for i in range(3)}

    def runner(device):
        cfg = pipeline.colmap_vp_config(str(tmp / "out"), n_neighbors=2)
        return line_triangulation(cfg, cols,
                                  points3d=ReadPointTracks(model),
                                  device=device)

    def sfminfos(device):
        cfg = {"dir_save": str(tmp), "n_neighbors": 2}
        return compute_sfminfos(cfg, cols, images={}, device=device)

    return {
        "jlinkage": lambda d: JLinkage(device=d),
        "progressivex": lambda d: ProgressiveX(device=d),
        "vp_detector": lambda d: get_vp_detector({"method": "jlinkage"},
                                                 device=d),
        "sfm": lambda d: run_sfm_with_known_poses(cols, features=feats,
                                                  device=d),
        "sfminfos": sfminfos,
        "colmap_runner": runner,
    }


COLMAP_VP = ["jlinkage", "progressivex", "vp_detector", "sfm", "sfminfos",
             "colmap_runner"]


@pytest.mark.parametrize("entry", COLMAP_VP)
def test_colmap_vp_entry_points_raise_without_gpu(no_gpu, entry, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _colmap_vp_calls(tmp_path)[entry](None)


@pytest.mark.parametrize("entry", ["jlinkage", "progressivex", "vp_detector",
                                   "sfm"])
def test_colmap_vp_entry_points_run_on_cpu_when_asked(no_gpu, entry,
                                                      tmp_path):
    out = _colmap_vp_calls(tmp_path)[entry]("cpu")
    if entry == "sfm":
        assert out == {}
    else:
        assert out.device.type == "cpu"


def _fitnmerge_calls():
    from limap_tpu_torch.base import ArrayDepthReader, ArrayP3DReader
    from limap_tpu_torch.runners import (fit_3d_segs,
                                         fit_3d_segs_with_points3d,
                                         line_fitnmerge,
                                         line_fitting_with_points3d)
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.config import default_fitnmerge_config
    scene = pipeline.build_scene(n_views=2, n_lines=4, hw=(40, 60),
                                 n_neighbors=1)
    cols = scene[0]
    segs = {i: np.array([[5.0, 5, 30, 20], [10, 30, 50, 10]], np.float32)
            for i in cols.get_img_ids()}
    depths = {i: ArrayDepthReader(np.full((40, 60), 10.0, np.float32))
              for i in segs}
    p3ds = {i: ArrayP3DReader(np.ones((40, 60, 3), np.float32))
            for i in segs}

    def cfg():
        c = default_fitnmerge_config()
        c["output_dir"] = "tmp/test_torch_policy_fitnmerge"
        return c

    return {
        "fit_3d_segs": lambda d: fit_3d_segs(segs, cols, depths, {},
                                             device=d),
        "fit_points3d": lambda d: fit_3d_segs_with_points3d(
            segs, cols, p3ds, {}, device=d),
        "line_fitnmerge": lambda d: line_fitnmerge(cfg(), cols, depths,
                                                   scene[2], device=d),
        "line_fitting_with_points3d": lambda d: line_fitting_with_points3d(
            cfg(), cols, p3ds, scene[2], device=d),
    }


FITNMERGE = ["fit_3d_segs", "fit_points3d", "line_fitnmerge",
             "line_fitting_with_points3d"]


@pytest.mark.parametrize("entry", FITNMERGE)
def test_fitnmerge_entry_points_raise_without_gpu(no_gpu, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _fitnmerge_calls()[entry](None)


@pytest.mark.parametrize("entry", ["fit_3d_segs", "fit_points3d"])
def test_fitnmerge_entry_points_run_on_cpu_when_asked(no_gpu, entry):
    out = _fitnmerge_calls()[entry]("cpu")
    assert set(out) == {0, 1} and out[0].shape == (2, 2, 3)


def _association_calls(tmp):
    from limap_tpu_torch.optimize.global_pl_association import (
        GlobalAssociator, GlobalAssociatorConfig)
    from limap_tpu_torch.optimize.line_refinement import line_refinement
    from limap_tpu_torch.runners import pointline_association
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.config import default_pl_association_config
    scene = pipeline.build_scene(n_views=3, n_lines=4, hw=(40, 60),
                                 n_neighbors=1)
    cols = scene[0]
    ids = cols.get_img_ids()
    segs = {i: np.array([[5.0, 5, 30, 20], [10, 30, 50, 10]], np.float32)
            for i in ids}
    from limap_tpu_torch.base.linetrack import LineTrack
    tracks = [LineTrack(line=np.array([[0.0, 0, 5], [1.0, 0, 5]]),
                        image_id_list=list(ids), line_id_list=[0] * 3,
                        line2d_list=[segs[i][0].reshape(2, 2) for i in ids],
                        line3d_list=[np.zeros((2, 3))] * 3,
                        score_list=[1.0] * 3)]
    points3d = {7: {"xyz": np.array([0.5, 0.0, 5.0]), "image_ids": ids}}
    points2d = {i: np.array([[17.5, 12.5, 7]]) for i in ids}

    def solve(device):
        from limap_tpu_torch.base.linetrack import tracks_to_batch
        a = GlobalAssociator(GlobalAssociatorConfig(n_bcd_rounds=1,
                                                    lm_iterations=2),
                             device=device)
        a.init_imagecols(cols)
        a.init_line_tracks(tracks_to_batch(tracks, cols.img_id_to_index(),
                                           device=device))
        a.init_point_tracks([])
        a.init_vp_tracks([])
        return a.solve()[0]

    def runner(device):
        cfg = default_pl_association_config()
        cfg["output_dir"] = str(tmp)
        return pointline_association(cfg, cols, tracks, segs, points3d,
                                     points2d, use_vp=False,
                                     device=device)[1]

    return {
        "line_refinement": lambda d: line_refinement(
            {"min_num_images": 2}, tracks, cols, num_iterations=2,
            device=d)[0].line,
        "associator": solve,
        "pointline_association": runner,
    }


ASSOCIATION = ["line_refinement", "associator", "pointline_association"]


@pytest.mark.parametrize("entry", ASSOCIATION)
def test_association_entry_points_raise_without_gpu(no_gpu, entry,
                                                    tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _association_calls(tmp_path)[entry](None)


@pytest.mark.parametrize("entry", ASSOCIATION)
def test_association_entry_points_run_on_cpu_when_asked(no_gpu, entry,
                                                        tmp_path):
    out = _association_calls(tmp_path)[entry]("cpu")
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("mesh", [2, 8, [0, 1]])
def test_hybrid_ba_refuses_a_mesh_of_several_devices(mesh):
    """Several devices run as ranks of a process group, each its own
    process: a count or a device list is no such mesh."""
    from limap_tpu_torch.parallel import (make_hybrid_ba_cost,
                                          make_hybrid_ba_step)
    with pytest.raises(ValueError, match="process group"):
        make_hybrid_ba_step(mesh, 4, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        make_hybrid_ba_cost(mesh, device="cpu")


def _learned_calls():
    from limap_tpu_torch.line2d import get_detector, get_extractor, \
        get_matcher
    from limap_tpu_torch.line2d.sold2.detection import LineSegmentDetector
    from limap_tpu_torch.line2d.sold2.sold2 import (SOLD2Engine,
                                                    WunschLineMatcher)
    from limap_tpu_torch.point2d import (SuperPoint, log_sinkhorn,
                                         sinkhorn_match)
    from limap_tpu_torch.point2d.superglue import SuperGlue
    desc = np.random.default_rng(0).normal(size=(5, 8))

    def extractor(d):
        return get_extractor({"method": "superpoint_endpoints"}, device=d)

    return {
        "log_sinkhorn": lambda d: log_sinkhorn(np.zeros((3, 4)), 0.5,
                                               device=d),
        "sinkhorn_match": lambda d: sinkhorn_match(desc, desc, device=d),
        "superpoint": lambda d: SuperPoint(device=d),
        "superglue": lambda d: SuperGlue(device=d),
        "sold2_engine": lambda d: SOLD2Engine(device=d),
        "sold2_detector": lambda d: LineSegmentDetector(device=d),
        "wunsch": lambda d: WunschLineMatcher(device=d),
        "get_detector_sold2": lambda d: get_detector({"method": "sold2"},
                                                     device=d),
        "get_extractor_superpoint_endpoints": extractor,
        "get_matcher_superglue_endpoints": lambda d: get_matcher(
            {"method": "superglue_endpoints", "topk": 0}, extractor("cpu"),
            device=d),
        "get_matcher_sinkhorn_endpoints": lambda d: get_matcher(
            {"method": "sinkhorn_endpoints"}, None, device=d),
        "get_matcher_sold2": lambda d: get_matcher(
            {"method": "sold2"}, get_extractor({"method": "sold2"},
                                               device="cpu"), device=d),
    }


LEARNED = ["log_sinkhorn", "sinkhorn_match", "superpoint", "superglue",
           "sold2_engine", "sold2_detector", "wunsch", "get_detector_sold2",
           "get_extractor_superpoint_endpoints",
           "get_matcher_superglue_endpoints",
           "get_matcher_sinkhorn_endpoints", "get_matcher_sold2"]


@pytest.mark.parametrize("entry", LEARNED)
def test_learned_entry_points_raise_without_gpu(no_gpu, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _learned_calls()[entry](None)


@pytest.mark.parametrize("entry", LEARNED)
def test_learned_entry_points_run_on_cpu_when_asked(no_gpu, entry,
                                                    recwarn):
    out = _learned_calls()[entry]("cpu")
    if entry == "log_sinkhorn":
        assert out.device.type == "cpu" and out.shape == (4, 5)
    elif entry == "sinkhorn_match":
        assert out.shape[1] == 2
    else:
        assert out is not None


def test_every_reference_method_is_ported_or_waits_for_item_14():
    """The port's registries hold every method of the JAX registries and
    NOT_PORTED is empty; each method builds on the CPU, and dense_roma
    raises as the JAX package raises without romatch."""
    from limap_tpu.line2d import base as ref_base
    from limap_tpu_torch.line2d import base as port_base
    for f in (ref_base.get_detector, ref_base.get_extractor):
        with pytest.raises(NotImplementedError):
            f({"method": "no_such_method"})   # imports every module
    with pytest.raises(NotImplementedError):
        port_base.get_detector({"method": "no_such_method"}, device="cpu")
    for kind, ref_reg, reg in (
            ("detector", ref_base.DETECTOR_REGISTRY,
             port_base.DETECTOR_REGISTRY),
            ("extractor", ref_base.EXTRACTOR_REGISTRY,
             port_base.EXTRACTOR_REGISTRY),
            ("matcher", ref_base.MATCHER_REGISTRY,
             port_base.MATCHER_REGISTRY)):
        assert not port_base.NOT_PORTED[kind], kind
        assert set(ref_reg) == set(reg), kind
    for method in ("lbd", "l2d2", "dense_naive"):
        ext = port_base.get_extractor({"method": method}, device="cpu")
        assert ext.get_module_name() == method
    dense = port_base.get_extractor({"method": "dense_naive"}, device="cpu")
    with pytest.raises(ImportError, match="romatch") as ours:
        port_base.get_matcher({"method": "dense_roma"}, dense, device="cpu")
    with pytest.raises(ImportError, match="romatch") as theirs:
        ref_base.get_matcher({"method": "dense_roma"},
                             ref_base.get_extractor({"method": "dense_naive"}))
    assert str(ours.value) == str(theirs.value)
