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
                "util/profiler.py"):
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
