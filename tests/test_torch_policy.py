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
