"""The multi-process layer (``limap_tpu_torch/parallel/distributed.py``,
``mesh.py``) and ``GlobalLineTriangulator.triangulate_all_mesh``: the
single-process semantics of ``tests/test_distributed.py``, the image
split against the JAX package's, the refusals (a failed initialization
raises where JAX's falls back to one process; the default NCCL backend
refuses more ranks than cards), and two gloo ranks on the CPU
(``limap_tpu_torch/testing/multirank.py``) on ``tests/test_distributed.py``'s
8-view scene with 0.1 px of endpoint noise: the host dicts merged in rank
order, ``triangulate_all_mesh`` against the port's ``triangulate_all``
(bit-equal: a row's results depend on that row alone) and against JAX's
over ``make_mesh(2)``, and ``run_distributed_mapping``.  Without the
noise the scene's scores sit on ``fullscore_th`` = 1.0, where the two
packages' float32 rounding (3.5e-4 apart) decides the valid edges: JAX's
own mesh and one-device runs then agree with each other bit for bit, as
the port's do, but the two packages part on the ties (ROADMAP.md, "End-to-end
parity")."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from limap_tpu.base import Segments as JaxSegments
from limap_tpu.base import line_geometry as jlg
from limap_tpu.base.camera import Camera, CameraPose
from limap_tpu.base.image_collection import (CameraImage,
                                             ImageCollection as JaxCols)
from limap_tpu.parallel import distributed as jax_dist
from limap_tpu.parallel import make_mesh as jax_mesh
from limap_tpu.triangulation.triangulator import (
    GlobalLineTriangulator as JaxTri, TriangulatorConfig as JaxCfg)
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.parallel import (TRACK_AXIS, make_mesh, replicated,
                                      track_sharding)
from limap_tpu_torch.parallel import distributed as D
from limap_tpu_torch.testing import multirank
from limap_tpu_torch.triangulation.triangulator import (
    GlobalLineTriangulator, TriangulatorConfig)
from torch_threads import two_torch_threads  # noqa: F401

CFG = {"triangulation": {"max_tris_per_node": 8}}
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture()
def no_launcher(monkeypatch):
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)


def jax_scene(noise=0.1):
    """tests/test_distributed.py::test_run_distributed_mapping's scene:
    8 views, 12 lines, each view matched to the views within 2; its
    segments with ``noise`` px of seeded endpoint noise."""
    rng = np.random.default_rng(0)
    n_views, n_lines = 8, 12
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cams = {0: Camera(K=K, hw=(480, 640), cam_id=0)}
    images = {k: CameraImage(0, CameraPose(
        R=Rotation.from_rotvec(rng.normal(size=3) * 0.03).as_matrix(),
        tvec=np.array([0.4 * k, 0.0, 0.02 * k])))
        for k in range(n_views)}
    imagecols = JaxCols(cams, images)
    gt_s = rng.normal(size=(n_lines, 3)).astype(np.float32)
    gt_s[:, 2] += 8
    gt_e = gt_s + rng.normal(size=(n_lines, 3)).astype(np.float32)
    vb = imagecols.batch()
    allv = vb.select(jnp.repeat(jnp.arange(n_views), n_lines))
    l2d = jlg.project_segments(
        JaxSegments(jnp.tile(jnp.asarray(gt_s), (n_views, 1)),
                    jnp.tile(jnp.asarray(gt_e), (n_views, 1))), allv)
    arr = np.concatenate([np.asarray(l2d.start), np.asarray(l2d.end)],
                         1).reshape(n_views, n_lines, 4)
    noisy = np.random.default_rng(1)
    segs = {k: (arr[k] + noisy.normal(0, noise, arr[k].shape)).astype(
        np.float32) for k in range(n_views)}
    matches = np.stack([np.arange(n_lines)] * 2, 1)
    nbrs = {i: {j: matches for j in range(max(0, i - 2),
                                          min(n_views, i + 3)) if j != i}
            for i in range(n_views)}
    return imagecols, segs, nbrs


def supports(tracks):
    return [sorted(zip(map(int, t.image_id_list), map(int, t.line_id_list)))
            for t in tracks]


@pytest.fixture(scope="module")
def ranked():
    """Two gloo ranks run ``mapping`` and ``two_dim_mesh`` while this
    process runs the port's ``triangulate_all`` and JAX's
    ``triangulate_all_mesh`` over ``make_mesh(2)``."""
    jcols, segs, nbrs = jax_scene()
    cols = ImageCollection.from_dict(jcols.as_dict())
    args = (cols, segs, nbrs, CFG)
    ranks = multirank.start(multirank.jobs, 2, ([
        (multirank.mapping, args), (multirank.two_dim_mesh, args)],))
    one = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=8),
                                 device="cpu")
    one.init(segs, cols)
    one.triangulate_all(nbrs)
    jt = JaxTri(JaxCfg(max_tris_per_node=8))
    jt.init(segs, jcols)
    jt.triangulate_all_mesh(nbrs, jax_mesh(2))
    jax_tracks = jt.compute_line_tracks()
    jt._sync_host()
    return {"ranks": ranks.join(timeout_s=240), "one": one,
            "one_tables": multirank.node_tables(one),
            "one_tracks": one.compute_line_tracks(), "jax": jt,
            "jax_tracks": jax_tracks, "n_views": len(segs)}


def test_single_process_info_and_sharding(no_launcher):
    assert D.maybe_initialize() is False      # single process here
    info = D.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == 1
    ids = list(range(10))
    assert D.shard_image_ids(ids) == ids
    d = {1: "a", 2: "b"}
    assert D.all_gather_host_dicts(d) is d
    assert D.global_mesh() is None
    assert make_mesh() is None and make_mesh(1) is None


def test_meshes_and_placements_without_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2)
    assert TRACK_AXIS == "tracks"
    assert [type(p).__name__ for p in track_sharding(None)] == ["Shard"]
    assert track_sharding(None)[0].dim == 0
    assert [type(p).__name__ for p in replicated(None)] == ["Replicate"]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_image_ids_matches_jax(monkeypatch, world):
    for n in (0, 1, 7, 10, 13):
        ids = [100 + 3 * i for i in range(n)]
        got, ref = [], []
        for rank in range(world):
            monkeypatch.setattr(D, "_world", lambda: (rank, world))
            monkeypatch.setattr(jax_dist.jax, "process_index", lambda: rank)
            monkeypatch.setattr(jax_dist.jax, "process_count", lambda: world)
            got.append(D.shard_image_ids(ids))
            ref.append(jax_dist.shard_image_ids(ids))
        assert got == ref
        assert sum(got, []) == ids


@pytest.mark.parametrize("how", ["no other rank", "rank outside the world"])
def test_failed_initialization_raises(no_launcher, tmp_path, how):
    """JAX's maybe_initialize turns any failure into single-process mode
    (limap_tpu/parallel/distributed.py:66); the port raises."""
    world, rank = (2, 0) if how == "no other rank" else (2, 3)
    with pytest.raises(RuntimeError):
        D.maybe_initialize(f"file://{tmp_path}/store", world, rank,
                           timeout_s=2.0)
    assert not dist.is_initialized()


def test_default_nccl_backend_with_more_ranks_than_cards_raises(
        no_launcher, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.default_backend(0, 1) == "nccl"
    with pytest.raises(ValueError, match="backend='gloo'"):
        D.maybe_initialize(f"file://{tmp_path}/store", 2, 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="NCCL refuses"):
        D.default_backend(0, 3)
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert D.default_backend(5, 8) == "gloo"


def test_all_gather_host_dicts_merges_in_rank_order(ranked):
    for rank, (res, _) in enumerate(ranked["ranks"]):
        assert res["order"] == {"shared": 1, "rank 0": 0, "rank 1": 1}
        assert list(res["order"]) == ["shared", "rank 0", "rank 1"]
        assert res["segs_keys"] == list(range(ranked["n_views"]))
        assert res["mine"] == [[0, 1, 2, 3], [4, 5, 6, 7]][rank]


def test_triangulate_all_mesh_matches_one_process(ranked):
    for res, _ in ranked["ranks"]:
        for a, b in zip(res["tables"], ranked["one_tables"]):
            np.testing.assert_array_equal(a, b)
        assert supports(res["tracks"]) == supports(ranked["one_tracks"])
        for a, b in zip(res["tracks"], ranked["one_tracks"]):
            np.testing.assert_array_equal(a.line, b.line)
        assert res["launches"] == {"tri_propose": 0, "tri_score": 0}


def test_triangulate_all_mesh_matches_jax_mesh(ranked):
    jt = ranked["jax"]
    res, _ = ranked["ranks"][0]
    _, unc, score, edges, cnt = res["tables"]
    np.testing.assert_allclose(score, jt.best_score, atol=1e-4)
    np.testing.assert_array_equal(cnt, jt.valid_edge_cnt)
    assert supports(res["tracks"]) == supports(ranked["jax_tracks"])
    assert len(res["tracks"]) >= 12 * 0.8


def test_run_distributed_mapping_matches_one_process(ranked):
    for res, _ in ranked["ranks"]:
        assert supports(res["mapped"]) == supports(ranked["one_tracks"])
        for a, b in zip(res["mapped"], ranked["one_tracks"]):
            np.testing.assert_array_equal(a.line, b.line)


def test_a_mesh_of_two_dimensions_needs_an_axis(ranked):
    for _, res in ranked["ranks"]:
        assert "1-D mesh" in res["refused"]
        for a, b in zip(res["tables"], ranked["one_tables"]):
            np.testing.assert_array_equal(a, b)
