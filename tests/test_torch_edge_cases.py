"""Tie-breaks and scatter semantics the port must reproduce exactly:
the stable pack of valid edges, the bool scatter-max ``has_edge``, the
first index on argmax ties, and component labels equal to the minimum
node id."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.base.camera import Camera as JCamera
from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.base.image_collection import CameraImage as JImage
from limap_tpu.base.image_collection import ImageCollection as JCollection
from limap_tpu.base.lines import Segments as JSeg
from limap_tpu.merging.aggregator import aggregate_tracks as jaggregate
from limap_tpu.ops.connected_components import \
    connected_components as jcc
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.merging.aggregator import aggregate_tracks
from limap_tpu_torch.ops import hostops
from limap_tpu_torch.ops.connected_components import (compact_labels,
                                                      connected_components)
from limap_tpu_torch.testing.synthetic import build_scene
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)


def jax_collection(imagecols):
    cam = imagecols.cameras[0]
    return JCollection(
        {0: JCamera(K=cam.K(), hw=(cam.height, cam.width), cam_id=0)},
        {i: JImage(0, JPose(qvec=im.pose.qvec, tvec=im.pose.tvec))
         for i, im in imagecols.images.items()})


@pytest.fixture(scope="module")
def corrupted():
    """6 views x 24 lines x 4 neighbours; matches to every other
    neighbour point at a shuffled line, so each line's valid edges sit
    at interleaved slots of its bucket."""
    imagecols, segs, nbrs, _ = build_scene(6, 24, 4, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    segs = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            for k, v in segs.items()}
    bad = {}
    for i, m in nbrs.items():
        bad[i] = {}
        for s, (j, mm) in enumerate(sorted(m.items())):
            mm = mm.copy()
            if s % 2:
                mm[:, 1] = rng.permutation(mm[:, 1])
            bad[i][j] = mm
    cfg = dict(max_tris_per_node=8, fullscore_th=0.5)
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    pt.init(segs, imagecols)
    pt.triangulate_all(bad)
    jt = JTri(JCfg(**cfg))
    jt.init(segs, jax_collection(imagecols))
    jt.triangulate_all(bad)
    return pt, jt


def test_valid_edges_pack_stably(corrupted):
    pt, jt = corrupted
    _, _, _, dst, cnt = pt.host_state()
    # the reference's device tables, read without syncing its host state
    # (a synced triangulator clusters on its host path instead)
    _, outs, Tc = jt._dev_results
    ref = np.concatenate([np.asarray(o[2]) for o in outs])[:dst.shape[0]]
    np.testing.assert_array_equal(dst, ref[..., :Tc])
    np.testing.assert_array_equal(cnt, ref[..., Tc])
    # some line has a valid edge after an invalid slot: the pack is a
    # real reorder, and it keeps slot order
    assert (cnt < Tc).any() and (cnt > 0).any()
    L = pt.L
    row = dst.reshape(-1, Tc)
    for r, c in zip(row, cnt.reshape(-1)):
        nbr_rows = r[:c] // L
        assert (np.diff(nbr_rows) > 0).all()


def test_has_edge_matches_reference(corrupted):
    pt, jt = corrupted
    labels, und, *_ = pt._cluster_labels()
    jlabels, jund, *_ = jt._cluster_labels()
    np.testing.assert_array_equal(und, jund)
    np.testing.assert_array_equal(labels, jlabels)


def test_has_edge_scatter_max_on_uint8():
    """A node hit by a kept and a dropped edge keeps has_edge = 1, in
    whichever order the scatter visits them."""
    has = torch.zeros(4, dtype=torch.uint8)
    idx = torch.tensor([1, 1, 2, 1, 3])
    keep = torch.tensor([0, 1, 0, 0, 0], dtype=torch.uint8)
    has.scatter_reduce_(0, idx, keep, reduce="amax")
    assert has.tolist() == [0, 1, 0, 0]


def test_argmax_first_index_on_ties():
    """Tracks with < 4 supports take the best-scored support; on tied
    scores the first one, as jnp.argmax."""
    T, S = 5, 4
    rng = np.random.default_rng(0)
    st = rng.normal(size=(T, S, 3)).astype(np.float32)
    en = rng.normal(size=(T, S, 3)).astype(np.float32)
    score = np.ones((T, S), np.float32)
    score[2, 1:] = 2.0
    mask = np.zeros((T, S), bool)
    mask[:, :3] = True
    mask[4, 0] = False
    out = aggregate_tracks(Segments(torch.as_tensor(st), torch.as_tensor(en)),
                           torch.as_tensor(score), torch.as_tensor(mask))
    ref = jaggregate(JSeg(jnp.asarray(st), jnp.asarray(en)),
                     jnp.asarray(score), jnp.asarray(mask), 2)
    first = [0, 0, 1, 0, 1]
    np.testing.assert_array_equal(out.start.numpy(),
                                  st[np.arange(T), first])
    np.testing.assert_array_equal(out.start.numpy(), np.asarray(ref.start))
    np.testing.assert_array_equal(out.end.numpy(), np.asarray(ref.end))


@pytest.mark.parametrize("n,e", [(1, 0), (10, 4), (64, 40), (200, 150),
                                 (500, 900)])
def test_component_labels_are_min_node_id(n, e):
    rng = np.random.default_rng(n)
    edges = rng.integers(0, n, size=(e, 2))
    mask = rng.uniform(size=e) < 0.8
    lab = connected_components(n, torch.as_tensor(edges),
                               torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(lab, hostops.union_find(n, edges[mask]))
    if e:
        np.testing.assert_array_equal(
            lab, np.asarray(jcc(n, jnp.asarray(edges, jnp.int32),
                                jnp.asarray(mask))))
    dense, n_comp = compact_labels(torch.as_tensor(lab))
    assert n_comp == len(np.unique(lab))
    assert dense.max().item() == n_comp - 1


def test_host_helpers_match_reference():
    """The port's numpy copies of the reference's host ops."""
    from limap_tpu.ops import hostops as jhost
    rng = np.random.default_rng(7)
    key = rng.integers(-1, 12, size=200)
    vals = rng.integers(0, 1 << 20, size=200).astype(np.int32)
    for T in (1, 4, 32):
        w, ovf = hostops.bucket_scene(key, vals, 10, T)
        jw, jovf = jhost.bucket_scene(key, vals, 10, T)
        np.testing.assert_array_equal(w, jw)
        assert ovf == jovf
    labels = rng.integers(0, 9, size=50)
    valid = rng.uniform(size=50) < 0.7
    ids, offs = hostops.group_by_labels(labels, valid)
    jids, joffs = jhost.group_by_labels(labels, valid)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(offs, joffs)
    for S in (2, 8):
        idx, m = hostops.pack_supports(ids, offs, S)
        jidx, jm = jhost.pack_supports(jids, joffs, S)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(m, jm)
    edges = rng.integers(0, 30, size=(25, 2))
    np.testing.assert_array_equal(hostops.union_find(30, edges),
                                  jhost.union_find(30, edges))
