"""Point-line bipartites: the port (``limap_tpu_torch.structures``)
against the JAX package on the same inputs: keypoint attachment,
neighbour lists and degrees, junctions with their merge, the bipartites
from SfM points and the VP-line bipartites."""

import numpy as np
import pytest

import limap_tpu.structures as J
from limap_tpu.structures.vpline_bipartite import (
    VPLine_Bipartite3d as JVP3d, get_all_bipartites_vpline2d as j_vp2d)
from limap_tpu.vplib.jlinkage import VPResult as JVPResult
from limap_tpu.vplib.vptrack import VPTrack as JVPTrack
import limap_tpu_torch.structures as T
from limap_tpu_torch.structures.vpline_bipartite import (
    VPLine_Bipartite3d as TVP3d, get_all_bipartites_vpline2d as t_vp2d)
from limap_tpu_torch.vplib.jlinkage import VPResult as TVPResult
from limap_tpu_torch.vplib.vptrack import VPTrack as TVPTrack
from torch_threads import two_torch_threads  # noqa: F401


def both(cfg=None, **kw):
    return (J.PL_Bipartite2d(J.PL_Bipartite2dConfig(**(cfg or {}))),
            T.PL_Bipartite2d(T.PL_Bipartite2dConfig(**(cfg or {})),
                             device="cpu"))


def adjacency(b):
    return ({p: b.neighbor_lines(p) for p in b.get_point_ids()},
            {l: b.neighbor_points(l) for l in b.get_line_ids()},
            [b.pdegree(p) for p in b.get_point_ids()],
            [b.ldegree(l) for l in b.get_line_ids()], b.count_edges())


def test_keypoint_attachment_cases():
    """The JAX package's cases: near line 0, in between, near line 1."""
    for b in both({"threshold_keypoints": 2.0}):
        b.init_lines(np.array([[0.0, 0, 100, 0], [0.0, 10, 100, 10]]))
        b.add_keypoints_with_point3D_ids(
            np.array([[50.0, 1.0], [50.0, 5.0], [50.0, 9.5]]), [7, 8, 9])
        assert b.neighbor_lines(0) == [0] and b.neighbor_lines(1) == []
        assert b.neighbor_lines(2) == [1] and b.point(0).point3D_id == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bipartites_match_jax(seed):
    rng = np.random.default_rng(seed)
    segs = rng.uniform(0, 200, (40, 4))
    kps = rng.uniform(0, 200, (300, 2))
    # keypoints on segments and near their ends (the clamped foot)
    t = rng.uniform(-0.05, 1.05, 60)
    k = rng.integers(0, 40, 60)
    kps[:60] = segs[k, :2] + t[:, None] * (segs[k, 2:] - segs[k, :2]) \
        + rng.normal(0, 1.0, (60, 2))
    ids = rng.integers(-1, 50, 300)
    out = []
    for b in both({"threshold_keypoints": 2.5}):
        b.init_lines(segs)
        b.add_keypoints_with_point3D_ids(kps, ids)
        out.append(adjacency(b))
    assert out[0] == out[1]
    assert out[1][4] > 40


@pytest.mark.parametrize("seed", [0, 1])
def test_junctions_match_jax(seed):
    """Intersections in JAX's order (pairs i < j row-major) and the greedy
    merge, on a grid of segments with near-coincident crossings."""
    rng = np.random.default_rng(seed)
    h = [[0.0, y, 100.0, y + rng.normal(0, 0.2)] for y in (10, 40, 41, 70)]
    v = [[x, 0.0, x + rng.normal(0, 0.2), 100.0] for x in (20, 21, 60, 90)]
    extra = rng.uniform(0, 100, (10, 4))
    segs = np.concatenate([h, v, extra])
    res = []
    for b in both({"threshold_intersection": 2.0,
                   "threshold_merge_junctions": 2.0}):
        b.init_lines(segs)
        res.append(b.compute_intersections())
    assert len(res[0]) == len(res[1]) > 10
    for a, b in zip(*res):
        np.testing.assert_allclose(np.asarray(b.p), np.asarray(a.p),
                                   atol=1e-4)
        assert list(a.line_ids) == list(b.line_ids)
    # merged junctions carry more than two lines
    assert max(len(j.line_ids) for j in res[1]) > 2


def test_intersection_case_and_parallel_lines():
    for b in both():
        b.init_lines(np.array([[0.0, 0, 100, 100], [0.0, 100, 100, 0],
                               [200.0, 200, 300, 200],
                               [200.0, 210, 300, 210]]))
        juncs = b.compute_intersections()
        assert len(juncs) == 1 and sorted(juncs[0].line_ids) == [0, 1]
        np.testing.assert_allclose(juncs[0].p, [50, 50], atol=1e-3)


def test_bipartites_from_points_match_jax():
    rng = np.random.default_rng(5)
    segs = {i: rng.uniform(0, 100, (15, 5)) for i in (4, 2, 9)}
    p2d = {i: np.concatenate([rng.uniform(0, 100, (30, 2)),
                              rng.integers(-1, 20, (30, 1))], 1)
           for i in (4, 2)}
    p3d = {k: {"xyz": rng.normal(size=3), "image_ids": [4, 2]}
           for k in range(20)}
    bj, sj = J.compute_2d_bipartites_from_points(p3d, p2d, segs)
    bt, st = T.compute_2d_bipartites_from_points(p3d, p2d, segs,
                                                 device="cpu")
    assert list(bj) == list(bt) == [4, 2, 9]
    for i in bj:
        assert adjacency(bj[i]) == adjacency(bt[i])
        assert [bj[i].point(p).point3D_id for p in bj[i].get_point_ids()] \
            == [bt[i].point(p).point3D_id for p in bt[i].get_point_ids()]
    assert sj.keys() == st.keys()


def test_vpline_bipartites_match_jax():
    labels = np.array([0, -1, 1, 0, 1, -1, 0])
    vps = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    segs = {3: np.zeros((7, 4)), 5: np.zeros((5, 4))}
    rj = {3: JVPResult(labels, vps), 5: JVPResult(labels[:5], vps)}
    rt = {3: TVPResult(labels, vps), 5: TVPResult(labels[:5], vps)}
    bj, bt = j_vp2d(segs, rj), t_vp2d(segs, rt)
    for i in segs:
        assert adjacency(bj[i]) == adjacency(bt[i])
    w = {(0, 1): 3, (1, 0): 2, (0, 2): 5}
    b3j = JVP3d.from_weights([JVPTrack(v) for v in vps], [0, 1, 2], w)
    b3t = TVP3d.from_weights([TVPTrack(v) for v in vps], [0, 1, 2], w)
    assert adjacency(b3j) == adjacency(b3t)


def test_point_track_and_3d_bipartite():
    pt = T.PointTrack(np.array([1.0, 2, 3]), [1, 2], [0, 4],
                      [np.zeros(2)] * 2)
    assert pt.count_images() == 2
    b = T.PL_Bipartite3d()
    b.add_point(pt, 0, [1])
    assert b.get_point_cloud().shape == (1, 3)
    assert b.neighbor_points(1) == [0] and b.get_line_cloud().shape == \
        (0, 2, 3)
