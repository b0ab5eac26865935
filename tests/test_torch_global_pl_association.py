"""Joint point-line-VP association: the port
(``limap_tpu_torch.optimize.global_pl_association``, the plain versions of
kernels L and M) against the JAX package on the same numpy inputs.

- The association weights and their padded tables in JAX's order.
- The normal equations at the start of the line step and of the point
  step (J^T J, J^T r, cost) against JAX's ``jacfwd`` on the residuals
  its ``GlobalAssociator.solve`` hands to ``lm_solve``.
- The associator on the JAX package's three scenes (geometry, VP
  orthogonality, junction reassociation), and on a scene with VPs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.structures import PL_Bipartite2d as JBpt
from limap_tpu.structures import PointTrack as JPointTrack
from limap_tpu_torch.ops import lm_assoc
from limap_tpu_torch.structures import PL_Bipartite2d, PointTrack
from limap_tpu_torch.testing import lm_checks

from tests.test_torch_line_refinement import _project, both, scene
from tests.test_torch_normal_equations import jax_terms

jga = importlib.import_module("limap_tpu.optimize.global_pl_association")
tga = importlib.import_module(
    "limap_tpu_torch.optimize.global_pl_association")


class Cols:
    """The smallest image collection the associator reads."""

    def __init__(self, views):
        self.views = views

    def batch(self, device=None):
        return self.views

    def img_id_to_index(self):
        return {i: i for i in range(self.views.kvec.shape[0])}


def assoc_scene(rng, n_views=6, n_tracks=8, n_vps=3, noise_px=0.5):
    """Tracks, two points on each GT line seen in every view (noisy), the
    point-line weights (each point with its line, 5, and a few spurious
    pairs, 3) and VP tracks near the first tracks' directions."""
    views, tracks, gt = scene(rng, n_views=n_views, n_tracks=n_tracks)
    kv, qv, tv = views
    pts, pl = [], {}
    for ti, (a, b) in enumerate(gt):
        for t in rng.uniform(0.2, 0.8, 2):
            X = a + t * (b - a)
            obs = [_project(kv[v], qv[v], tv[v], X)
                   + rng.normal(0, noise_px, 2) for v in range(n_views)]
            pl[(len(pts), ti)] = 5.0
            pts.append((X + rng.normal(0, 0.02, 3), obs))
    for _ in range(4):
        pl[(int(rng.integers(len(pts))), int(rng.integers(n_tracks)))] = 3.0
    dirs = gt[:, 1] - gt[:, 0]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vps = [dirs[v] + rng.normal(0, 0.01, 3) for v in range(n_vps)]
    vpl = {}
    for v in range(n_vps):
        vpl[(v, v)] = 4
        if v + n_vps < n_tracks:
            vpl[(v, v + n_vps)] = 2  # below th_count_vpline: dropped
    return views, tracks, gt, pts, pl, vps, vpl


class VP:
    def __init__(self, d):
        self.direction = np.asarray(d, np.float64)


def make_both(rng, cfg_kw, with_vps=True, **scene_kw):
    views, tracks, gt, pts, pl, vps, vpl = assoc_scene(rng, **scene_kw)
    (jv, jb), (pv, pb), _ = both(views, tracks)
    out = []
    for mod, v, b, PT in ((jga, jv, jb, JPointTrack), (tga, pv, pb,
                                                       PointTrack)):
        kw = {} if mod is jga else {"device": "cpu"}
        a = mod.GlobalAssociator(mod.GlobalAssociatorConfig(**cfg_kw), **kw)
        a.init_imagecols(Cols(v))
        a.init_line_tracks(b)
        a.init_point_tracks([PT(X.astype(np.float32),
                                image_id_list=list(range(len(obs))),
                                p2d_list=list(obs)) for X, obs in pts],
                            max_supports=8)
        a.init_vp_tracks([VP(d) for d in vps] if with_vps else [])
        a.set_pointline_weights(pl)
        a.set_vpline_weights(vpl if with_vps else {})
        out.append(a)
    return out, gt, pts


def record(monkeypatch, module, names):
    seen = {n: [] for n in names}
    for n in names:
        orig = getattr(module, n)

        def rec(*args, _orig=orig, _n=n, **kw):
            seen[_n].append((args, kw))
            return _orig(*args, **kw)

        monkeypatch.setattr(module, n, rec)
    return seen


@pytest.mark.parametrize("with_vps", [True, False])
def test_normal_equations_match_jax(with_vps, monkeypatch):
    """Kernels L and M's plain normal equations at the start of the first
    round against JAX's jacfwd of its line and point residuals."""
    rng = np.random.default_rng(3)
    (ja, ta), _, _ = make_both(rng, dict(n_bcd_rounds=1, lm_iterations=0),
                               with_vps)
    seen_j = record(monkeypatch, jga, ["lm_solve"])
    seen_t = record(monkeypatch, lm_assoc, ["solve_lines", "solve_points"])
    ja.solve()
    ta.solve()
    (jl, _), (jp, _) = seen_j["lm_solve"]
    T = jl[0].shape[0]
    for name, j_args, t_rec, D, ne_fn, ne_plain in (
            ("lines", jl, seen_t["solve_lines"], 4,
             lm_assoc.normal_equations_lines,
             lm_assoc.normal_equations_lines_plain),
            ("points", jp, seen_t["solve_points"], 3,
             lm_assoc.normal_equations_points,
             lm_assoc.normal_equations_points_plain)):
        params0, data, terms = t_rec[0][0][:3]
        n = j_args[0].shape[0]
        ne_t = [x[:n] for x in ne_fn(params0, data, terms)]
        d64 = type(data)(*(x.double() if x.is_floating_point() else x
                           for x in data))
        ne_64 = [x[:n] for x in ne_plain(params0.double(), d64, terms)]
        ne_j = jax_terms(j_args[1], j_args[2], D, j_args[0], j_args[4])
        res = lm_checks.compare_normal_equations(ne_t, ne_j, ne_64)
        assert res["ok"], (name, res)
        assert res["finite_entries"] == n * (D * D + D + 1), (name, res)
    assert T == 8
    # the VP slots are used where there are VPs
    t_lines = seen_t["solve_lines"][0][0][1]
    assert bool((t_lines.vp_w > 0).any()) == with_vps


def test_pad_assoc_keeps_insertion_order():
    pairs = {(1, 7): 1.0, (0, 3): 2.0, (1, 2): 3.0}
    pairs.update({(2, k): float(k) for k in range(12)})
    ij, wj = jga._pad_assoc(pairs, 3, 8)
    it, wt = tga._pad_assoc(pairs, 3, 8, device="cpu")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert it.dtype == torch.int32 and it[1, :2].tolist() == [7, 2]


def test_weights_match_jax_in_order():
    """construct_weights_pointline from bipartites built by both packages:
    the same keys in the same order with the same counts."""
    rng = np.random.default_rng(4)
    bpts = {}
    for mod, cls, kw in (("j", JBpt, {}), ("t", PL_Bipartite2d,
                                           {"device": "cpu"})):
        r = np.random.default_rng(7)
        out = {}
        for img in (3, 1, 2):
            b = cls(**kw)
            b.init_lines(r.uniform(0, 100, (12, 4)))
            kp = r.uniform(0, 100, (40, 2))
            b.add_keypoints_with_point3D_ids(kp, r.integers(0, 15, 40))
            out[img] = b
        bpts[mod] = out
    for img in bpts["j"]:
        for pid in bpts["j"][img].get_point_ids():
            assert bpts["j"][img].neighbor_lines(pid) == \
                bpts["t"][img].neighbor_lines(pid)
    ptrack = {img: {p: int(rng.integers(-1, 6)) for p in range(40)}
              for img in (1, 2, 3)}
    ltrack = {img: {l: int(rng.integers(-1, 5)) for l in range(12)}
              for img in (1, 2, 3)}
    wj = jga.construct_weights_pointline(bpts["j"], ptrack, ltrack)
    wt = tga.construct_weights_pointline(bpts["t"], ptrack, ltrack)
    assert list(wj.items()) == list(wt.items()) and len(wt) > 10


@pytest.mark.parametrize("with_vps", [False, True])
def test_associator_matches_jax(with_vps):
    """The JAX package's geometry scene (and one with VPs): lines, points
    and VPs out of three rounds, in both packages."""
    rng = np.random.default_rng(0)
    (ja, ta), gt, pts = make_both(
        rng, dict(loss="trivial", th_weight_pointline=1.0, n_bcd_rounds=3),
        with_vps)
    lj, pj, vj = ja.solve()
    lt, p_t, vt = ta.solve()
    T = lj.shape[0]
    oj, ot = ja.get_output_lines(), ta.get_output_lines()
    for a, b in ((ot.line.start, oj.line.start), (ot.line.end, oj.line.end)):
        assert np.abs(a[:T].numpy() - np.asarray(b)).max() < 2e-3
    np.testing.assert_allclose(p_t.numpy(), np.asarray(pj), atol=2e-3)
    if with_vps:
        assert np.abs(np.asarray(vt) - np.asarray(vj)).max() < 1e-3
    # the points stay near their GT (a spurious association pulls one off
    # in both packages)
    mid = np.asarray([X for X, _ in pts])
    assert np.median(np.abs(p_t.numpy() - mid).max(1)) < 0.05
    bj, bt = ja.get_bipartite3d_pointline(), ta.get_bipartite3d_pointline()
    assert bj.np2l == bt.np2l and bt.count_edges() >= len(pts) - 2


def test_vp_orthogonality_squares_up():
    cfg = dict(lw_vp_orthogonality=1.0, th_angle_orthogonality=87.0,
               lw_vpline_association=1e-3)
    a = np.radians(89.0)
    vps = np.array([[1.0, 0.0, 0.0], [np.cos(a), np.sin(a), 0.0]])
    d_np = np.array([vps[0], vps[0], vps[1], vps[1]])
    lv = {(0, 0): 1.0, (1, 0): 1.0, (2, 1): 1.0, (3, 1): 1.0}
    out = {}
    for mod, kw in ((jga, {}), (tga, {"device": "cpu"})):
        assoc = mod.GlobalAssociator(mod.GlobalAssociatorConfig(**cfg), **kw)
        po, pc = assoc._vp_pairs(vps)
        assert po == [(0, 1)] and pc == []
        out[mod] = assoc._vp_pair_refine(vps, d_np, lv, po, pc)
    # both square the pair up (the port's steps are damped, JAX's not)
    for o in out.values():
        ang = np.degrees(np.arccos(min(abs(float(o[0] @ o[1])), 1.0)))
        assert abs(ang - 90.0) < 0.2


def test_vp_pair_refinement_keeps_orthogonal_vps():
    """JAX's VP pair refinement takes every undamped Gauss-Newton step;
    its residuals grow with a VP's norm, so a step shrinks the VPs and
    the renormalized directions land far from their lines: two
    orthogonal façade VPs with member lines ~1 deg off end 74 deg apart,
    one of them 90 deg from its lines.  The port's steps are damped and
    taken only where they lower the cost: the pair stays orthogonal and
    on its lines."""
    rng = np.random.default_rng(0)
    vps = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    d = np.concatenate([vps[0] + rng.normal(0, 0.02, (14, 3)),
                        vps[1] + rng.normal(0, 0.02, (11, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lv = {(l, 0 if l < 14 else 1): 4.0 for l in range(25)}
    ang = lambda u, v: np.degrees(np.arccos(min(
        abs(float(u @ v)) / np.linalg.norm(u) / np.linalg.norm(v), 1.0)))
    out = {}
    for mod, kw in ((jga, {}), (tga, {"device": "cpu"})):
        a = mod.GlobalAssociator(mod.GlobalAssociatorConfig(), **kw)
        po, pc = a._vp_pairs(vps)
        assert po == [(0, 1)]
        out[mod] = np.asarray(a._vp_pair_refine(vps, d, lv, po, pc),
                              np.float64)
    j, t = out[jga], out[tga]
    assert abs(ang(j[0], j[1]) - 90.0) > 10.0
    assert max(ang(j[1], x) for x in d[14:]) > 45.0
    assert abs(ang(t[0], t[1]) - 90.0) < 0.5
    assert max(ang(t[1], x) for x in d[14:]) < 5.0


def test_junction_reassociation_matches_jax():
    line1 = np.array([[-1.0, 0.0, 5.0], [1.0, 0.0, 5.0]])
    line2 = np.array([[0.0, -1.0, 5.0], [0.0, 1.0, 5.0]])
    line3 = np.array([[-1.0, 0.1, 5.0], [1.0, 0.12, 5.0]])

    class _Track:
        def __init__(self, line):
            self.line = line

    tracks = [_Track(line1), _Track(line2), _Track(line3)]
    res = {}
    for name, mod, cls, kw in (("j", jga, JBpt, {}),
                               ("t", tga, PL_Bipartite2d,
                                {"device": "cpu"})):
        bpts, l2t = {}, {}
        for img in range(4):
            b = cls(**kw)
            b.init_lines(np.array([[50.0, 100, 150, 100],
                                   [100.0, 50, 100, 150],
                                   [50.0, 101, 150, 102]]))
            b.add_keypoints_with_point3D_ids(np.array([[100.0, 100.5]]),
                                             [-1])
            bpts[img] = b
            l2t[img] = {0: 0, 1: 1, 2: 2}
        assoc = mod.GlobalAssociator(mod.GlobalAssociatorConfig(), **kw)
        assoc.points = (jnp.zeros((0, 3)) if name == "j"
                        else torch.zeros((0, 3)))
        tr, w = assoc.reassociate_junctions(bpts, l2t, tracks)
        res[name] = (tr, w, bpts[0].point(0).point3D_id)
    (tj, wj, pj), (tt, wt, pt) = res["j"], res["t"]
    assert len(tt) == len(tj) == 2 and wt == wj and pt == pj
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(a.p, b.p)
        assert a.image_id_list == b.image_id_list


def test_association_norms_at_zero(monkeypatch):
    """Fault 2 of the JAX package: the forward derivative of a vector norm
    at an exactly zero vector is NaN in JAX and 0 in torch (and kernels L
    and M), here the point-line distance of a point on its line.  The
    association reaches the neighbourhood of the VP sine's zero: the host
    VP step sets a VP with a single member line to that line's direction,
    and the next round's sine is rounding (~1e-8 in both packages; XLA's
    fused cross product leaves it off exact zero, and the checks call it
    a corner).  Exactly at zero JAX's row turns NaN; the port's stays
    finite."""
    import jax
    from limap_tpu.base.infinite_line import InfiniteLines3d as JLine
    from limap_tpu_torch.base.infinite_line import InfiniteLines3d
    d, m = [0.6, 0.0, 0.8], [0.0, 0.0, 0.0]
    _, tj = jax.jvp(lambda q: JLine(jnp.asarray(d), jnp.asarray(m))
                    .point_distance(q), (jnp.zeros(3),), (jnp.ones(3),))
    assert np.isnan(float(tj))
    _, tt = torch.func.jvp(
        lambda q: InfiniteLines3d(torch.tensor(d), torch.tensor(m))
        .point_distance(q), (torch.zeros(3),), (torch.ones(3),))
    assert float(tt) == 0.0
    # the path: VP v has the single member track v (weight 4)
    rng = np.random.default_rng(3)
    (_, ta), _, _ = make_both(rng, dict(n_bcd_rounds=2, lm_iterations=10))
    seen = record(monkeypatch, lm_assoc, ["solve_lines"])
    ta.solve()
    params0, data, terms = seen["solve_lines"][1][0][:3]   # round 2
    margins = lm_checks.assoc_corner_lines(data, terms)(
        np.arange(params0.shape[0]), params0.numpy())
    assert (margins[:3] <= 1).all()
    ne = lm_assoc.normal_equations_lines(params0, data, terms)
    assert all(torch.isfinite(x).all() for x in ne)


def facade_line_map(tmp, n_views=8, n_lines=40, hw=(240, 320)):
    """The façade's COLMAP model with points on the GT lines, and a line
    map built from the GT: each line seen where both ends project inside
    the image, its 2D segments the noisy projections (ids in order of the
    lines), its 3D line the GT moved by ~3 cm."""
    from limap_tpu_torch.base.linetrack import LineTrack
    from limap_tpu_torch.pointsfm import ReadInfos
    from limap_tpu_torch.testing import pipeline
    model, image_dir, gt = pipeline.write_colmap_scene(
        str(tmp), n_views=n_views, n_lines=n_lines, hw=hw, n_points=300,
        n_line_points=300)
    cols = ReadInfos(model, image_dir)
    rng = np.random.default_rng(9)
    h, w = hw
    segs = {i: [] for i in cols.get_img_ids()}
    obs = [[] for _ in gt]
    for img_id in cols.get_img_ids():
        v = cols.camview(img_id)
        for li, (a, b) in enumerate(gt):
            pc = np.stack([a, b]) @ v.R().T + v.T()
            uv = pc[:, :2] / pc[:, 2:] * v.cam.kvec()[:2] + v.cam.kvec()[2:]
            if (uv >= 0).all() and (uv[:, 0] < w).all() \
                    and (uv[:, 1] < h).all():
                uv = uv + rng.normal(0, 0.3, (2, 2))
                obs[li].append((img_id, len(segs[img_id]), uv))
                segs[img_id].append(uv.reshape(-1))
    all_2d_segs = {i: np.asarray(s, np.float64).reshape(-1, 4)
                   for i, s in segs.items()}
    tracks = []
    for li, o in enumerate(obs):
        if len(o) < 4:
            continue
        line = gt[li] + rng.normal(0, 0.03, (2, 3))
        tracks.append(LineTrack(
            line=line, image_id_list=[x[0] for x in o],
            line_id_list=[x[1] for x in o],
            line2d_list=[x[2] for x in o], line3d_list=[line] * len(o),
            score_list=[1.0] * len(o)))
    return model, image_dir, gt, cols, all_2d_segs, tracks


def test_runner_matches_jax_with_vps_replayed(tmp_path, monkeypatch):
    """Both packages' pointline_association on a small façade model (8
    views, points on the GT lines with their 2D observations): the port's
    VP results replayed into JAX's runner (its J-Linkage hypotheses come
    from another generator) and the port's VP pair refinement in JAX's
    associator, then the same tracks, points and VPs."""
    import limap_tpu.base.linetrack as jlt
    from limap_tpu.pointsfm import ReadInfos as JReadInfos
    from limap_tpu.pointsfm import read_model as j_read_model
    from limap_tpu.vplib.jlinkage import VPResult as JResult
    from limap_tpu_torch.pointsfm import read_model
    from limap_tpu_torch.runners import pointline_association
    from limap_tpu_torch.util.config import default_pl_association_config
    from limap_tpu_torch.vplib import get_vp_detector
    jpl = importlib.import_module("limap_tpu.runners.pointline_association")
    model, image_dir, gt, cols, segs, tracks = facade_line_map(tmp_path)
    cfg = default_pl_association_config()
    cfg["vpdet_config"]["min_num_supports"] = 4
    cfg["global_pl_association"]["n_bcd_rounds"] = 2
    res = get_vp_detector(cfg["vpdet_config"], device="cpu") \
        .detect_vp_all_images(segs)
    assert sum(r.count_vps() for r in res.values()) >= 8

    class Replay:
        def detect_vp_all_images(self, s, camviews=None):
            return {i: JResult(res[i].labels, res[i].vps) for i in s}

    monkeypatch.setattr(jpl, "get_vp_detector", lambda c, n_jobs=1:
                        Replay())
    # JAX's VP pair refinement takes undamped steps (see
    # test_vp_pair_refinement_keeps_orthogonal_vps): it runs the port's
    monkeypatch.setattr(jga.GlobalAssociator, "_vp_pair_refine",
                        tga.GlobalAssociator._vp_pair_refine)
    _, _, p2d, p3d = read_model(model)
    out_t = pointline_association(dict(cfg, output_dir=str(tmp_path / "t")),
                                  cols, tracks, segs, p3d, p2d,
                                  device="cpu", return_associator=True)
    _, _, jp2d, jp3d = j_read_model(model)
    jtracks = [jlt.LineTrack.from_dict(t.as_dict()) for t in tracks]
    out_j = jpl.pointline_association(
        dict(cfg, output_dir=str(tmp_path / "j")),
        JReadInfos(model, image_dir), jtracks, segs, jp3d, jp2d)
    lt = np.stack([t.line for t in out_t[0]])
    lj = np.stack([t.line for t in out_j[0]])
    assert lt.shape == lj.shape and len(lt) >= 12
    np.testing.assert_allclose(lt, lj, atol=2e-3)
    # two float32 LM runs of each point: a point seen in two or three
    # views lies in a flat valley along its rays, where rounding picks
    # another accept (5 mm at 10 m); most agree to 0.1 mm
    dp = np.abs(out_t[1] - np.asarray(out_j[1]))
    assert dp.max() < 5e-3 and np.median(dp) < 1e-4, (dp.max(),
                                                       np.median(dp))
    assert len(out_t[2]) == len(out_j[2]) >= 2
    np.testing.assert_allclose(np.abs(out_t[2]), np.abs(np.asarray(
        out_j[2])), atol=1e-3)
    # the line points find their lines
    assoc = out_t[3]
    assert len(assoc.pl_weights) > 50
    assert assoc.get_bipartite3d_pointline().count_edges() > 50
