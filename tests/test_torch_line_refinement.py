"""Line refinement: the port (``limap_tpu_torch.optimize.line_refinement``,
the plain version of kernel K) against the JAX package on the same numpy
inputs: the normal equations at the start (J^T J, J^T r, cost) of every
term alone and of all four together, against JAX's ``jacfwd`` on the
residual its ``solve_line_refinement`` hands to ``lm_solve``, and the
heatmap patches and feature terms.  The scenes here also serve
``tests/test_torch_line_refinement_solves.py`` (solves and the JAX
package's faults).

Two differences are given to JAX on purpose where the two are compared
(ROADMAP.md section 3): the port drops the feature terms of a track seen
in fewer than ``min_num_images`` views, and it samples the feature
patches as cut where JAX samples them transposed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.linetrack import LineTrack as JTrack
from limap_tpu.base.linetrack import tracks_to_batch as j_tracks_to_batch
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.linetrack import LineTrack, tracks_to_batch
from limap_tpu_torch.ops import lm_line_refine
from limap_tpu_torch.testing import lm_checks

from tests.test_torch_normal_equations import as64, jax_terms
from torch_threads import two_torch_threads  # noqa: F401

# the JAX package's optimize/__init__ exports a function of the module's
# name, so the module itself comes from importlib
jlr = importlib.import_module("limap_tpu.optimize.line_refinement")
tlr = importlib.import_module("limap_tpu_torch.optimize.line_refinement")


def _views(rng, n_views, spread=0.6):
    K = np.array([500.0, 500.0, 320.0, 240.0])
    q, t = [], []
    for k in range(n_views):
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.08)
        x = R.as_quat()
        q.append([x[3], x[0], x[1], x[2]])
        t.append([spread * k, 0.03 * k, 0.01 * k])
    return (np.tile(K, (n_views, 1)).astype(np.float32),
            np.asarray(q, np.float32), np.asarray(t, np.float32))


def _project(kv, qv, tv, X):
    R = Rotation.from_quat(np.concatenate([qv[1:], qv[:1]])).as_matrix()
    pc = R @ X + tv
    return kv[:2] * pc[:2] / pc[2] + kv[2:]


def scene(rng, n_views=6, n_tracks=8, noise2d=0.3, noise3d=0.05,
          skip=0.0):
    """Tracks of lines ~8 m in front of the views, their 2D supports the
    noisy projections (a share ``skip`` of supports left out): (views as
    numpy (kvec, qvec, tvec), [(line [2, 3], img ids, 2D segs)], GT)."""
    kv, qv, tv = _views(rng, n_views)
    tracks, gt = [], []
    for _ in range(n_tracks):
        a = rng.normal(size=3) + [0.0, 0.0, 8.0]
        b = a + rng.normal(size=3)
        ids = [v for v in range(n_views) if rng.random() >= skip]
        if len(ids) < 2:
            ids = list(range(n_views))
        segs = [np.stack([_project(kv[v], qv[v], tv[v], a),
                          _project(kv[v], qv[v], tv[v], b)])
                + rng.normal(0, noise2d, (2, 2)) for v in ids]
        line = np.stack([a, b]) + rng.normal(0, noise3d, (2, 3))
        tracks.append((line.astype(np.float32), ids,
                       np.asarray(segs, np.float32)))
        gt.append(np.stack([a, b]))
    return (kv, qv, tv), tracks, np.asarray(gt)


def both(views, tracks):
    """The same scene as (JAX views, JAX batch) and (port views, port
    batch), views in row order = image id."""
    kv, qv, tv = views
    jv = JViews(jnp.asarray(kv), jnp.asarray(qv), jnp.asarray(tv))
    pv = CameraViewsBatch(*(torch.as_tensor(a) for a in (kv, qv, tv)))
    mk = lambda cls, line, ids, segs: cls(
        line=line, image_id_list=list(ids), line_id_list=list(range(len(ids))),
        line2d_list=list(segs), line3d_list=[line] * len(ids),
        score_list=[1.0] * len(ids))
    id2idx = {i: i for i in range(len(kv))}
    jb = j_tracks_to_batch([mk(JTrack, *t) for t in tracks], id2idx)
    pb = tracks_to_batch([mk(LineTrack, *t) for t in tracks], id2idx,
                         device="cpu")
    return (jv, jb), (pv, pb), id2idx


def capture_jax(monkeypatch):
    """Record the residual and aux JAX's solve hands to lm_solve."""
    seen = {}
    orig = jlr.lm_solve

    def rec(params0, residual_fn, retract_fn, D, aux, **kw):
        seen.update(params0=params0, fn=residual_fn, aux=aux)
        return orig(params0, residual_fn, retract_fn, D, aux, **kw)

    monkeypatch.setattr(jlr, "lm_solve", rec)
    return seen


def vp_data(rng, views, batch_np_mask, gt_dirs, img_index):
    """Per-support VPs: the GT direction in the support's camera, moved
    by ~1 deg, as homogeneous pixels; a third of the supports without."""
    kv, qv, tv = views
    T, S = batch_np_mask.shape
    vps = np.zeros((T, S, 3), np.float32)
    has = np.zeros((T, S), bool)
    for t in range(T):
        for s in range(S):
            if not batch_np_mask[t, s] or rng.random() < 0.33:
                continue
            v = img_index[t, s]
            R = Rotation.from_quat(np.concatenate(
                [qv[v][1:], qv[v][:1]])).as_matrix()
            d = R @ gt_dirs[t] + rng.normal(0, 0.02, 3)
            K = np.array([[kv[v][0], 0, kv[v][2]], [0, kv[v][1], kv[v][3]],
                          [0, 0, 1]])
            vp = K @ d
            vps[t, s] = vp / np.linalg.norm(vp)
            has[t, s] = True
    return vps, has


def heatmaps_of(views, gt, hw=(480, 640)):
    """A smooth ridge along every GT line's projection in every view."""
    kv, qv, tv = views
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = {}
    for v in range(len(kv)):
        hm = np.zeros((H, W), np.float32)
        for a, b in gt:
            p0 = _project(kv[v], qv[v], tv[v], a)
            p1 = _project(kv[v], qv[v], tv[v], b)
            d = (p1 - p0) / np.linalg.norm(p1 - p0)
            dist = np.abs((xx - p0[0]) * -d[1] + (yy - p0[1]) * d[0])
            hm = np.maximum(hm, np.exp(-dist ** 2 / 8.0))
        out[v] = hm
    return out


def featuremaps_of(views, gt, hw=(480, 640)):
    """Two channels: functions of the distance to the nearest GT line's
    projection, scaled by view, as the JAX package's fconsis test."""
    kv, qv, tv = views
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = {}
    for v in range(len(kv)):
        dist = np.full((H, W), np.inf, np.float32)
        for a, b in gt:
            p0 = _project(kv[v], qv[v], tv[v], a)
            p1 = _project(kv[v], qv[v], tv[v], b)
            d = (p1 - p0) / np.linalg.norm(p1 - p0)
            dist = np.minimum(dist, np.abs((xx - p0[0]) * -d[1]
                                           + (yy - p0[1]) * d[0]))
        out[v] = np.stack([(v + 1.0) * np.tanh(dist / 4.0),
                           0.5 * (v + 2.0) * np.tanh(dist / 6.0)],
                          -1).astype(np.float32)
    return out


def jax_fconsis(fdata):
    """Port fconsis data -> JAX's tuple, its patches transposed (JAX
    samples them so) and padded to JAX's 64 terms."""
    out = []
    for i, x in enumerate(fdata):
        a = x.numpy()
        if i in (3, 4):
            a = a.swapaxes(2, 3)
        pad = [(0, 0), (0, 64 - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        out.append(jnp.asarray(np.pad(a, pad)))
    return tuple(out)


CASES = {
    "geometric": dict(),
    "vp": dict(use_geometric=False, use_vp=True),
    "heatmap": dict(use_geometric=False, use_heatmap=True),
    "fconsis": dict(use_geometric=False, use_feature=True,
                    fconsis_multiplier=10.0),
    "geometric+vp": dict(use_vp=True),
    "geometric+heatmap": dict(use_heatmap=True),
    "geometric+fconsis": dict(use_feature=True, fconsis_multiplier=10.0),
    "all": dict(use_vp=True, use_heatmap=True, use_feature=True,
                fconsis_multiplier=10.0),
}


def build_case(rng, name, loss="cauchy"):
    views, tracks, gt = scene(rng, n_views=5, n_tracks=6, skip=0.15)
    (jv, jb), (pv, pb), id2idx = both(views, tracks)
    kw = dict(loss=loss, **CASES[name])
    cfg_j, cfg_t = jlr.RefinementConfig(**kw), tlr.RefinementConfig(**kw)
    mask = pb.mask.numpy()
    vps, has = vp_data(rng, views, mask, gt[:, 1] - gt[:, 0],
                       pb.img_index.numpy())
    hm = heatmaps_of(views, gt) if cfg_t.use_heatmap else None
    fm = featuremaps_of(views, gt) if cfg_t.use_feature else None
    hm_t = tlr.build_heatmap_patches(pb, hm) if hm else None
    fc_t = tlr.build_fconsis_terms(pb, pv, fm, id2idx, n_samples=8,
                                   patch_radius=6) if fm else None
    args_t = (pb, pv, cfg_t, torch.as_tensor(vps), torch.as_tensor(has),
              hm_t, fc_t)
    Tj = jb.mask.shape[0]       # JAX pads no tracks
    # JAX keeps the feature terms of tracks seen in fewer than
    # min_num_images views; the port drops them (ROADMAP.md section 3):
    # JAX is given them dropped
    free = (pb.count_images() >= cfg_t.min_num_images)[:Tj]
    fc_j = [x[:Tj] for x in fc_t] if fm else None
    if fm:
        fc_j[7] = fc_j[7] * free[:, None]
    args_j = (jb, jv, cfg_j, jnp.asarray(vps[:Tj]), jnp.asarray(has[:Tj]),
              jlr.build_heatmap_patches(jb, hm) if hm else None,
              jax_fconsis(fc_j) if fm else None)
    return args_t, args_j, gt


@pytest.mark.parametrize("name", ["geometric", "vp", "heatmap", "fconsis",
                                  "all"])
def test_normal_equations_of_each_term_match_jax(name, monkeypatch):
    rng = np.random.default_rng(11)
    args_t, args_j, _ = build_case(rng, name)
    seen = capture_jax(monkeypatch)
    jlr.solve_line_refinement(*args_j, num_iterations=0)
    params0, data, terms = tlr.refine_data(*args_t)
    ne_t = lm_line_refine.normal_equations(params0, data, terms)
    ne_64 = lm_line_refine.normal_equations_plain(
        params0.double(), lm_line_refine.RefineData(*as64(data)), terms)
    ne_j = jax_terms(seen["fn"], jlr.retract_quat_so2, 4, seen["params0"],
                     seen["aux"])
    # JAX pads no tracks; the port's batch pads to a shape bucket
    T = int(args_t[0].track_mask.sum())
    assert ne_j[2].shape[0] == T
    ne_t, ne_64 = ([x[:T] for x in ne] for ne in (ne_t, ne_64))
    res = lm_checks.compare_normal_equations(ne_t, ne_j, ne_64)
    print(name, res)
    assert res["ok"], res
    assert res["finite_entries"] >= T * 21, res
    # the terms reach the lines: every track seen in min_num_images views
    # has a non-zero system
    free = (args_t[0].count_images() >= 4)[:T]
    assert free.sum() >= 3
    assert (ne_t[0][free].abs().sum((1, 2)) > 0).all()


def test_fconsis_terms_match_jax():
    """build_fconsis_terms: the same terms in the same order (views,
    sample lines, origins, weights) and the same patches as JAX's."""
    rng = np.random.default_rng(2)
    views, tracks, gt = scene(rng, n_views=5, n_tracks=4, skip=0.2)
    (jv, jb), (pv, pb), id2idx = both(views, tracks)
    fm = featuremaps_of(views, gt)
    ft = tlr.build_fconsis_terms(pb, pv, fm, id2idx, n_samples=6,
                                 patch_radius=5)
    fj = jlr.build_fconsis_terms(jb, jv, fm, id2idx, n_samples=6,
                                 patch_radius=5)
    F = ft[0].shape[1]
    assert (np.asarray(fj[7])[:, F:] == 0).all()
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :F],
                                   rtol=1e-5, atol=1e-5)
    assert (ft[7] > 0).sum() > 20


def test_heatmap_patches_match_jax():
    rng = np.random.default_rng(3)
    views, tracks, gt = scene(rng, n_views=4, n_tracks=5)
    (jv, jb), (pv, pb), _ = both(views, tracks)
    hm = heatmaps_of(views, gt)
    # the two batches pad to other shapes: the real tracks and supports
    T, S = int(pb.track_mask.sum()), int(pb.mask.sum(1).max())
    for a, b in zip(tlr.build_heatmap_patches(pb, hm),
                    jlr.build_heatmap_patches(jb, hm)):
        np.testing.assert_allclose(a.numpy()[:T, :S], np.asarray(b)[:T, :S],
                                   rtol=1e-5, atol=1e-5)
