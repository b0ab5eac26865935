"""Line refinement, solves and the JAX package's faults: the port's
``solve_line_refinement`` and ``line_refinement`` against the JAX package
on the scenes of its heatmap, feature-consistency and VP tests, and the
four places where the two differ on purpose (ROADMAP.md section 3): the
iteration count, tracks below ``min_num_images`` with feature terms, and
the transposed feature patches.  The scenes and the normal-equation
comparisons are in ``tests/test_torch_line_refinement.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from limap_tpu.optimize.line_ba import get_output_tracks as j_output
from limap_tpu_torch.ops import lm_line_refine
from limap_tpu_torch.optimize.line_ba import get_output_tracks

from tests.test_torch_line_refinement import (both, build_case,
                                              featuremaps_of, jax_fconsis,
                                              jlr, scene, tlr)
from torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["geometric+vp", "geometric+heatmap",
                                  "geometric+fconsis", "all"])
def test_solve_matches_jax(name):
    rng = np.random.default_rng(5)
    args_t, args_j, _ = build_case(rng, name, loss="trivial")
    lt, rt = tlr.solve_line_refinement(*args_t, num_iterations=10)
    lj, rj = jlr.solve_line_refinement(*args_j, num_iterations=10)
    T = int(args_t[0].track_mask.sum())
    c_t, c_j = rt.cost[:T].numpy(), np.asarray(rj.cost)[:T]
    c0 = rt.cost0[:T].numpy()
    np.testing.assert_allclose(rt.cost0[:T].numpy(),
                               np.asarray(rj.cost0)[:T], rtol=1e-4)
    assert (c_t <= c0 + 1e-6).all()
    # two float32 LM runs of the same problem: final costs within 1 % of
    # the start's scale, lines within 1 cm (the pixel terms are flat
    # where rounding picks another accept)
    assert np.abs(c_t - c_j).max() <= 1e-2 * max(c0.max(), 1e-6)
    ot = get_output_tracks(args_t[0], args_t[1], lt, 0)
    oj = j_output(args_j[0], args_j[1], lj, 0)
    for a, b in ((ot.line.start, oj.line.start), (ot.line.end, oj.line.end)):
        assert np.abs(a[:T].numpy() - np.asarray(b)[:T]).max() < 1e-2


def test_fconsis_pulls_biased_line_back_like_jax():
    """The JAX package's feature-consistency scene: 3 px biased 2D
    observations; geometric-only refinement keeps the bias, the
    feature-consistency term removes most of it, in both packages."""
    rng = np.random.default_rng(0)
    views, tracks, gt = scene(rng, n_views=4, n_tracks=1, noise2d=0.0,
                              noise3d=0.0)
    kv, qv, tv = views
    line, ids, segs = tracks[0]
    segs = segs.copy()
    for v in range(len(ids)):
        d = segs[v, 1] - segs[v, 0]
        d /= np.linalg.norm(d)
        segs[v] += np.array([-d[1], d[0]]) * 3.0
    (jv, jb), (pv, pb), id2idx = both(views, [(gt[0].astype(np.float32),
                                              ids, segs)])
    Tj = jb.mask.shape[0]
    fm = featuremaps_of(views, gt)
    err = {}
    for use in (False, True):
        cfg = dict(loss="trivial", use_feature=use, fconsis_multiplier=50.0)
        fc = tlr.build_fconsis_terms(pb, pv, fm, id2idx, n_samples=8,
                                     patch_radius=12) if use else None
        lt, _ = tlr.solve_line_refinement(pb, pv, tlr.RefinementConfig(**cfg),
                                          fconsis_data=fc,
                                          num_iterations=20)
        lj, _ = jlr.solve_line_refinement(
            jb, jv, jlr.RefinementConfig(**cfg),
            fconsis_data=jax_fconsis([x[:Tj] for x in fc]) if use else None,
            num_iterations=20)
        ot = get_output_tracks(pb, pv, lt, 0)
        oj = j_output(jb, jv, lj, 0)
        et = max(np.abs(ot.line.start[0].numpy() - gt[0][0]).max(),
                 np.abs(ot.line.end[0].numpy() - gt[0][1]).max())
        ej = max(np.abs(np.asarray(oj.line.start[0]) - gt[0][0]).max(),
                 np.abs(np.asarray(oj.line.end[0]) - gt[0][1]).max())
        err[use] = (et, ej)
        assert abs(et - ej) < 0.1 * max(ej, 1e-3) + 1e-3, (use, et, ej)
    assert err[False][0] > 0.01
    assert err[True][0] < 0.6 * err[False][0], err


def test_line_refinement_runs_the_iterations_it_is_asked_for():
    """JAX's line_refinement lands ``num_iterations`` in
    ``heatmap_data``, so ``num_iterations=0`` still refines there; the
    port's leaves the lines as they were re-trimmed."""
    from limap_tpu.base.image_collection import ImageCollection as JCols
    from limap_tpu_torch.base.image_collection import ImageCollection
    rng = np.random.default_rng(4)
    views, tracks, gt = scene(rng, n_views=5, n_tracks=5)
    kv, qv, tv = views

    def cols(mod_cols, mod):
        cams = {0: mod.Camera(K=np.array([[500.0, 0, 320], [0, 500.0, 240],
                                          [0, 0, 1]]), hw=(480, 640))}
        imgs = {i: mod.CameraImage(0, mod.CameraPose(qvec=qv[i],
                                                     tvec=tv[i]))
                for i in range(len(kv))}
        return mod_cols(cams, imgs)

    import limap_tpu.base.image_collection as jbase
    import limap_tpu_torch.base.image_collection as tbase
    (_, jb), (_, pb), _ = both(views, tracks)
    from limap_tpu.base.linetrack import batch_to_tracks as jb2t
    from limap_tpu_torch.base.linetrack import batch_to_tracks as tb2t
    cfg = {"loss": "trivial"}
    out_t = {n: tlr.line_refinement(cfg, tb2t(pb), cols(ImageCollection,
                                                        tbase),
                                    num_iterations=n, device="cpu")
             for n in (0, 20)}
    out_j = {n: jlr.line_refinement(cfg, jb2t(jb), cols(JCols, jbase),
                                    num_iterations=n) for n in (0, 20)}
    lines = lambda ts: np.stack([t.line for t in ts])
    # JAX: the same 20 iterations either way
    np.testing.assert_array_equal(lines(out_j[0]), lines(out_j[20]))
    # the port: 0 iterations re-trims the initial lines, 20 refine them
    assert np.abs(lines(out_t[0]) - lines(out_t[20])).max() > 1e-3
    np.testing.assert_allclose(lines(out_t[20]), lines(out_j[20]),
                               atol=1e-3)
    err = lambda ts: np.abs(lines(ts) - gt).max()
    assert err(out_t[20]) < err(out_t[0])


def test_tracks_below_min_num_images_stay_with_feature_terms():
    """JAX zeroes the geometric, VP and heatmap weights of a track seen in
    fewer than min_num_images views but keeps its feature terms, so the
    track moves on them alone; the port keeps it as it is."""
    rng = np.random.default_rng(6)
    views, tracks, gt = scene(rng, n_views=3, n_tracks=2, noise3d=0.1)
    (jv, jb), (pv, pb), id2idx = both(views, tracks)
    fm = featuremaps_of(views, gt)
    fc = tlr.build_fconsis_terms(pb, pv, fm, id2idx, n_samples=8,
                                 patch_radius=8)
    assert (fc[7][:2] > 0).any()
    cfg = dict(loss="trivial", use_feature=True, fconsis_multiplier=10.0)
    lt, rt = tlr.solve_line_refinement(pb, pv, tlr.RefinementConfig(**cfg),
                                       fconsis_data=fc, num_iterations=10)
    lj, rj = jlr.solve_line_refinement(
        jb, jv, jlr.RefinementConfig(**cfg),
        fconsis_data=jax_fconsis([x[:2] for x in fc]), num_iterations=10)
    assert int(rt.n_accepted[:2].sum()) == 0 and float(rt.cost[0]) == 0.0
    assert int(np.asarray(rj.n_accepted).sum()) > 0


def test_jax_samples_feature_patches_transposed():
    """JAX's _fconsis_residual hands (row, col) to interpolate_bilinear,
    which takes (x, y): it samples each patch at the transposed position.
    On the same terms the port (which samples the patch as cut) equals
    JAX given the transposed patches, and not JAX given them as cut."""
    import jax
    rng = np.random.default_rng(8)
    views, tracks, gt = scene(rng, n_views=4, n_tracks=2)
    (jv, jb), (pv, pb), id2idx = both(views, tracks)
    fc = tlr.build_fconsis_terms(pb, pv, featuremaps_of(views, gt), id2idx,
                                 n_samples=6, patch_radius=6)
    params0, data, terms = tlr.refine_data(
        pb, pv, tlr.RefinementConfig(use_geometric=False, use_feature=True),
        fconsis_data=fc)
    T = 2
    r_t = lm_line_refine.fconsis_residual(
        params0[:T, :4], params0[:T, 4:], pv, *(x[:T] for x in fc[:7]))
    jp = jnp.asarray(params0[:T].numpy())

    def jax_r(transpose):
        f = [jnp.asarray(x[:T].numpy()) for x in fc]
        if transpose:
            f[3], f[4] = (jnp.swapaxes(a, 2, 3) for a in f[3:5])
        return np.asarray(jax.vmap(
            lambda p, *a: jlr._fconsis_residual(p[:4], p[4:], jv, *a))(
            jp, *f[:7]))

    ok = (fc[7][:T] > 0).numpy()
    assert ok.sum() > 4 and np.abs(r_t.numpy()[ok]).max() > 0.1
    np.testing.assert_allclose(r_t.numpy()[ok], jax_r(True)[ok], atol=1e-4)
    assert np.abs(r_t.numpy()[ok] - jax_r(False)[ok]).max() > 1e-2
