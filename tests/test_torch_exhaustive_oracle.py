"""The exhaustive matcher at 5 views x 40 lines, 0.1 px of noise,
against the f64 reference oracle, where JAX's exhaustive path overflows
its bucket: the port follows the oracle, and JAX's collapse is kept on
record."""

import pytest

from limap_tpu.testing import reference_oracle as oracle

from test_torch_exhaustive import (ORACLE_CFG, TIE_EPS, TIE_LINE_TOL,
                                   _best_gaps, _jax_exhaustive, _line_err,
                                   _port_exhaustive, _scene, _supports)


@pytest.fixture(scope="module")
def scene_5x40():
    return _scene(5, 40, 0.1)


def test_exhaustive_matches_oracle_where_jax_overflows(scene_5x40):
    """5 views x 40 lines, 0.1 px: the port's supports are the oracle's
    and its lines lie within 1e-3 m of the oracle's, but where a support
    took a near-tied proposal (TIE_EPS)."""
    views, segs, nbrs = scene_5x40
    ocfg = oracle.OracleConfig(fullscore_th=0.5, **ORACLE_CFG)
    otri = oracle.OracleTriangulator(
        views, {i: s.reshape(-1, 2, 2) for i, s in segs.items()}, ocfg)
    for i in sorted(nbrs):
        otri.triangulate_image_exhaustive(i, nbrs[i])
    otracks = {tuple(sorted(t.supports)): t for t in
               otri.compute_line_tracks()}
    pt = _port_exhaustive(views, segs, nbrs, per_image=False,
                          fullscore_th=0.5)
    assert pt.overflow_edges == 0
    assert pt.exhaustive_stats["survivors_max"] > 64
    ptracks = {_supports(t): t for t in pt.compute_line_tracks()}
    assert set(ptracks) == set(otracks)
    assert len(ptracks) >= 35
    gaps = _best_gaps(pt, nbrs)
    tied = 0
    for s, t in ptracks.items():
        err = _line_err(t.line, otracks[s].line)
        if err > 1e-3:
            assert min(gaps[n] for n in s) < TIE_EPS, (s, err)
            assert err < TIE_LINE_TOL
            tied += 1
    assert tied <= 2


def test_jax_exhaustive_collapses_where_it_overflows(scene_5x40):
    """On record: JAX's exhaustive path drops most candidates at 5 x 40
    (each line keeps 64 of its 160 raw pairs, all of its first neighbour
    and none of the others) and loses most of the oracle's tracks."""
    views, segs, nbrs = scene_5x40
    jt = _jax_exhaustive(views, segs, nbrs, fullscore_th=0.5)
    assert jt.overflow_edges == 5 * 40 * (4 * 40 - 64)
    assert len(jt.compute_line_tracks()) < 20


@pytest.mark.parametrize("n_lines,jax_tracks,jax_overflow",
                         [(12, 12, 0), (40, 19, 19_200), (100, 0, 168_000)])
def test_jax_exhaustive_collapse_probe(rng, n_lines, jax_tracks,
                                       jax_overflow):
    """The JAX package's exhaustive path on tests/test_triangulator.py's
    scene (5 views, perfect geometry, max_tris_per_node 64, fullscore_th
    0.5): its tracks fall from 12 of 12 lines to 19 of 40 and 0 of 100 as
    the bucket overflows; the port keeps (nearly) every line."""
    from limap_tpu_torch.base.image_collection import \
        ImageCollection as PCollection
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)
    from test_triangulator import build_scene
    imagecols, _, segs = build_scene(rng, n_views=5, n_lines=n_lines)
    nbrs = {i: [j for j in range(5) if j != i] for i in range(5)}
    jt = _jax_exhaustive_cols(imagecols, segs, nbrs)
    assert jt.overflow_edges == jax_overflow
    assert len(jt.compute_line_tracks()) == jax_tracks
    pt = GlobalLineTriangulator(TriangulatorConfig(fullscore_th=0.5),
                                device="cpu")
    pt.init(segs, PCollection.from_dict(imagecols.as_dict()))
    pt.triangulate_all_exhaustive(nbrs)
    assert pt.overflow_edges == 0
    assert len(pt.compute_line_tracks()) >= 0.9 * n_lines


def _jax_exhaustive_cols(imagecols, segs, nbrs):
    from limap_tpu.triangulation.triangulator import \
        GlobalLineTriangulator as JTri
    from limap_tpu.triangulation.triangulator import \
        TriangulatorConfig as JCfg
    jt = JTri(JCfg(fullscore_th=0.5))
    jt.init(segs, imagecols)
    for i in sorted(nbrs):
        jt.triangulate_image_exhaustive(i, nbrs[i])
    return jt
