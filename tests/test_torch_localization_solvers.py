"""The port's minimal pose solvers against the JAX package's, on the same
numpy inputs: polynomial roots, Kabsch and P3P, and the point-line
solvers through the root finder (the port's plain version on the CPU).
The root finder's f32 grid is held bit-equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limap_tpu.estimators.pnl_solvers as jpnl
import limap_tpu_torch.estimators.pnl_solvers as tpnl
from limap_tpu.estimators.p3p import kabsch as jkabsch, p3p as jp3p
from limap_tpu.ops import polynomial as jpoly
from limap_tpu_torch.estimators.p3p import kabsch as tkabsch, p3p as tp3p
from limap_tpu_torch.ops import polynomial as tpoly
from limap_tpu_torch.ops.trace_roots import alpha_grid
from tests.test_pnl_solvers import _make_scene, _random_pose


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def assert_close_nan(a, b, rtol, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=atol)


def test_polynomial_roots_match_jax():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=200) for _ in range(3))
    # the same closed forms in f32; cbrt and pow round differently
    assert_close_nan(jpoly.solve_quadratic(j(a), j(b), j(c)),
                     tpoly.solve_quadratic(t(a), t(b), t(c)), 1e-5, 1e-6)
    np.testing.assert_allclose(
        jpoly.solve_cubic_real(j(a), j(b), j(c)),
        tpoly.solve_cubic_real(t(a), t(b), t(c)), rtol=1e-4, atol=1e-5)
    # quartics with 0, 2 and 4 real roots
    roots = rng.normal(size=(300, 4)) * 2
    coef = np.stack([np.poly(r)[1:] for r in roots])
    coef[100:200, 3] += 3.0
    coef[200:, 1] += 8.0
    jq = np.asarray(jpoly.solve_quartic_real(*(j(coef[:, k])
                                               for k in range(4))))
    tq = tpoly.solve_quartic_real(*(t(coef[:, k]) for k in range(4))).numpy()
    assert_close_nan(jq, tq, 1e-3, 1e-3)
    assert 0.2 < np.isnan(jq).mean() < 0.8


def test_kabsch_and_p3p_match_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(64, 5, 3))
    dst = src @ rng.normal(size=(3, 3)) + rng.normal(size=(64, 1, 3))
    Rj, tj = jkabsch(j(src), j(dst))
    Rt, tt = tkabsch(t(src), t(dst))
    np.testing.assert_allclose(Rj, Rt, atol=1e-4)
    np.testing.assert_allclose(tj, tt, atol=1e-4)

    from scipy.spatial.transform import Rotation
    X = rng.normal(size=(128, 3, 3)) * 2
    X[..., 2] += 6.0
    R_gt = Rotation.from_rotvec(rng.normal(size=(128, 3)) * 0.5).as_matrix()
    Xc = np.einsum("hij,hkj->hki", R_gt, X) + rng.normal(size=(128, 1, 3))
    f = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    Rj, tj, okj = (np.asarray(x) for x in jp3p(j(f), j(X)))
    Rt, tt, okt = (x.numpy() for x in tp3p(t(f), t(X)))
    # a solution's validity is a sign test of f32 depths, and in an
    # ill-conditioned sample the f32 closed forms (cbrt as a power, which
    # rounds differently) move a solution by more than 1e-4 (measured: 5
    # of 248, up to 1.7e-2, where JAX's own solution is up to 5e-2 off
    # the truth): count both
    flips = int((okj != okt).sum())
    both = okj & okt
    err = np.abs(Rj - Rt).max((-1, -2))[both]
    off = int((err > 1e-4).sum())
    print(f"p3p: {both.sum()} solutions valid in both, {flips} validity "
          f"flips, {off} beyond 1e-4 (max {err.max():.1e})")
    assert both.sum() > 128 and flips <= 2
    assert off <= 0.03 * both.sum()
    assert np.median(err) < 1e-5
    np.testing.assert_allclose(tj[both][err <= 1e-4], tt[both][err <= 1e-4],
                               atol=1e-3)


def test_root_finder_grid_is_jax_linspace():
    """The grid bit-equal to jnp.linspace under jit, where the JAX
    package's solvers build it (n_grid 256 on the estimator's path)."""
    import jax
    for n in (8, 16, 256):
        grid = np.asarray(jax.jit(
            lambda: jnp.linspace(-jnp.pi, jnp.pi, n + 1))())
        assert grid.dtype == np.float32
        assert np.array_equal(alpha_grid(n), grid), n


def _solver_inputs(kind, n, seed):
    rng = np.random.default_rng(seed)
    xs, Xs, ns, Ps, Vs = [], [], [], [], []
    for _ in range(n):
        R, tv = _random_pose(rng)
        P, V, nn, X, x = _make_scene(rng, R, tv)
        ns.append(nn), Ps.append(P), Vs.append(V), Xs.append(X), xs.append(x)
    xs, Xs, ns, Ps, Vs = map(np.asarray, (xs, Xs, ns, Ps, Vs))
    if kind == "p3ll":
        return (ns, Ps, Vs)
    if kind == "p1p2ll":
        return (xs[:, 0], Xs[:, 0], ns[:, :2], Ps[:, :2], Vs[:, :2])
    # two parallel 3D lines make a degenerate sample now and then
    return (xs, Xs, ns[:, 0], Ps[:, 0], Vs[:, 0])


@pytest.mark.parametrize("kind,n_roots", [("p3ll", 4), ("p1p2ll", 4),
                                          ("p2p1ll", 4), ("p3ll", 8)])
def test_pnl_root_sets_match_jax(kind, n_roots):
    """The same roots in the same slots: the validity flags equal, and a
    valid rotation within 1e-4 of JAX's where it comes from a grid sign
    change (bisection).  A root from the double-root branch is a minimum
    of G^2, flat to about sqrt(f32 eps) in alpha, so ternary search pins
    it only to ~1e-3: those are held within 2e-3, and the test counts the
    ones beyond 1e-4 (measured: at most 9 of 408)."""
    inputs = _solver_inputs(kind, 48, seed={"p3ll": 0, "p1p2ll": 1,
                                            "p2p1ll": 2}[kind])
    Rj, tj, okj = (np.asarray(x) for x in getattr(jpnl, kind)(
        *map(j, inputs), n_roots=n_roots))
    Rt, tt, okt = (x.numpy() for x in getattr(tpnl, kind)(
        *map(t, inputs), n_roots=n_roots))
    assert Rj.shape == Rt.shape and okj.shape == okt.shape
    assert np.array_equal(okj, okt)
    assert okj.sum() > 48
    # slots: per run, n_roots bisected roots then n_roots double roots
    double = (np.arange(okj.shape[1]) % (2 * n_roots) >= n_roots)[None]
    err = np.abs(Rj - Rt).max((-1, -2))
    simple = okj & ~double
    dbl = okj & double
    assert err[simple].max() <= 1e-4
    assert err[dbl].max() <= 2e-3
    loose = int((err[dbl] > 1e-4).sum())
    print(f"{kind} n_roots={n_roots}: {simple.sum()} bisected roots within "
          f"{err[simple].max():.1e}; {dbl.sum()} double roots, {loose} "
          f"beyond 1e-4 (max {err[dbl].max():.1e})")
    assert loose <= 0.05 * dbl.sum()
    scale = 1.0 + np.abs(tj[simple]).max()
    assert np.abs(tj[simple] - tt[simple]).max() <= 1e-3 * scale


def test_line2d_to_normal_matches_jax():
    rng = np.random.default_rng(3)
    kvec = np.array([400.0, 420.0, 320.0, 240.0])
    s, e = rng.uniform(0, 640, (2, 50, 2))
    np.testing.assert_allclose(
        jpnl.line2d_to_normal(j(s), j(e), j(kvec)),
        tpnl.line2d_to_normal(t(s), t(e), t(kvec)), atol=1e-6)
