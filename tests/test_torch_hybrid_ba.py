"""The hybrid bundle adjustment's step and cost: the JAX package on a
one-device CPU mesh against the port on the CPU (the plain versions of
kernels O, P and Q), from the same seeded numpy inputs
(``tests/test_sharded_ba.py::build_problem`` at a small size).

The step is held to JAX in float64, where both packages compute the same
formula: a float32 step on this scene is ill-conditioned (landmark blocks
with condition numbers up to 4e5, a Schur complement of two terms of
nearly equal size), so both packages' float32 steps land up to ~0.5 from
the float64 one.  In float32 the port's step must be no farther from
JAX's float64 step than twice JAX's own float32 step is, plus 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.parallel import HybridBAOptions as JaxOptions
from limap_tpu.parallel import make_hybrid_ba_cost as jax_cost
from limap_tpu.parallel import make_hybrid_ba_step as jax_step
from limap_tpu.parallel import make_mesh
from limap_tpu_torch import convert
from limap_tpu_torch.parallel import (HybridBAOptions, make_hybrid_ba_cost,
                                      make_hybrid_ba_step)
from tests.test_sharded_ba import build_problem
from torch_threads import two_torch_threads  # noqa: F401

OPTIONS = {
    "dense": {},
    "cg": {"solver": "cg"},
    "optimize_focal": {"optimize_focal": True},
    "constant_pose": {"constant_pose": True},
    "constant_line": {"constant_line": True},
    "constant_point": {"constant_point": True},
}
FLOAT32 = ("dense", "cg")


def _numpy(x):
    return tuple(np.array(a) for a in x)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    state, ld, pd, n_views, _ = build_problem(rng, n_views=5, n_tracks=6,
                                              n_points=6)
    return _numpy(state), _numpy(ld), _numpy(pd), n_views


def _f64(x):
    return tuple(a.astype(np.float64) if a.dtype.kind == "f" else a
                 for a in x)


@pytest.fixture(scope="module")
def jax_steps(scene):
    """Each option's JAX step, run once in float64 and once in float32."""
    state, ld, pd, n_views = scene
    mesh = make_mesh(1)
    out = {}

    def run(name, f):
        step = jax_step(mesh, n_views, 1, JaxOptions(**OPTIONS[name]))
        from limap_tpu.parallel import HybridBAState
        s, c = step(HybridBAState(*map(jnp.asarray, f(state))),
                    tuple(map(jnp.asarray, f(ld))),
                    tuple(map(jnp.asarray, f(pd))))
        return _numpy(s), float(c)

    for name in OPTIONS:
        with jax.enable_x64(True):
            out[name, 64] = run(name, _f64)
        if name in FLOAT32:
            out[name, 32] = run(name, lambda x: x)
    return out


def _port_step(scene, name, f):
    state, ld, pd, n_views = scene
    step = make_hybrid_ba_step(None, n_views, 1,
                               HybridBAOptions(**OPTIONS[name]),
                               device="cpu")
    st = convert.hybrid_ba_state(
        type("S", (), dict(zip(("line_params", "point_params",
                                "pose_params", "cam_fxfy"), f(state)))),
        device="cpu")
    s, c = step(st, convert.hybrid_ba_data(f(ld), "cpu"),
                convert.hybrid_ba_data(f(pd), "cpu"))
    return tuple(a.numpy() for a in s), float(c)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_step_matches_jax_in_float64(scene, jax_steps, name):
    (lines, points, poses, fxfy), cost = _port_step(scene, name, _f64)
    (jl, jp, jq, jf), jc = jax_steps[name, 64]
    assert np.abs(poses - jq).max() <= 1e-4
    assert _rel(lines, jl) <= 1e-4
    assert _rel(points, jp) <= 1e-4
    assert _rel(fxfy, jf) <= 1e-4
    assert abs(cost - jc) <= 1e-5 * abs(jc)
    # the step moved the state well beyond those tolerances
    state = scene[0]
    assert np.abs(poses - state[2]).max() > 1e-2 or name == "constant_pose"


@pytest.mark.parametrize("name", FLOAT32)
def test_float32_step_no_farther_from_float64_than_jax(scene, jax_steps,
                                                       name):
    port, cost = _port_step(scene, name, lambda x: x)
    jax32, jc32 = jax_steps[name, 32]
    jax64, _ = jax_steps[name, 64]
    for p, j32, j64 in zip(port, jax32, jax64):
        assert np.abs(p - j64).max() <= 2 * np.abs(j32 - j64).max() + 1e-4
    assert abs(cost - jc32) <= 1e-5 * abs(jc32)


def test_cost_matches_jax(scene):
    state, ld, pd, _ = scene
    from limap_tpu.parallel import HybridBAState
    for kw in ({}, {"loss": "huber"}, {"loss": "trivial", "lw_point": 0.5}):
        jc = float(jax_cost(make_mesh(1), JaxOptions(**kw))(
            HybridBAState(*map(jnp.asarray, state)),
            tuple(map(jnp.asarray, ld)), tuple(map(jnp.asarray, pd))))
        pc = float(make_hybrid_ba_cost(None, HybridBAOptions(**kw),
                                       device="cpu")(
            convert.hybrid_ba_state(HybridBAState(*state), "cpu"),
            convert.hybrid_ba_data(ld, "cpu"),
            convert.hybrid_ba_data(pd, "cpu")))
        assert abs(pc - jc) <= 1e-5 * abs(jc), kw


def test_ragged_weights_and_a_track_without_supports(scene):
    """Zero-weight slots and a track with none contribute nothing: the
    port's step equals its step on the tracks without them."""
    state, ld, pd, n_views = scene
    ld_w = list(ld)
    w = ld_w[-1].copy()
    w[0] = 0.0
    w[1, ::2] = 0.0
    ld_w[-1] = w
    step = make_hybrid_ba_step(None, n_views, 1, HybridBAOptions(),
                               device="cpu")
    st = convert.hybrid_ba_state(
        type("S", (), dict(zip(("line_params", "point_params",
                                "pose_params", "cam_fxfy"), state))), "cpu")
    s_all, _ = step(st, convert.hybrid_ba_data(ld_w, "cpu"),
                    convert.hybrid_ba_data(pd, "cpu"))
    keep = slice(1, None)
    st_cut = st._replace(line_params=st.line_params[keep])
    ld_cut = tuple(a[keep] for a in ld_w)
    s_cut, _ = step(st_cut, convert.hybrid_ba_data(ld_cut, "cpu"),
                    convert.hybrid_ba_data(pd, "cpu"))
    assert torch.allclose(s_all.pose_params, s_cut.pose_params, atol=1e-5)
    # the track without supports keeps its line exactly (a zero update)
    assert torch.equal(s_all.line_params[0], st.line_params[0])


@pytest.mark.parametrize("kind", ["line", "point"])
def test_factor_product_equals_the_schur_blocks_product(scene, kind):
    """Kernel P's plain version applies the reduced matrix from the
    factors (H_cl, H_ll^-1, H_cc); JAX's _matvec applies the stored Schur
    blocks S_red [T, S, S, Dc, Dc]: the same product (float64)."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import sharded_ba as sb
    state, ld, pd, n_views = scene
    st = [torch.as_tensor(a).double() for a in _f64(state)]
    data = [torch.as_tensor(a) for a in _f64(ld if kind == "line" else pd)]
    opts = HybridBAOptions(optimize_focal=True)
    land = st[0] if kind == "line" else st[1]
    obs = tuple(data[3:-1])
    terms = O.hybrid_terms_plain(kind, land, st[2], st[3], data[0],
                                 data[1], data[2], obs, data[-1], opts,
                                 torch.tensor(1e-3, dtype=torch.float64),
                                 n_views, 1, True)
    fn = sb._line_track_terms if kind == "line" else sb._point_track_terms
    _, Hd, Sr, *_ = fn(land, st[2], st[3], data[0], data[1], data[2], *obs,
                       data[-1], opts, torch.tensor(1e-3, dtype=torch.float64))
    v = torch.as_tensor(np.random.default_rng(0).normal(
        size=terms.g.shape[0]))
    ref = sb._matvec(v, terms.cols, Hd, Sr)
    out = O.hybrid_apply_plain(terms, v)
    assert torch.allclose(out, ref, rtol=1e-9, atol=1e-9 * ref.abs().max())
    # and the dense matrix's product is the same
    assert torch.allclose(terms.Hp @ v, ref, rtol=1e-9,
                          atol=1e-9 * ref.abs().max())
