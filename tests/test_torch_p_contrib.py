"""Kernel P's product as the kernel computes it, replayed in torch on the
CPU (``ops/hybrid_ba.py::apply_from_contributions``): stage 1 writes
each weighted support's contribution H_cc v[cols] - H_cl y_t, stage 2
sums a group's supports in ``SPLIT`` shares of consecutive supports and
adds the shares in order.  The replay is held to the JAX package's
``_matvec`` (the stored Schur blocks) on the same terms, in float64 where
both compute the same formula (within 1e-9 of the product's largest
entry), for each kind, with and without the focal lengths, with slots of
weight 0, and for both kinds' sum.  ``hybrid_apply_both`` on the CPU is
the sum of the two kinds' plain products bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.parallel import HybridBAOptions as JaxOptions
from limap_tpu.parallel import sharded_ba as jsb
from limap_tpu_torch.ops import hybrid_ba as O
from limap_tpu_torch.parallel import HybridBAOptions
from tests.test_sharded_ba import build_problem
from torch_threads import two_torch_threads  # noqa: F401

N_VIEWS = 5


@pytest.fixture(scope="module")
def scene():
    """Lines and points seen by every view, 40 points (a group of more
    supports than shares), a few slots of weight 0."""
    rng = np.random.default_rng(2)
    state, ld, pd, n_views, _ = build_problem(rng, n_views=N_VIEWS,
                                              n_tracks=7, n_points=40)
    state = tuple(np.asarray(a, np.float64) for a in state)
    ld = [np.array(a) for a in ld]
    pd = [np.array(a) for a in pd]
    for data in (ld, pd):
        w = data[-1].astype(np.float64).copy()
        w[rng.random(w.shape) < 0.2] = 0.0
        data[-1] = w
    f64 = lambda d: tuple(a.astype(np.float64) if a.dtype.kind == "f"
                          else a for a in d)
    return state, f64(ld), f64(pd)


def port_terms(scene, kind, focal, dtype=torch.float64):
    state, ld, pd = scene
    st = [torch.as_tensor(a).to(dtype) for a in state]
    data = [torch.as_tensor(a) for a in (ld if kind == "line" else pd)]
    data = [d.to(dtype) if d.dtype.is_floating_point else d for d in data]
    land = st[0] if kind == "line" else st[1]
    return O.hybrid_terms_plain(
        kind, land, st[2], st[3], data[0], data[1], data[2],
        tuple(data[3:-1]), data[-1], HybridBAOptions(optimize_focal=focal),
        torch.tensor(1e-3, dtype=dtype), N_VIEWS, 1, True)


_JAX_TERMS = {}


def jax_matvec(scene, kind, focal, v):
    """JAX's _matvec from its own per-track Schur terms (vmapped, built
    once a kind and option), in float64."""
    state, ld, pd = scene
    opts = JaxOptions(optimize_focal=focal)
    with jax.enable_x64(True):
        if (kind, focal) not in _JAX_TERMS:
            lines, points, poses, fxfy = map(jnp.asarray, state)
            data = tuple(map(jnp.asarray, ld if kind == "line" else pd))
            if kind == "line":
                fn = lambda lp, kv, ci, ii, ls, le, w: jsb._line_track_terms(
                    lp, poses, fxfy, kv, ci, ii, ls, le, w, opts, 1e-3)
                terms = jax.jit(jax.vmap(fn))(lines, *data)
            else:
                fn = lambda x, kv, ci, ii, pp, w: jsb._point_track_terms(
                    x, poses, fxfy, kv, ci, ii, pp, w, opts, 1e-3)
                terms = jax.jit(jax.vmap(fn))(points, *data)
            cols = jax.vmap(lambda ii, ci: jsb._cols_for(ii, ci, N_VIEWS,
                                                         opts))(data[2],
                                                                data[1])
            _JAX_TERMS[kind, focal] = (cols, terms[1], terms[2])
        cols, Hd, Sr = _JAX_TERMS[kind, focal]
        return np.asarray(jsb._matvec(jnp.asarray(v), cols, Hd, Sr))


def seeded_v(D, seed=0):
    return np.random.default_rng(seed).normal(size=D)


def assert_product(got, ref):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("focal", [False, True], ids=["poses", "focal"])
@pytest.mark.parametrize("kind", ["line", "point"])
def test_contributions_replay_matches_jax_matvec(scene, kind, focal):
    terms = port_terms(scene, kind, focal)
    v = seeded_v(terms.g.shape[0])
    got = O.apply_from_contributions(terms, torch.as_tensor(v))
    assert_product(got, jax_matvec(scene, kind, focal, v))
    # the groups of the points hold more supports than shares
    if kind == "point":
        grp_ptr = O.group_index(terms.img, terms.cam, terms.weight,
                                N_VIEWS, 1, focal)[0]
        assert int((grp_ptr[1:] - grp_ptr[:-1]).max()) > O.SPLIT


@pytest.mark.parametrize("focal", [False, True], ids=["poses", "focal"])
def test_both_kinds_replay_matches_the_sum_of_jax_products(scene, focal):
    tl, tp = (port_terms(scene, k, focal) for k in ("line", "point"))
    v = seeded_v(tl.g.shape[0], seed=1)
    vt = torch.as_tensor(v)
    got = O.apply_from_contributions(tl, vt) \
        + O.apply_from_contributions(tp, vt)
    ref = jax_matvec(scene, "line", focal, v) \
        + jax_matvec(scene, "point", focal, v)
    assert_product(got, ref)


@pytest.mark.parametrize("focal", [False, True], ids=["poses", "focal"])
def test_contributions_skip_unweighted_slots(scene, focal):
    """A slot of weight 0 contributes nothing, and y sums the weighted
    supports alone: changing the factors of unweighted slots moves
    nothing."""
    terms = port_terms(scene, "point", focal)
    v = torch.as_tensor(seeded_v(terms.g.shape[0], seed=2))
    dead = terms.weight <= 0
    assert dead.any()
    y, c = O.contributions(terms, v)
    assert torch.equal(c[dead], torch.zeros_like(c[dead]))
    moved = terms._replace(H_cl=torch.where(dead[..., None, None], 7.0,
                                            terms.H_cl),
                           H_cc=torch.where(dead[..., None, None], -3.0,
                                            terms.H_cc))
    y2, c2 = O.contributions(moved, v)
    assert torch.equal(y, y2) and torch.equal(c, c2)
    assert torch.equal(O.apply_from_contributions(terms, v),
                       O.apply_from_contributions(moved, v))


@pytest.mark.parametrize("focal", [False, True], ids=["poses", "focal"])
def test_hybrid_apply_both_on_the_cpu_is_the_sum_bit_for_bit(scene, focal):
    tl, tp = (port_terms(scene, k, focal, torch.float32)
              for k in ("line", "point"))
    v = torch.as_tensor(seeded_v(tl.g.shape[0], seed=3), dtype=torch.float32)
    n0 = O.hybrid_apply.launches
    both = O.hybrid_apply_both(tl, tp, v)
    assert torch.equal(both, O.hybrid_apply(tl, v) + O.hybrid_apply(tp, v))
    assert torch.equal(both, O.hybrid_apply_both_plain(tl, tp, v))
    assert O.hybrid_apply.launches == n0   # the plain version launches none


def test_hybrid_apply_both_refuses_terms_of_other_systems(scene):
    tl = port_terms(scene, "line", False, torch.float32)
    tp = port_terms(scene, "point", True, torch.float32)
    v = torch.zeros(tl.g.shape[0], device="cpu")
    with pytest.raises(ValueError):
        O.hybrid_apply_both(tl, tl, v.to("meta"))
    with pytest.raises(ValueError):
        O.hybrid_apply_both(tl, tp, v.to("meta"))
