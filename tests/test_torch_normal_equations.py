"""The port's plain LM normal equations (a vmapped ``torch.func.jvp``)
against the JAX LM program's ``terms`` (``jax.jacfwd`` through the
retraction at delta = 0, ``limap_tpu/optimize/lm.py:81-86``), on the same
numpy inputs: line BA and one localization config.  These are what
kernels H and I compute at their first iteration (their check entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.optimize import hybrid_localization as jhl
from limap_tpu.optimize import lm as jlm
from limap_tpu.optimize.line_ba import LineBAConfig as JBAConfig
from limap_tpu.optimize.line_ba import _build_ba_residual
from limap_tpu_torch.ops import lm_jointloc, lm_line_ba
from limap_tpu_torch.optimize.line_ba import LineBAConfig
from limap_tpu_torch.testing import lm_checks


def jax_terms(residual_one, retract_fn, D, params, aux):
    """J^T J, J^T r and sum r^2 of every row, as the JAX LM program's
    ``terms`` computes them."""

    def terms(p, *a):
        f = lambda delta: residual_one(retract_fn(p, delta), *a)
        zero = jnp.zeros((D,), p.dtype)
        J = jax.jacfwd(f)(zero)
        r = f(zero)
        return J.T @ J, J.T @ r, jnp.sum(r * r)

    return [torch.as_tensor(np.array(x))
            for x in jax.jit(jax.vmap(terms))(params, *aux)]


def as64(xs):
    return [x if x.dtype == torch.bool else x.double() for x in xs]


@pytest.mark.parametrize("loss", ["cauchy", "huber"])
def test_line_ba_normal_equations_match_jax(loss):
    params0, aux = lm_checks.seeded_line_ba(seed=3, T=12, S=10,
                                            device="cpu")
    ne_t = lm_line_ba.normal_equations(params0, *aux, LineBAConfig(loss=loss))
    ne_64 = lm_line_ba.normal_equations_plain(params0.double(), as64(aux),
                                              LineBAConfig(loss=loss))
    ne_j = jax_terms(_build_ba_residual(JBAConfig(loss=loss)),
                     jlm.retract_quat_so2, 4, jnp.asarray(params0.numpy()),
                     [jnp.asarray(x.numpy()) for x in aux])
    res = lm_checks.compare_normal_equations(ne_t, ne_j, ne_64)
    assert res["ok"] and res["finite_entries"] == 12 * 21, res
    # the zero-weight tracks (fewer than min_num_images views) add nothing
    zero = aux[5].sum(1) == 0
    assert zero.any() and (ne_t[0][zero] == 0).all()


def test_jointloc_normal_equations_match_jax():
    params0, data = lm_checks.seeded_jointloc(seed=4, T=4, device="cpu")
    cfg = dict(cost_function="2d_perpendicular_dist2",
               cost_function_weight="cosine", loss="huber", loss_scale=2.0)
    tcfg = lm_checks.loc_config(cfg["cost_function"],
                                cfg["cost_function_weight"], cfg["loss"],
                                1.0, 1.0)
    ne_t = lm_jointloc.normal_equations(params0, *data, tcfg)
    ne_64 = lm_jointloc.normal_equations_plain(params0.double(),
                                               as64(data), tcfg)
    T = params0.shape[0]
    j = lambda x: jnp.asarray(x.numpy())
    shared = lambda x: jnp.broadcast_to(j(x), (T,) + tuple(x.shape))
    l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv = data
    aux = [shared(l3s), shared(l3e), shared(l2s), shared(l2e), j(lmask),
           shared(p3), shared(p2), j(pmask), shared(kv)]
    ne_j = jax_terms(jhl._jointloc_residual(jhl.LineLocConfig(**cfg), True,
                                            True),
                     jlm.retract_pose, 6, j(params0), aux)
    res = lm_checks.compare_normal_equations(ne_t, ne_j, ne_64)
    assert res["ok"] and res["finite_entries"] == T * 43, res
