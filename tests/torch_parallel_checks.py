"""Shared runs of the multi-card BA tests (``test_torch_parallel_ba*.py``):
the port's step over d gloo ranks on the CPU against its one-process run
and JAX's d-device mesh, on ``tests/test_sharded_ba.py::build_problem``.

d ranks are started first (``limap_tpu_torch/testing/multirank.py``) and
run while this process computes the port's one-process run and JAX's.
Each run takes STEPS steps from the same state in float64 and in
float32.  Tolerances: the d-rank trajectory against the one-process one
in float64 as JAX's own multi-chip parity (``tests/test_multichip_parity.py
::test_distributed_ba_trajectory_matches_single_device``); in float32 the
port's d-rank run may be no farther from the port's float64 run than
twice JAX's d-device float32 run is, plus 1e-4 (JAX's float32 step is
itself up to ~0.5 from the float64 one on this problem, ROADMAP §3)."""

import numpy as np
import jax.numpy as jnp

from limap_tpu.parallel import HybridBAOptions as JaxOptions
from limap_tpu.parallel import HybridBAState as JaxState
from limap_tpu.parallel import make_hybrid_ba_cost as jax_cost
from limap_tpu.parallel import make_hybrid_ba_step as jax_step
from limap_tpu.parallel import make_mesh as jax_mesh
from limap_tpu_torch.testing import multirank
from tests.test_sharded_ba import build_problem

STEPS = 10
SOLVERS = {"dense": {"solver": "dense"}, "cg": {"solver": "cg"}}
COST_RTOL, COST_ATOL_SHARE, POSE_TOL, LINE_TOL = 5e-3, 1e-5, 1e-4, 1e-3


def _f64(x):
    return tuple(a.astype(np.float64) if a.dtype.kind == "f" else a
                 for a in x)


def problem(dtype):
    state, ld, pd, n_views, _ = build_problem(np.random.default_rng(0))
    out = tuple(tuple(np.array(a) for a in x) for x in (state, ld, pd))
    if dtype == "f64":
        out = tuple(_f64(x) for x in out)
    return out + (n_views, 1)


def runs():
    return [(f"{name} {dt}", kw, STEPS) for name, kw in SOLVERS.items()
            for dt in ("f64", "f32")]


def run_all(d):
    """The d-rank runs (each rank's), the one-process runs and JAX's
    d-device float32 runs, by run name."""
    problems = {dt: problem(dt) for dt in ("f64", "f32")}
    ranks = multirank.start(multirank.jobs, d, ([
        (multirank.ba_steps, (problems[dt], [(name, kw, n)]))
        for name, kw, n in runs() for dt in [name.split()[1]]],))
    one = {}
    for name, kw, n in runs():
        one.update(multirank.ba_steps(0, 1, problems[name.split()[1]],
                                      [(name, kw, n)]))
    state, ld, pd, n_views, _ = problems["f32"]
    mesh = jax_mesh(d)
    jx = {}
    for name, kw in SOLVERS.items():
        step = jax_step(mesh, n_views, 1, JaxOptions(**kw))
        s = JaxState(*map(jnp.asarray, state))
        states, costs = [], []
        for _ in range(STEPS):
            s, c = step(s, tuple(map(jnp.asarray, ld)),
                        tuple(map(jnp.asarray, pd)))
            states.append(tuple(np.array(a) for a in s))
            costs.append(float(c))
        jx[name] = {"states": states, "costs": costs}
    jc = float(jax_cost(mesh, JaxOptions())(
        JaxState(*map(jnp.asarray, state)), tuple(map(jnp.asarray, ld)),
        tuple(map(jnp.asarray, pd))))
    per_rank = ranks.join(timeout_s=240)
    merged = [{k: v for job in r for k, v in job.items()} for r in per_rank]
    return merged, one, jx, jc


def check_ranks_agree(merged):
    """Every rank ends every step with the same state, bit for bit."""
    for name, _, _ in runs():
        ref = merged[0][name]
        for r in merged[1:]:
            assert r[name]["costs"] == ref["costs"], name
            for sa, sb in zip(ref["states"], r[name]["states"]):
                assert all(np.array_equal(a, b) for a, b in zip(sa, sb)), \
                    name
            assert r[name]["cost_fn"] == ref["cost_fn"], name


def check_trajectory_float64(merged, one, solver):
    name = f"{solver} f64"
    got, ref = merged[0][name], one[name]
    c1, cd = np.asarray(ref["costs"]), np.asarray(got["costs"])
    assert np.allclose(cd, c1, rtol=COST_RTOL, atol=COST_ATOL_SHARE * c1[0])
    (l1, _, q1, _), (ld_, _, qd, _) = ref["states"][-1], got["states"][-1]
    assert np.abs(qd - q1).max() <= POSE_TOL
    assert np.abs(ld_ - l1).max() <= LINE_TOL
    # the steps descend
    assert c1[-1] < 1e-3 * c1[0]


def check_float32_within_jax_error(merged, jx, solver):
    port32 = merged[0][f"{solver} f32"]["states"]
    port64 = merged[0][f"{solver} f64"]["states"]
    for p, j, ref in zip(port32, jx[solver]["states"], port64):
        for a, b, c in zip(p, j, ref):
            assert np.abs(a - c).max() <= 2 * np.abs(b - c).max() + 1e-4


def check_cost(merged, one, jc):
    """The cost function over the ranks: the one-process value in
    float64, JAX's d-device value in float32, at every state."""
    for solver in SOLVERS:
        got = np.asarray(merged[0][f"{solver} f64"]["cost_fn"])
        ref = np.asarray(one[f"{solver} f64"]["cost_fn"])
        # the same state: the same cost up to the order of the sum
        assert abs(got[0] - ref[0]) <= 1e-12 * ref[0]
        # the states of the two trajectories: as the step's costs
        assert np.allclose(got, ref, rtol=COST_RTOL,
                           atol=COST_ATOL_SHARE * ref[0])
        # the step's own cost is the cost function at the state it left
        assert np.allclose(merged[0][f"{solver} f64"]["costs"], got[:-1],
                           rtol=1e-9)
    c32 = merged[0]["dense f32"]["cost_fn"][0]
    assert abs(c32 - jc) <= 1e-5 * abs(jc)


def check_collectives(merged):
    """One all_reduce and one all_gather a dense step; a CG step adds one
    all_reduce a product; the bytes are the summed system's and the
    gathered landmarks'."""
    state, ld, pd, n_views, _ = problem("f32")
    D = 6 * n_views
    rows = state[0].shape[0] * 6 + state[1].shape[0] * 3
    for dt, size in (("f64", 8), ("f32", 4)):
        dense = merged[0][f"dense {dt}"]["collectives"]
        assert dense["calls"] == {"all_reduce": STEPS, "all_gather": STEPS}
        assert dense["bytes"] == {
            "all_reduce": STEPS * (D * D + D + 1) * size,
            "all_gather": STEPS * rows * size}
        cg = merged[0][f"cg {dt}"]["collectives"]
        products = cg["calls"]["all_reduce"] - STEPS
        assert 0 < products <= STEPS * JaxOptions().cg_iters
        assert cg["bytes"]["all_reduce"] == (
            STEPS * (2 * D + 1) + products * D) * size
