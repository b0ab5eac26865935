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
itself up to ~0.5 from the float64 one on this problem, ROADMAP §3).

The problem fixes pose 0 only, so the global scale is a gauge direction
that the damping alone holds.  GAUGE_RUN is CG in float64 on the same
problem with poses 0 and 1 fixed at their ground truth (phase 14's
``n_fixed_poses=2``): a 0.5 m baseline against scenes at 8 m, so the
scale is fixed but weakly, the near-gauge direction of phase 14's CG.

SHARES_RUN is GAUGE_RUN with each rank's g and diag0 summed as kernel
O's stage 2 adds them on the card, a group's supports cut into shares of
SHARE_REPLAY, each share summed and then the shares in order
(``limap_tpu_torch/testing/hybrid_checks.py::summed_in_shares``), held to
the one-process run in float64 as GAUGE_RUN is.  In float32 such an order
alone moves the two-rank CG lines by millimetres along the near-gauge
direction; in float64 it must not, so a gap here is a fault of the order
(a support dropped or added twice), not rounding."""

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
GAUGE_SOLVER = "cg two fixed poses"
GAUGE_RUN = (f"{GAUGE_SOLVER} f64", {"solver": "cg", "n_fixed_poses": 2},
             STEPS)
SHARES_SOLVER = f"{GAUGE_SOLVER} in shares"
SHARES_RUN = (f"{SHARES_SOLVER} f64", GAUGE_RUN[1], STEPS)
SHARE_REPLAY = 3          # supports a share: several shares a group here
COST_RTOL, COST_ATOL_SHARE, POSE_TOL, LINE_TOL = 5e-3, 1e-5, 1e-4, 1e-3


def _f64(x):
    return tuple(a.astype(np.float64) if a.dtype.kind == "f" else a
                 for a in x)


def problem(dtype, two_fixed=False):
    state, ld, pd, n_views, (qvecs, tvecs, _) = build_problem(
        np.random.default_rng(0))
    out = tuple(tuple(np.array(a) for a in x) for x in (state, ld, pd))
    if two_fixed:
        out[0][2][1] = np.concatenate([qvecs[1], tvecs[1]])
    if dtype == "f64":
        out = tuple(_f64(x) for x in out)
    return out + (n_views, 1)


def runs():
    return [(f"{name} {dt}", kw, STEPS) for name, kw in SOLVERS.items()
            for dt in ("f64", "f32")]


def all_runs():
    return runs() + [GAUGE_RUN]


def run_all(d):
    """The d-rank runs (each rank's), the one-process runs and JAX's
    d-device float32 runs, by run name."""
    problems = {dt: problem(dt) for dt in ("f64", "f32")}
    problems[GAUGE_RUN[0]] = problem("f64", two_fixed=True)

    def problem_of(name):
        return problems.get(name, problems.get(name.split()[-1]))

    ranks = multirank.start(multirank.jobs, d, ([
        (multirank.ba_steps, (problem_of(name), [(name, kw, n)]))
        for name, kw, n in all_runs()] + [
        (multirank.ba_steps_in_shares, (problems[GAUGE_RUN[0]],
                                        [SHARES_RUN], SHARE_REPLAY))],))
    one = {}
    for name, kw, n in all_runs():
        one.update(multirank.ba_steps(0, 1, problem_of(name),
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
    for name, _, _ in all_runs() + [SHARES_RUN]:
        ref = merged[0][name]
        for r in merged[1:]:
            assert r[name]["costs"] == ref["costs"], name
            for sa, sb in zip(ref["states"], r[name]["states"]):
                assert all(np.array_equal(a, b) for a, b in zip(sa, sb)), \
                    name
            assert r[name]["cost_fn"] == ref["cost_fn"], name


def check_trajectory_float64(merged, one, solver):
    """The d-rank run of ``solver`` against the one-process run in
    float64 (SHARES_SOLVER's against GAUGE_RUN's)."""
    name = f"{solver} f64"
    got = merged[0][name]
    ref = one[GAUGE_RUN[0] if solver == SHARES_SOLVER else name]
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


def report(d=2):
    """Print, for each run, how far the d-rank run's last state is from
    the one-process run's (poses, lines, points, the largest absolute
    difference), and the one-process CG run's poses from the dense
    solve's.

        JAX_PLATFORMS=cpu python -m tests.torch_parallel_checks
    """
    merged, one, _, _ = run_all(d)
    for name, _, _ in all_runs() + [SHARES_RUN]:
        ref = one[GAUGE_RUN[0] if name == SHARES_RUN[0] else name]
        (l1, p1, q1, _), (ld, pd, qd, _) = (ref["states"][-1],
                                            merged[0][name]["states"][-1])
        print(f"{name}: {d} ranks against one process: poses "
              f"{np.abs(qd - q1).max():.3e}, lines {np.abs(ld - l1).max():.3e}"
              f", points {np.abs(pd - p1).max():.3e}")
    for dt in ("f64", "f32"):
        a = one[f"dense {dt}"]["states"][-1][2]
        b = one[f"cg {dt}"]["states"][-1][2]
        print(f"one process, CG against dense {dt}: poses "
              f"{np.abs(a - b).max():.3e}")


if __name__ == "__main__":
    report()
