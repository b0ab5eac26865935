"""The LM kernels held to their plain versions: kernel H (line BA,
``ops/lm_line_ba.py``) and kernel I (the joint point+line pose solve,
``ops/lm_jointloc.py``).  ``chip_smoke.py`` (phases 2, 4, 7, 8 and 10)
and ``tests/test_torch_cuda.py`` share these inputs and comparisons;
``tests/test_torch_lm_checks.py`` runs them on the CPU, against the plain
version itself and against faults.

    python -m limap_tpu_torch.testing.lm_checks

builds both kernels on one GPU and prints each comparison.

Both kernels follow the plain version's formulas operation for
operation, but their sums run in another order than torch's and the
card rounds its transcendentals and fused products its own way, so two
things are compared apart:

- the normal equations at ``params0`` (the check entry, 0 iterations):
  every finite entry of J^T J, J^T r and the cost within ``NE_RTOL`` of
  its scale (sqrt(J^T J_ii J^T J_jj), sqrt(J^T J_ii cost), cost), or
  within four times the plain float32 value's own error against
  float64 where that is larger, and J^T r and the cost also within four
  times what the row's residual noise moves them by (the largest
  |float32 - float64| residual eps of the plain version at params0: J^T
  r_i by sqrt(J^T J_ii R) eps, the cost by 2 sqrt(cost R) eps + R eps^2;
  noise-free inputs leave residuals that are rounding alone); NaN and
  infinities at the same places with the same signs.  Under
  ``line3dpp`` a row's tolerance is at least four times u c / (1 - c^2)
  for the largest float64 |cos| c of its masked lines: one ulp u of c
  moves arccos' = -1 / sqrt(1 - c^2) by that share, so near |cos| = 1
  no float32 evaluation does better;
- the solve, row by row, with no share of rows left out: the accept
  sequences equal, then the final parameters within ``PARAM_TOL`` (of
  max(1, |p|)), the final cost (and the first) within ``COST_RTOL`` or
  four times the residual noise's share as above, and the accepts
  counted alike; or the sequences part at a first iteration where each
  side's decision is witnessed in float64 on the CPU from that side's
  own state (the states agree up to the rounding carried through the
  earlier, equal, decisions).  A side is witnessed when it took the
  decision of the whole step taken in float64 from its state, or, where
  it did not, when the decision lies within float32's resolution:
  (a) a near tie: |new cost - cost| in float64 at the side's own step
      within the float32 rounding bound of the two sums (the largest of
      gamma_R (cost + new cost), four times the plain float32 error of
      the two at the same points, and what the plain residuals' own
      float32 error at those points can move the two sums by; R the
      row's residual count);
  (b) an unsure step: the float64 step's gain new cost - cost within
      four times the plain float32 step's own error of that gain, from
      the same state;
  (c) a singular point: the side's step was zeroed (a non-finite
      Jacobian) at a state where float64 puts a masked line's |cos|
      within rounding of 1 under ``line3dpp``.
  A parted row must end at a cost no higher than plain's plus its
  tolerance, or else have every later decision of the kernel witnessed
  the same way from the kernel's own states (after a parting in a flat
  valley the two runs are different valid float32 LM runs, and the one
  that raised its damping may stop where float32 resolves no further
  decrease), unless one side stalled at a singular point (c): the plain
  version's own arithmetic stops that row, and only its witness is
  required.

The operation counts of both kernels (``ops_line_ba``, ``ops_jointloc``)
are counted by hand from their sources: a Jet<D> operation counts D + 1,
each value once at the coarsest index it depends on.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from limap_tpu_torch.optimize import lm

# plain's own float32 normal equations reach 1.4e-4 of the scale against
# float64 on the seeded BA input (on a CPU)
NE_RTOL = 1e-3
PARAM_TOL = 1e-3
COST_RTOL = 1e-3
# a cosine within this of 1 is 1 to float32 (16 ulps at 1)
COS_TOL = 1e-6
U32 = 2.0 ** -24


# ------------------------------------------------------- comparisons
def _finite_pattern_equal(a, b):
    """NaN and +-inf at the same places with the same signs."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.isposinf(a), torch.isposinf(b))
                and torch.equal(torch.isneginf(a), torch.isneginf(b)))


def ne_scales(JTJ, JTr, cost):
    """Each entry's scale: sqrt(J^T J_ii J^T J_jj), sqrt(J^T J_ii cost)
    and the cost (the Cauchy-Schwarz bounds of the entries)."""
    d = torch.diagonal(JTJ, dim1=-2, dim2=-1).abs()
    c = cost.abs()
    return (torch.sqrt(d[:, :, None] * d[:, None, :]),
            torch.sqrt(d * c[:, None]), c)


def cost_noise(cost, R, eps):
    """What residual noise eps (each of R residuals) moves a cost by."""
    cost, R, eps = (np.asarray(x, np.float64) for x in (cost, R, eps))
    return 2 * np.sqrt(np.abs(cost) * R) * eps + R * eps * eps


def compare_normal_equations(ne_k, ne_p, ne_64, row_rtol=None, noise=None):
    """The kernel's (J^T J, J^T r, cost) at params0 against plain's,
    both float32, with plain's float64 counterpart for its own error;
    ``row_rtol`` [T] raises a row's relative tolerance above
    ``NE_RTOL``; ``noise`` = (R [T], eps [T]) the rows' residual counts
    and residual noise."""
    ne_k = [x.detach().cpu().double() for x in ne_k]
    ne_p = [x.detach().cpu().double() for x in ne_p]
    ne_64 = [x.detach().cpu().double() for x in ne_64]
    T = ne_p[2].shape[0]
    rtol = torch.full((T,), NE_RTOL, dtype=torch.float64)
    if row_rtol is not None:
        rtol = torch.maximum(rtol, torch.as_tensor(row_rtol).double())
    floors = [torch.zeros_like(x) for x in ne_p]
    if noise is not None:
        R, eps = (torch.as_tensor(np.asarray(x, np.float64)) for x in noise)
        diag = torch.diagonal(ne_p[0], dim1=-2, dim2=-1).abs()
        floors[1] = torch.sqrt(diag * R[:, None]) * eps[:, None]
        floors[2] = torch.as_tensor(cost_noise(ne_p[2].numpy(), R, eps))
    pattern = all(_finite_pattern_equal(a, b) for a, b in zip(ne_k, ne_p))
    worst, rel, n_fin = 0.0, 0.0, 0
    for k, p, q, s, f in zip(ne_k, ne_p, ne_64, ne_scales(*ne_p), floors):
        fin = torch.isfinite(k) & torch.isfinite(p)
        if not fin.any():
            continue
        r = rtol.reshape((T,) + (1,) * (k.dim() - 1)).expand_as(k)[fin]
        k, p, q, s, f = k[fin], p[fin], q[fin], s[fin], f[fin]
        own = torch.nan_to_num((p - q).abs(), nan=0.0, posinf=0.0)
        tol = torch.maximum(r * torch.nan_to_num(s, posinf=0.0),
                            4 * torch.maximum(own, torch.nan_to_num(f)))
        err = (k - p).abs()
        over = err > tol
        if over.any():
            worst = max(worst, float((err[over] / tol[over]).max()))
        rel = max(rel, float((err / torch.clamp(s, min=1e-30)).max()))
        n_fin += int(fin.sum())
    bad = ~torch.isfinite(ne_p[2]) | ~torch.isfinite(ne_p[0]).flatten(1).all(1)
    return {"rows": T, "finite_entries": n_fin,
            "nonfinite_rows": int(bad.sum()), "pattern_equal": pattern,
            "max_rel_err": rel, "max_err_over_tol": worst,
            "rows_above_ne_rtol": int((rtol > NE_RTOL).sum()),
            "ok": pattern and worst == 0.0}


def accepts(trace):
    """[T, n_iter] accept flags of a trace (new cost < cost)."""
    return trace[..., 1] < trace[..., 0]


def lambdas(acc):
    """[T, n_iter] float32 damping before each iteration, replayed from
    the accept flags as the kernels and ``lm_solve`` update it."""
    init, up, down, lo, hi = (np.float32(x) for x in lm.LAMBDAS)
    acc = np.asarray(acc)
    lam = np.full(acc.shape[0], init, np.float32)
    out = np.empty(acc.shape, np.float32)
    for i in range(acc.shape[1]):
        out[:, i] = lam
        lam = np.clip(np.where(acc[:, i], lam * down, lam * up), lo, hi)
    return out


def tie_margin(cost32, new32, cost64, new64, R, noise=0.0):
    """|new - cost| in float64 over the float32 rounding bound of the two
    sums: the largest of gamma_R (cost + new), 4 (|cost32 - cost64| +
    |new32 - new64|) and ``noise``, what the residuals' own float32
    error can move the two by.  <= 1 is a near tie."""
    g = R * U32 / (1 - R * U32)
    err = np.abs(cost32 - cost64) + np.abs(new32 - new64)
    bound = np.maximum(np.maximum(g * (np.abs(cost64) + np.abs(new64)),
                                  4 * err), noise)
    gap = np.abs(new64 - cost64)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.where(gap <= bound, 0.0, gap / bound)
    return np.nan_to_num(m, nan=np.inf)


class RowProblem:
    """The plain residual of some rows on the CPU in float32 and float64:
    their costs and residual noise at given parameters, and one LM step.
    ``aux`` as the plain residual takes it; the indices in ``shared``
    are data common to all rows (a leading [1]), the rest per row."""

    def __init__(self, residual_fn, retract_fn, D, aux, shared=()):
        self.f, self.retract, self.D = residual_fn, retract_fn, D
        self.aux = [t.detach().cpu() for t in aux]
        self.shared = shared

    def _aux(self, rows, dtype):
        idx = torch.as_tensor(np.asarray(rows))
        aux = [t if i in self.shared else t[idx]
               for i, t in enumerate(self.aux)]
        return [x if x.dtype == torch.bool else x.to(dtype) for x in aux]

    def cost(self, rows, params, dtype):
        p = torch.as_tensor(np.asarray(params)).to(dtype)
        return torch.sum(self.f(p, *self._aux(rows, dtype)) ** 2,
                         1).double().numpy()

    def noise(self, rows, params):
        """Each row's largest |float32 - float64| residual at ``params``."""
        p = torch.as_tensor(np.asarray(params))
        r32 = self.f(p.float(), *self._aux(rows, torch.float32)).double()
        r64 = self.f(p.double(), *self._aux(rows, torch.float64))
        return torch.nan_to_num((r32 - r64).abs(), nan=0.0).amax(1).numpy()

    def costs(self, rows, params):
        """(float32, float64) costs [n] of ``rows`` at ``params``."""
        return (self.cost(rows, params, torch.float32),
                self.cost(rows, params, torch.float64))

    def step(self, rows, params, lam, dtype):
        """One LM step from ``params`` with damping ``lam``, as lm_solve
        takes it, in ``dtype``: (cost, new cost) [n] as float64."""
        aux = self._aux(rows, dtype)
        p = torch.as_tensor(np.asarray(params)).to(dtype)
        JTJ, JTr, cost = lm.normal_equations(p, self.f, self.retract,
                                             self.D, aux)
        diag = torch.diagonal(JTJ, dim1=-2, dim2=-1)
        lam = torch.as_tensor(np.asarray(lam)).to(dtype)
        A = JTJ + torch.diag_embed(lam[:, None]
                                   * torch.clamp(diag, min=1e-8))
        delta = torch.nan_to_num(-lm.solve_spd(A, JTr))
        new = torch.sum(self.f(self.retract(p, delta), *aux) ** 2, 1)
        return cost.double().numpy(), new.double().numpy()


WITNESSES = ("consistent", "tie", "unsure", "singular")


def witness(st, rows, lam, problem, R, singular=None):
    """Which witness explains each decision: ``st`` [n, 2 + 2P] trace
    entries (cost, new cost, params, new params) of ``rows`` taken with
    damping ``lam`` [n]; returns {witness: [n] bool}."""
    P = (st.shape[1] - 2) // 2
    p_now, p_new = st[:, 2:2 + P].numpy(), st[:, 2 + P:].numpy()
    c32, n32 = st[:, 0].numpy(), st[:, 1].numpy()
    # plain's float32 costs at the side's points: the error float32 makes
    # there (the side's own values do not excuse themselves)
    r32, c64 = problem.costs(rows, p_now)
    m32, n64 = problem.costs(rows, p_new)
    s_c64, s_n64 = problem.step(rows, p_now, lam, torch.float64)
    s_c32, s_n32 = problem.step(rows, p_now, lam, torch.float32)
    g64 = s_n64 - s_c64
    ok = {"consistent": (n32 < c32) == (g64 < 0),
          "tie": tie_margin(r32, m32, c64, n64, R[rows], cost_noise(
              c64, R[rows], problem.noise(rows, p_now)) + cost_noise(
              n64, R[rows], problem.noise(rows, p_new))) <= 1,
          "unsure": np.nan_to_num(
              np.abs(g64) <= 4 * np.abs((s_n32 - s_c32) - g64), nan=True),
          "singular": np.zeros(len(rows), bool)}
    zero = (p_now == p_new).all(1)
    if singular is not None and zero.any():
        sm = singular(rows[zero], p_now[zero])
        if sm is not None:
            ok["singular"][zero] = sm <= 1
    return ok


def _count(kinds, ok):
    """Each decision counted under its first witness."""
    done = np.zeros(len(ok[WITNESSES[0]]), bool)
    for k in WITNESSES:
        kinds[k] += int((ok[k] & ~done).sum())
        done |= ok[k]


def compare_solve(res_k, tr_k, res_p, tr_p, problem, R, singular=None):
    """Row by row: kernel (LMResult, trace) against plain's.  ``problem``
    a :class:`RowProblem` of the input; ``R`` the residual count of a
    row ([T] or a number); ``singular`` (rows, params) -> each row's
    margin to a singular Jacobian (<= 1: within rounding of one), or
    None where the residual has no such point."""
    res_k = lm.LMResult(*(x.detach().cpu() for x in res_k))
    res_p = lm.LMResult(*(x.detach().cpu() for x in res_p))
    tr_k, tr_p = tr_k.detach().cpu().double(), tr_p.detach().cpu().double()
    T, n_iter, W = tr_p.shape
    P = (W - 2) // 2
    R = np.broadcast_to(np.asarray(R, np.float64), (T,))
    acc_k, acc_p = accepts(tr_k), accepts(tr_p)
    same = (acc_k == acc_p).all(1)
    out = {"rows": T, "iterations": n_iter,
           "accepted": int(acc_p.sum()), "parted": int((~same).sum())}
    # rows with the same accept sequence: final params and cost
    pk, pp = res_k.params.double(), res_p.params.double()
    scale = torch.clamp(pp.abs(), min=1.0)
    perr = ((pk - pp).abs() / scale).amax(1)
    ck, cp, c0p = (x.double() for x in (res_k.cost, res_p.cost,
                                          res_p.cost0))

    def cost_tol(cost, params):
        """COST_RTOL of a cost, or four times what the residual noise at
        its parameters moves it by."""
        c = cost.numpy()
        noise = cost_noise(c, R, problem.noise(np.arange(T), params))
        return torch.as_tensor(np.maximum(COST_RTOL * np.abs(c), 4 * noise))

    p0 = tr_p[:, 0, 2:2 + P].numpy() if n_iter else pp.numpy()
    ctol, c0tol = cost_tol(cp, pp.numpy()), cost_tol(c0p, p0)
    cerr = (ck - cp).abs() / torch.clamp(ctol, min=1e-300)
    c0err = (res_k.cost0.double() - c0p).abs() \
        / torch.clamp(c0tol, min=1e-300)
    s = same.numpy()
    out["max_param_err"] = float(perr[same].max()) if s.any() else 0.0
    out["max_cost_err_over_tol"] = float(cerr[same].max()) \
        if s.any() else 0.0
    out["max_cost0_err_over_tol"] = float(c0err.max()) if T else 0.0
    out["n_accepted_equal"] = bool(torch.equal(
        res_k.n_accepted[same], res_p.n_accepted[same]))
    bad_same = int(((perr > PARAM_TOL) | (cerr > 1))[same].sum())
    # parted rows: the first difference witnessed on both sides
    rows = np.nonzero(~s)[0]
    first = (acc_k != acc_p).double().argmax(1).numpy()[rows]
    kinds = dict.fromkeys(WITNESSES, 0)
    witnessed = np.ones(len(rows), bool)
    stalled = np.zeros(len(rows), bool)
    if len(rows):
        lam = lambdas(acc_p.numpy())[rows, first]
        for tr in (tr_k, tr_p):
            ok = witness(tr[rows, first], rows, lam, problem, R, singular)
            _count(kinds, ok)
            witnessed &= np.any(list(ok.values()), 0)
            stalled |= ok["singular"]
    # a parted row that ends higher than plain: every later decision of
    # the kernel witnessed from its own state (a valid float32 LM run that
    # went elsewhere from a witnessed parting, in a flat valley)
    higher = (ck - cp > ctol).numpy()[rows] & ~stalled
    later_ok = np.ones(len(rows), bool)
    lam_k = lambdas(acc_k.numpy())
    for i in np.nonzero(higher)[0]:
        its = np.arange(first[i] + 1, n_iter)
        if not len(its):
            continue
        r = np.full(len(its), rows[i])
        ok = witness(tr_k[r, its], r, lam_k[r, its], problem, R, singular)
        later_ok[i] = np.any(list(ok.values()), 0).all()
    out["parted_sides_by_witness"] = kinds
    out.update({"stalled_at_singular_point": int(stalled.sum()),
                "unwitnessed": int((~witnessed).sum()),
                "parted_higher_later_witnessed": int((higher
                                                      & later_ok).sum()),
                "parted_cost_higher": int((higher & ~later_ok).sum()),
                "same_rows_beyond": bad_same})
    if (~witnessed).any():
        out["unwitnessed_rows"] = [[int(r), int(f)] for r, f in zip(
            rows[~witnessed][:5], first[~witnessed][:5])]
    if len(rows):
        out["parted_first_iterations"] = sorted(set(int(x) for x in first))
    # the parameters' error where the accept sequences agree
    out["max_abs_err"] = float((pk - pp)[same].abs().max()) \
        if s.any() else 0.0
    out["ok"] = (bad_same == 0 and out["n_accepted_equal"]
                 and out["unwitnessed"] == 0 and out["parted_cost_higher"] == 0
                 and out["max_cost0_err_over_tol"] <= 1)
    return out


# -------------------------------------------- the two kernels' inputs
def line_ba_problem(aux, cfg):
    from limap_tpu_torch.optimize.line_ba import ba_residual
    return RowProblem(ba_residual(cfg), lm.retract_quat_so2, 4, aux)


def jointloc_problem(data, cfg):
    from limap_tpu_torch.ops import lm_jointloc
    from limap_tpu_torch.optimize.hybrid_localization import \
        _jointloc_residual
    return RowProblem(_jointloc_residual(cfg, data[0].shape[0] > 0,
                                         data[5].shape[0] > 0),
                      lm.retract_pose, 6, lm_jointloc.plain_aux(*data),
                      shared=(0, 1, 2, 3, 5, 6, 8))


def line_cosines(data, rows, params, dtype):
    """|cos| of the angle between each line's projection under the rows'
    poses and its 2D segment, as ``_weight_2d`` computes it before the
    clamp: [n, N_l] in ``dtype`` on the CPU."""
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.line_geometry import project_segments
    from limap_tpu_torch.base.lines import Segments
    l3s, l3e, l2s, l2e = (x.detach().cpu().to(dtype) for x in data[:4])
    kv = data[8].detach().cpu().to(dtype)
    p = torch.as_tensor(np.asarray(params), dtype=dtype)
    views = CameraViewsBatch(kv[None, None], p[:, None, :4], p[:, None, 4:7])
    pd = project_segments(Segments(l3s[None], l3e[None]), views).direction()
    e = (l2e - l2s)[None]
    norm = torch.sqrt(torch.sum(e * e, -1) + 1e-8)
    return torch.abs(torch.sum(pd * e, -1)) / norm


def jointloc_singular(data, cfg):
    """``singular`` for kernel I: under ``line3dpp`` the Jacobian is
    non-finite where a masked line's |cos| reaches 1 (arccos' infinite
    there, or NaN past the clamp); the margin is the least of (1 - cos)
    over the larger of ``COS_TOL`` and four times the float32 value's
    error, float64 against float32 on the CPU."""
    if cfg.cost_function_weight != "line3dpp":
        return None

    def margins(rows, params):
        c64 = line_cosines(data, rows, params, torch.float64)
        c32 = line_cosines(data, rows, params, torch.float32).double()
        tol = torch.clamp(4 * (c32 - c64).abs(), min=COS_TOL)
        m = (1 - c64).abs() / tol
        m = torch.where(data[4].cpu()[torch.as_tensor(rows)], m,
                        torch.full_like(m, float("inf")))
        return m.amin(1).numpy() if m.shape[1] else np.full(len(rows),
                                                             np.inf)

    return margins


def jointloc_ne_rtol(data, cfg, params0):
    """Each row's normal-equation tolerance under ``line3dpp``: four times
    u c / (1 - c^2) for its masked lines' largest float64 |cos| c below
    1 (None under the other weights)."""
    if cfg.cost_function_weight != "line3dpp" or not data[0].shape[0]:
        return None
    c = line_cosines(data, np.arange(params0.shape[0]),
                     params0.detach().cpu().numpy(), torch.float64)
    c = torch.where(data[4].cpu() & (c < 1), c, torch.zeros_like(c))
    c = c.amax(1)
    return (4 * U32 * c / (1 - c * c)).numpy()


# ------------------------------------------------------ seeded inputs
def _look_at(centres, rng):
    """World-to-camera (qvec, tvec) of cameras at ``centres`` looking at
    the origin (up to a small jitter)."""
    from scipy.spatial.transform import Rotation
    target = rng.normal(0, 0.3, centres.shape)
    z = target - centres
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    up = np.broadcast_to([0.0, 1.0, 0.0], z.shape)
    x = np.cross(up, z)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], -2)
    q = Rotation.from_matrix(R.reshape(-1, 3, 3)).as_quat()
    q = np.concatenate([q[:, 3:], q[:, :3]], 1).reshape(centres.shape[:-1]
                                                        + (4,))
    t = -np.einsum("...ij,...j->...i", R, centres)
    return q, t, R


def _project(R, t, K, X):
    pc = np.einsum("...ij,...j->...i", R, X) + t
    return K[..., :2] * pc[..., :2] / pc[..., 2:] + K[..., 2:]


def seeded_line_ba(seed=0, T=96, S=40, device="cuda", noise=0.5,
                   outliers=0.1):
    """T tracks of up to S supports (the first of S, the rest 2 to S, the
    padding garbage), 0.5 px noise and a share of 20 px outliers, every
    seventh track seen by fewer than ``min_num_images`` views (zero
    weights): (params0 [T, 6], aux) for :func:`ops.lm_line_ba.solve`."""
    from limap_tpu_torch.base.infinite_line import MinimalInfiniteLines3d
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.optimize.line_ba import pack_minimal_lines
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 1.0, (T, 3))
    dirs = rng.normal(size=(T, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    half = rng.uniform(0.5, 2.0, (T, 1))
    A, B = c - dirs * half, c + dirs * half
    centres = rng.normal(size=(T, S, 3))
    centres *= rng.uniform(6, 10, (T, S, 1)) \
        / np.linalg.norm(centres, axis=-1, keepdims=True)
    q, t, R = _look_at(centres, rng)
    K = np.stack([rng.uniform(450, 600, (T, S)), rng.uniform(450, 600, (T, S)),
                  np.full((T, S), 320.0), np.full((T, S), 240.0)], -1)
    ps = _project(R, t, K, A[:, None]) + rng.normal(0, noise, (T, S, 2))
    pe = _project(R, t, K, B[:, None]) + rng.normal(0, noise, (T, S, 2))
    out = rng.random((T, S)) < outliers
    ps[out] += rng.normal(0, 20, (int(out.sum()), 2))
    n_sup = rng.integers(2, S + 1, T)
    n_sup[0] = S
    n_sup[::7] = np.minimum(n_sup[::7], 3)
    valid = np.arange(S)[None] < n_sup[:, None]
    free = n_sup >= 4
    w = np.linalg.norm(pe - ps, axis=-1) / 30.0 * valid * free[:, None]
    garbage = ~valid
    for a in (K, q, t, ps, pe):
        a[garbage] = rng.normal(0, 1, (int(garbage.sum()), a.shape[-1]))
    A0 = A + rng.normal(0, 0.05, A.shape)
    B0 = B + rng.normal(0, 0.05, B.shape)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    params0 = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(
        Segments(f(A0), f(B0))))
    aux = tuple(x.to(device) for x in (f(K), f(q), f(t), f(ps), f(pe), f(w),
                                       torch.as_tensor(valid)))
    return params0.to(device), aux


def seeded_jointloc(seed=0, T=8, device="cuda", corners=False):
    """T pose chains on one PnPL problem (60 points, 30 lines, 20 %
    outliers; ``testing/localization.py::synthetic_problem``), each from
    its own perturbed start on a random 70 % of the matches; the last row
    masks every match (a zero-weight row).  With ``corners`` the true
    pose is the identity, row 0 starts there, and two lines are added:
    one projecting to a horizontal segment that its 2D segment (128 px,
    horizontal) matches exactly, so |cos| = 1 under ``line3dpp``, and
    one along the optical axis whose 2D start is the principal point, so
    its ray is parallel to the line under ``3d_line_line_dist2``.
    Returns (params0 [T, 7], data) for :func:`ops.lm_jointloc.solve`."""
    from scipy.spatial.transform import Rotation
    from limap_tpu_torch.base.camera import CameraPose
    from limap_tpu_torch.testing.localization import synthetic_problem
    rng = np.random.default_rng(seed)
    cam, pose_gt, p3, p2, l3, _, l2 = synthetic_problem(
        rng, n_points=60, n_lines=30, outlier_ratio=0.2)
    if corners:
        # the same scene seen from the identity pose
        R, t = pose_gt.R(), pose_gt.tvec
        p3 = p3 @ R.T + t
        l3 = l3 @ R.T + t
        l3 = np.concatenate([l3, [[[-0.128, -0.8, 10.0], [0.128, -0.8,
                                                          10.0]],
                                  [[0.0, 0.0, 5.0], [0.0, 0.0, 9.0]]]])
        l2 = np.concatenate([l2, [[[256.0, 200.0], [384.0, 200.0]],
                                  [[320.0, 240.0], [400.0, 300.0]]]])
        pose_gt = CameraPose()
    starts = []
    for k in range(T):
        dq = Rotation.from_rotvec(rng.normal(size=3) * 0.03).as_matrix()
        starts.append(CameraPose(R=dq @ pose_gt.R(),
                                 tvec=pose_gt.tvec + rng.normal(0, 0.1, 3)))
    q0 = np.stack([p.qvec for p in starts])
    t0 = np.stack([p.tvec for p in starts])
    if corners:
        q0[0], t0[0] = [1.0, 0.0, 0.0, 0.0], 0.0
    lmask = rng.random((T, len(l3))) < 0.7
    pmask = rng.random((T, len(p3))) < 0.7
    if corners:
        lmask[0, -2:] = True
    lmask[-1], pmask[-1] = False, False
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x), dtype=dt, device=device).contiguous()
    params0 = f(np.concatenate([q0, t0], 1))
    data = (f(l3[:, 0]), f(l3[:, 1]), f(l2[:, 0]), f(l2[:, 1]),
            f(lmask, torch.bool), f(p3), f(p2), f(pmask, torch.bool),
            f(cam.kvec()))
    return params0, data


# (cost function, weight, loss, weight_line, weight_point): every cost
# function, weight and loss at least once; the last is the localization
# runner's default
JOINTLOC_CONFIGS = (
    ("2d_midpoint_dist2", "none", "trivial", 1.0, 1.0),
    ("2d_midpoint_angle_dist3", "cosine", "cauchy", 0.5, 1.0),
    ("2d_perpendicular_dist2", "line3dpp", "huber", 1.0, 2.0),
    ("2d_perpendicular_dist4", "length", "trivial", 1.0, 1.0),
    ("3d_line_line_dist2", "invlength", "cauchy", 2.0, 0.5),
    ("3d_plane_line_dist2", "none", "huber", 1.0, 1.0),
    ("2d_perpendicular_dist2", "none", "huber", 1.0, 1.0),
)
# the corners: |cos| = 1 under line3dpp, parallel rays under
# 3d_line_line_dist2
JOINTLOC_CORNER_CONFIGS = (
    ("3d_line_line_dist2", "line3dpp", "huber", 1.0, 1.0),
    ("3d_line_line_dist2", "cosine", "trivial", 1.0, 1.0),
    ("2d_perpendicular_dist4", "line3dpp", "cauchy", 1.0, 1.0),
)


def loc_config(cost, weight, loss, wl, wp):
    from limap_tpu_torch.optimize.hybrid_localization import LineLocConfig
    return LineLocConfig(cost_function=cost, cost_function_weight=weight,
                         loss=loss, loss_scale=2.0, weight_line=wl,
                         weight_point=wp)


# ------------------------------------------------------------- counts
# Scalar operations of the kernels, counted by hand from
# csrc/lm_common.cuh, csrc/lm_line_ba.cu and csrc/lm_jointloc.cu (each
# add, multiply, divide, compare, abs, sqrt, exp, sin, cos or acos as
# one); in a Jet<D> each counts D + 1.
# axis_angle_to_quat 14, quat_multiply 28, so2_rotate 8, quat_normalize
# 13, the rotation's two columns 24, the plucker ratio and moment 7,
# quat_rotate 30, normalize3 10, cross 9, dot3 5
OPS = {
    "ba_retract": 14 + 28 + 8,
    "ba_plucker": 13 + 24 + 7,
    # one support: two quat_rotate, t x Rd and its sum, the 2D line
    # (7, normalized 10), dn 5, d1 and d2 10, the direction 3, the
    # clamped cosine 6, the exp weight 3, the two residuals 2
    "ba_support": 60 + 12 + 17 + 5 + 10 + 3 + 6 + 3 + 2,
    # a support's constants: fx fy, cx fy, cy fx and the segment's norm
    "ba_support_const": 10,
    # the IRLS weight from the values: r^2 3, the loss 4, the scale 3
    "irls": 10,
    # the 4x4 and 6x6 steps: damping, Cholesky, substitutions,
    # nan_to_num, accept and lambda
    "solve4": 12 + 34 + 32 + 8 + 4,
    "solve6": 18 + 97 + 72 + 12 + 4,
    # retract_pose (14 + 28 + 3); with a 3D cost the camera centre
    # (conjugate 4, normalize 13, -t 3, quat_rotate 30)
    "pose": 45, "pose_centre": 50,
    # a point: project 41, the residual 2
    "point": 43,
    # a line: two projections 82 and the direction 9, then the cost
    "line": {"2d_midpoint_dist2": 91 + 6, "2d_midpoint_angle_dist3": 91 + 15,
             "2d_perpendicular_dist2": 91 + 42,
             "2d_perpendicular_dist4": 91 + 32,
             "3d_line_line_dist2": 91 + 131, "3d_plane_line_dist2": 91 + 117},
    # the 2D weight of a line when it depends on the pose
    "weight": {"cosine": 9, "line3dpp": 9},
}
R_LINE = {"2d_midpoint_angle_dist3": 3, "2d_perpendicular_dist4": 4}


def accumulate_ops(D):
    """One residual's share of J^T J, J^T r and the cost: a product and
    a sum each."""
    return 2 * (D * (D + 1) // 2 + D + 1)


def ops_line_ba(active_supports, rows, iterations, supports=None):
    """Operations of kernel H: per (row, iteration) the Jet line (5x),
    the float retraction and line of the new cost, and the step; per
    (active support, iteration) a Jet residual (5x) with its IRLS weight
    and scaling and its two rows of normal-equation terms, and a float
    residual with the same and its cost; per support its constants."""
    per_row = 5 * (OPS["ba_retract"] + OPS["ba_plucker"]) \
        + OPS["ba_retract"] + OPS["ba_plucker"] + OPS["solve4"]
    jet = 5 * (OPS["ba_support"] + 2) + OPS["irls"] + 2 * accumulate_ops(4)
    flt = OPS["ba_support"] + 2 + OPS["irls"] + 4
    return iterations * (rows * per_row + active_supports * (jet + flt)) \
        + (active_supports if supports is None else supports) \
        * OPS["ba_support_const"]


def bytes_line_ba(T, S):
    """Inputs read once (68 bytes a support, 24 a row), outputs written
    once (36 bytes a row)."""
    return T * S * 68 + T * 24 + T * 36


def ops_jointloc(cfg, lines, points, rows, iterations):
    """Operations of kernel I: per (row, iteration) the Jet pose (7x)
    and the float pose of the new cost, and the step; per (masked match,
    iteration) the Jet block (7x) with its IRLS weight and scaling and
    its rows of normal-equation terms, and the float block with the same
    and its cost.  ``lines`` and ``points``: the masked matches summed
    over the rows."""
    pose = OPS["pose"] + (OPS["pose_centre"] if cfg.cost_function
                          in ("3d_line_line_dist2", "3d_plane_line_dist2")
                          else 0)
    per_row = 7 * pose + pose + OPS["solve6"]
    R = R_LINE.get(cfg.cost_function, 2)
    w = cfg.cost_function_weight
    line = OPS["line"][cfg.cost_function] + OPS["weight"].get(w, 0) \
        + (R if w != "none" else 0) + R
    irls = 2 * R + 6
    per_line = 7 * line + irls + R * accumulate_ops(6) + line + irls + 2 * R
    point = OPS["point"] + 2
    per_point = 7 * point + OPS["irls"] + 2 * accumulate_ops(6) + point \
        + OPS["irls"] + 4
    return iterations * (rows * per_row + lines * per_line
                         + points * per_point)


def bytes_jointloc(T, nl, npt):
    """Inputs read once (a line 40 bytes, a point 20, a row's masks a
    byte a match and its start 28, the camera 16), outputs written once
    (40 bytes a row)."""
    return nl * 40 + npt * 20 + T * (nl + npt) + T * 28 + 16 + T * 40


# ------------------------------------------------------------- runners
def check_line_ba(params0, aux, cfg, num_iterations=20, kernels=True):
    """H held to plain on one input: (normal equations, solve) results."""
    from limap_tpu_torch.ops import lm_line_ba as H
    cpu64 = [x.cpu() if x.dtype == torch.bool else x.cpu().double()
             for x in aux]
    ne_64 = H.normal_equations_plain(params0.cpu().double(), cpu64, cfg)
    problem = line_ba_problem(aux, cfg)
    R = 2 * aux[-1].sum(1).cpu().numpy()
    ne_p = H.normal_equations_plain(params0, aux, cfg)
    ne_k = H.normal_equations(params0, *aux, cfg) if kernels else ne_p
    res_ne = compare_normal_equations(ne_k, ne_p, ne_64, noise=(
        R, problem.noise(np.arange(len(R)), params0.cpu().numpy())))
    rows_p = []
    res_p = H.solve_plain(params0, aux, cfg, num_iterations, rows_p)
    tr_p = torch.stack(rows_p, 1)
    if kernels:
        res_k, tr_k = H.solve(params0, *aux, cfg, num_iterations, trace=True)
    else:
        res_k, tr_k = res_p, tr_p
    res = compare_solve(res_k, tr_k, res_p, tr_p, problem, R)
    return res_ne, res


def jointloc_residual_count(data, cfg):
    """[T] residuals of each row: R_l per masked line, 2 per point."""
    R_l = R_LINE.get(cfg.cost_function, 2)
    return (R_l * data[4].sum(1) + 2 * data[7].sum(1)).cpu().numpy()


def check_jointloc(params0, data, cfg, num_iterations=50, kernels=True):
    """I held to plain on one input: (normal equations, solve) results."""
    from limap_tpu_torch.ops import lm_jointloc as I
    d64 = [x.cpu() if x.dtype == torch.bool else x.cpu().double()
           for x in data]
    ne_64 = I.normal_equations_plain(params0.cpu().double(), d64, cfg)
    problem = jointloc_problem(data, cfg)
    R = jointloc_residual_count(data, cfg)
    ne_p = I.normal_equations_plain(params0, data, cfg)
    ne_k = I.normal_equations(params0, *data, cfg) if kernels else ne_p
    res_ne = compare_normal_equations(
        ne_k, ne_p, ne_64, jointloc_ne_rtol(data, cfg, params0),
        (R, problem.noise(np.arange(len(R)), params0.cpu().numpy())))
    rows_p = []
    res_p = I.solve_plain(params0, data, cfg, num_iterations, rows_p)
    tr_p = torch.stack(rows_p, 1)
    if kernels:
        res_k, tr_k = I.solve(params0, *data, cfg, num_iterations,
                              trace=True)
    else:
        res_k, tr_k = res_p, tr_p
    res = compare_solve(res_k, tr_k, res_p, tr_p, problem, R,
                        jointloc_singular(data, cfg))
    return res_ne, res


def check_all(device="cuda"):
    """The seeded cases on ``device``: yields (name, case, result)."""
    from limap_tpu_torch.optimize.line_ba import LineBAConfig
    kernels = device != "cpu"
    params0, aux = seeded_line_ba(seed=1, device=device)
    for loss in ("cauchy", "huber", "trivial"):
        ne, sol = check_line_ba(params0, aux, LineBAConfig(loss=loss),
                                kernels=kernels)
        yield "lm_line_ba normal equations", f"seeded, {loss}", ne
        yield "lm_line_ba solve", f"seeded, {loss}", sol
    for corners, configs in ((False, JOINTLOC_CONFIGS),
                             (True, JOINTLOC_CORNER_CONFIGS)):
        params0, data = seeded_jointloc(seed=2, device=device,
                                        corners=corners)
        for c in configs:
            case = ("corners, " if corners else "seeded, ") + ", ".join(
                map(str, c))
            ne, sol = check_jointloc(params0, data, loc_config(*c),
                                     kernels=kernels)
            yield "lm_jointloc normal equations", case, ne
            yield "lm_jointloc solve", case, sol


def main():
    from limap_tpu_torch.ops import cuda_build, lm_jointloc, lm_line_ba
    lm_line_ba.build()
    lm_jointloc.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}")
    ok = True
    for name, case, res in check_all("cuda"):
        print(f"{name}, {case}: {json.dumps(res)}", flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
