"""The LM kernels held to their plain versions: kernel H (line BA,
``ops/lm_line_ba.py``), kernel I (the joint point+line pose solve,
``ops/lm_jointloc.py``), kernel K (line refinement,
``ops/lm_line_refine.py``) and kernels L and M (the association's line
and point steps, ``ops/lm_assoc.py``).  ``chip_smoke.py`` (phases 2, 4,
7, 8, 10 and 12) and ``tests/test_torch_cuda.py`` share these inputs and
comparisons;
``tests/test_torch_lm_checks.py`` runs them on the CPU, against the plain
version itself and against faults.

    python -m limap_tpu_torch.testing.lm_checks

builds the kernels on one GPU and prints each comparison.

The kernels follow the plain version's formulas operation for
operation, but their sums run in another order than torch's and the
card rounds its transcendentals and fused products its own way, so two
things are compared apart:

- the normal equations at ``params0`` (the check entry, 0 iterations):
  every finite entry of J^T J, J^T r and the cost within ``NE_RTOL`` of
  its scale (sqrt(J^T J_ii J^T J_jj), sqrt(J^T J_ii cost), cost), or
  within four times the plain float32 value's own error against
  float64 where that is larger (for kernels K, L and M the largest such
  error at params0 and at its one-ulp moves, and at least twice gamma_R
  of the entry's sum of magnitudes), and J^T r and the cost also within
  four times what the row's residual noise moves them by (the largest
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
      the same state (for K, L and M also from a one-ulp move of one of
      its parameters: an ill-conditioned step's float32 error is not one
      sample's);
  (c) a singular point: the side's step was zeroed (a non-finite
      Jacobian) at a state where float64 puts a masked line's |cos|
      within rounding of 1 under ``line3dpp``;
  (d) a corner: at the side's state the residual is not determined by
      its float32 inputs.  For kernels L and M (:class:`RowCorners`) an
      active association residual, a norm (the sine of a line and its VP,
      the distance of a point and a line), is within float32 rounding of
      0 in float64, where the norm's gradient is the direction of a
      vector of rounding noise (a VP set from a single member line lands
      there); a row at such a corner at the start has its normal
      equations held to their scale only and its first cost is not
      compared.  For kernel K (:class:`ResidualCorners`) a residual at a
      time: a heatmap anchor's foot or a feature sample within its
      float32 error of an integer, a texel edge (the bilinear gradient
      jumps) or a patch bound (the sample switches on or off), has two
      alternatives, its coordinate just below or just above the edge; at
      the start the normal equations and the first cost may differ by
      twice the largest move of those residuals' shares over their
      alternatives (in float64), and a decision at a corner is witnessed
      only where the float64 step with the corner coordinates on one
      combination of sides takes it.  Planted faults (``REFINE_FAULTS``)
      show that these rules still refuse a wrong heatmap or feature term.
  For K, L and M a row whose decisions agree but whose final parameters
  or cost part beyond tolerance is witnessed where every decision of the
  kernel is witnessed from its own states as above (a row with a flat
  direction drifts along it).
  A parted row must end at a cost no higher than plain's plus its
  tolerance, or else have every later decision of the kernel witnessed
  the same way from the kernel's own states (after a parting in a flat
  valley the two runs are different valid float32 LM runs, and the one
  that raised its damping may stop where float32 resolves no further
  decrease), unless one side stalled at a singular point (c): the plain
  version's own arithmetic stops that row, and only its witness is
  required.

How far a parted row ends from plain's (``compare_solve``'s
``end_distance``): for the line kernels H, K and L
(:func:`line_end_distance`), the largest distance from the points of
plain's final line within ``END_SPAN`` m of its point nearest the world
origin (where the scenes' lines are seen) to the kernel's final line, in
metres; the max and the median over the parted rows.

The operation counts of the kernels (``ops_line_ba``, ``ops_jointloc``,
``ops_line_refine``, ``ops_assoc_lines``, ``ops_assoc_points``) are
counted by hand from their sources: a Jet<D> operation counts D + 1,
each value once at the coarsest index it depends on.  The bytes of K, L
and M (``bytes_line_refine``, ``bytes_assoc_lines``,
``bytes_assoc_points``) count what the input needs: every slot's weight,
the weighted items' data, each view, point, VP or line named once, and
of the patches only the texels that the samples at params0 read.
"""

from __future__ import annotations

import json
import sys
from typing import NamedTuple, Optional

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
# half the span of plain's line over which a parted line's end distance
# is measured, in metres
END_SPAN = 1.0
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


def residual_jacobian(params, residual_fn, retract_fn, D, aux):
    """(r [T, R], J [T, R, D]) at ``params`` through the retraction at
    delta = 0, in the dtype of ``params``."""
    from torch.func import jvp, vmap
    T = params.shape[0]
    basis = torch.eye(D, dtype=params.dtype, device=params.device)
    zero = torch.zeros((T, D), dtype=params.dtype, device=params.device)
    f = lambda delta: residual_fn(retract_fn(params, delta), *aux)
    return vmap(lambda e: jvp(f, (zero,), (e.expand(T, D),)),
                out_dims=(None, -1))(basis)


def abs_sums(params0, residual_fn, retract_fn, D, aux):
    """(sum |J_ki| |J_kj| [T, D, D], sum |J_ki| |r_k| [T, D], sum r^2
    [T]) in float64: what bounds the rounding of the normal equations'
    sums in any order (each within gamma_R of its sum of magnitudes)."""
    p = params0.detach().cpu().double()
    aux = [t.detach().cpu().double() if t.is_floating_point()
           else t.detach().cpu() for t in aux]
    r, J = residual_jacobian(p, residual_fn, retract_fn, D, aux)
    J, r = torch.nan_to_num(J.abs()), torch.nan_to_num(r.abs())
    return (J.transpose(1, 2) @ J, (J.transpose(1, 2) @ r[..., None])[..., 0],
            torch.sum(r * r, 1))


class Rules(NamedTuple):
    """What a comparison grants beyond plain's own float32 error at the
    start, built for one input (the defaults hold H and I).  ``sums``:
    the float64 magnitude sums of the normal equations (``abs_sums``),
    each entry also within twice gamma_R of its sum (the summation order);
    ``moves``: plain's normal equations at one-ulp moves of params0, whose
    float32 error counts as plain's own too, and in the solve a step's
    float32 error also at one-ulp moves of its state and rows whose
    accepts agree but whose parameters part witnessed decision by
    decision; ``corner``: the input's corners, a :class:`RowCorners` (L,
    M) or :class:`ResidualCorners` (K), or None."""

    sums: Optional[tuple] = None
    moves: tuple = ()
    corner: Optional[object] = None


def compare_normal_equations(ne_k, ne_p, ne_64, row_rtol=None, noise=None,
                             rules=Rules()):
    """The kernel's (J^T J, J^T r, cost) at params0 against plain's,
    both float32, with plain's float64 counterpart for its own error;
    ``row_rtol`` [T] raises a row's relative tolerance above
    ``NE_RTOL``; ``noise`` = (R [T], eps [T]) the rows' residual counts
    and residual noise; ``rules`` as :class:`Rules`."""
    ne_k = [x.detach().cpu().double() for x in ne_k]
    ne_p = [x.detach().cpu().double() for x in ne_p]
    ne_64 = [x.detach().cpu().double() for x in ne_64]
    T = ne_p[2].shape[0]
    rtol = torch.full((T,), NE_RTOL, dtype=torch.float64)
    corner = rules.corner
    if corner is not None and corner.start_rtol() is not None:
        row_rtol = corner.start_rtol() if row_rtol is None else np.maximum(
            row_rtol, corner.start_rtol())
    if row_rtol is not None:
        rtol = torch.maximum(rtol, torch.as_tensor(row_rtol).double())
    floors = [torch.zeros_like(x) for x in ne_p]
    if noise is not None:
        R, eps = (torch.as_tensor(np.asarray(x, np.float64)) for x in noise)
        diag = torch.diagonal(ne_p[0], dim1=-2, dim2=-1).abs()
        floors[1] = torch.sqrt(diag * R[:, None]) * eps[:, None]
        floors[2] = torch.as_tensor(cost_noise(ne_p[2].numpy(), R, eps))
    if rules.sums is not None:
        # the summation order: each side within gamma_R of the sum of
        # magnitudes (R the row's residual count, from ``noise``)
        R = torch.as_tensor(np.asarray(noise[0], np.float64))
        g = R * U32 / (1 - R * U32)
        for i, a in enumerate(rules.sums):
            gi = g.reshape((T,) + (1,) * (a.dim() - 1))
            floors[i] = torch.maximum(floors[i], 2 * gi * a.double())
    slack = corner.start_slack() if corner is not None else None
    pattern = all(_finite_pattern_equal(a, b) for a, b in zip(ne_k, ne_p))
    worst, rel, n_fin = 0.0, 0.0, 0
    # plain's float32 values at one-ulp moves of the state: its float32
    # error there too (an ill-conditioned term's error is not one sample's)
    moves_i = [[m[i].detach().cpu().double() for m in rules.moves]
               for i in range(3)]
    for idx, (k, p, q, s, f) in enumerate(zip(ne_k, ne_p, ne_64,
                                              ne_scales(*ne_p), floors)):
        fin = torch.isfinite(k) & torch.isfinite(p)
        if not fin.any():
            continue
        r = rtol.reshape((T,) + (1,) * (k.dim() - 1)).expand_as(k)[fin]
        k, p, q, s, f = k[fin], p[fin], q[fin], s[fin], f[fin]
        own = torch.nan_to_num((p - q).abs(), nan=0.0, posinf=0.0)
        for mv in moves_i[idx]:
            own = torch.maximum(own, torch.nan_to_num(
                (mv[fin] - q).abs(), nan=0.0, posinf=0.0))
        tol = torch.maximum(r * torch.nan_to_num(s, posinf=0.0),
                            4 * torch.maximum(own, torch.nan_to_num(f)))
        if slack is not None:
            tol = tol + slack[idx][fin]
        err = (k - p).abs()
        over = err > tol
        if over.any():
            worst = max(worst, float((err[over] / tol[over]).max()))
        rel = max(rel, float((err / torch.clamp(s, min=1e-30)).max()))
        n_fin += int(fin.sum())
    bad = ~torch.isfinite(ne_p[2]) | ~torch.isfinite(ne_p[0]).flatten(1).all(1)
    out = {"rows": T, "finite_entries": n_fin,
           "nonfinite_rows": int(bad.sum()), "pattern_equal": pattern,
           "max_rel_err": rel, "max_err_over_tol": worst,
           "rows_above_ne_rtol": int((rtol > NE_RTOL).sum()),
           "ok": pattern and worst == 0.0}
    if corner is not None:
        out.update(corner.report())
    return out


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
    """The plain residual of some rows on ``device`` (the CPU unless
    asked) in float32 and float64: their costs and residual noise at
    given parameters, and one LM step.  ``aux`` as the plain residual
    takes it; the indices in ``shared`` are data common to all rows (a
    leading [1]), the rest per row."""

    def __init__(self, residual_fn, retract_fn, D, aux, shared=(),
                 device="cpu"):
        self.f, self.retract, self.D = residual_fn, retract_fn, D
        self.device = torch.device(device)
        self.aux = [t.detach().to(self.device) for t in aux]
        self.shared = shared

    def _p(self, params, dtype):
        p = params if torch.is_tensor(params) else torch.as_tensor(
            np.asarray(params))
        return p.to(device=self.device, dtype=dtype)

    def _aux(self, rows, dtype):
        idx = torch.as_tensor(np.asarray(rows), device=self.device)
        aux = [t if i in self.shared else t[idx]
               for i, t in enumerate(self.aux)]
        return [x.to(dtype) if x.is_floating_point() else x for x in aux]

    def cost(self, rows, params, dtype):
        p = self._p(params, dtype)
        return torch.sum(self.f(p, *self._aux(rows, dtype)) ** 2,
                         1).double().cpu().numpy()

    def noise(self, rows, params):
        """Each row's largest |float32 - float64| residual at ``params``."""
        p = self._p(params, torch.float64)
        r32 = self.f(p.float(), *self._aux(rows, torch.float32)).double()
        r64 = self.f(p, *self._aux(rows, torch.float64))
        return torch.nan_to_num((r32 - r64).abs(),
                                nan=0.0).amax(1).cpu().numpy()

    def costs(self, rows, params):
        """(float32, float64) costs [n] of ``rows`` at ``params``."""
        return (self.cost(rows, params, torch.float32),
                self.cost(rows, params, torch.float64))

    def step(self, rows, params, lam, dtype, extra=None):
        """One LM step from ``params`` with damping ``lam``, as lm_solve
        takes it, in ``dtype``: (cost, new cost) [n] as float64.
        ``extra`` (rows, params) -> more inputs of the residual at those
        parameters, appended to the rows' own."""
        more = (lambda q: list(extra(rows, q))) if extra else (lambda q: [])
        aux = self._aux(rows, dtype)
        p = self._p(params, dtype)
        JTJ, JTr, cost = lm.normal_equations(p, self.f, self.retract,
                                             self.D, aux + more(p))
        diag = torch.diagonal(JTJ, dim1=-2, dim2=-1)
        lam = self._p(lam, dtype)
        A = JTJ + torch.diag_embed(lam[:, None]
                                   * torch.clamp(diag, min=1e-8))
        delta = torch.nan_to_num(-lm.solve_spd(A, JTr))
        pn = self.retract(p, delta)
        new = torch.sum(self.f(pn, *aux, *more(pn)) ** 2, 1)
        return cost.double().cpu().numpy(), new.double().cpu().numpy()


WITNESSES = ("consistent", "tie", "unsure", "singular", "corner")


def witness(st, rows, lam, problem, R, singular=None, rules=Rules()):
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
          "singular": np.zeros(len(rows), bool),
          "corner": np.zeros(len(rows), bool)}
    if rules.moves:
        # the float32 step's gain error at one-ulp moves of the state too:
        # an ill-conditioned step's error is not one sample's
        left = ~ok["unsure"]
        for k in range(p_now.shape[1]):
            for sgn in (1, -1):
                if not left.any():
                    break
                pm = p_now[left].copy()
                pm[:, k] = np.nextafter(pm[:, k].astype(np.float32),
                                        np.float32(sgn * np.inf))
                c, n = problem.step(rows[left], pm, np.asarray(lam)[left],
                                    torch.float32)
                e = np.nan_to_num(np.abs((n - c) - g64[left]), nan=np.inf)
                hit = np.abs(g64[left]) <= 4 * e
                idx = np.nonzero(left)[0][hit]
                ok["unsure"][idx] = True
                left[idx] = False
    zero = (p_now == p_new).all(1)
    if singular is not None and zero.any():
        sm = singular(rows[zero], p_now[zero])
        if sm is not None:
            ok["singular"][zero] = sm <= 1
    if rules.corner is not None:
        left = ~np.any(list(ok.values()), 0)
        if left.any():
            ok["corner"][left] = rules.corner.witness(
                rows[left], p_now[left], p_new[left], np.asarray(lam)[left],
                (n32 < c32)[left])
    return ok


def _count(kinds, ok):
    """Each decision counted under its first witness."""
    done = np.zeros(len(ok[WITNESSES[0]]), bool)
    for k in WITNESSES:
        kinds[k] += int((ok[k] & ~done).sum())
        done |= ok[k]


def line_end_distance(params_k, params_p) -> np.ndarray:
    """[n] metres: the largest distance from the points of plain's line
    (minimal parameters ``params_p`` [n, 6]) within ``END_SPAN`` of its
    point nearest the origin to the kernel's line (``params_k``), at
    that point and at both ends of the span, in float64."""
    from limap_tpu_torch.base.infinite_line import (InfiniteLines3d,
                                                    minimal_to_plucker)
    pk = torch.as_tensor(np.asarray(params_k, np.float64))
    pp = torch.as_tensor(np.asarray(params_p, np.float64))
    line_k = InfiniteLines3d(*minimal_to_plucker(pk[:, :4], pk[:, 4:]))
    d, m = minimal_to_plucker(pp[:, :4], pp[:, 4:])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    foot = torch.linalg.cross(d, m)
    dist = [line_k.point_distance(foot + s * END_SPAN * d)
            for s in (-1.0, 0.0, 1.0)]
    return torch.stack(dist, 1).amax(1).numpy()


def compare_solve(res_k, tr_k, res_p, tr_p, problem, R, singular=None,
                  rules=Rules(), end_distance=None):
    """Row by row: kernel (LMResult, trace) against plain's.  ``problem``
    a :class:`RowProblem` of the input; ``R`` the residual count of a
    row ([T] or a number); ``singular`` (rows, params) -> each row's
    margin to a singular Jacobian (<= 1: within rounding of one), or
    None where the residual has no such point; ``rules`` as
    :class:`Rules`; ``end_distance`` (kernel's final params, plain's)
    [n, P] -> [n] metres, how far each parted row ends from plain's
    (:func:`line_end_distance`), reported as its max and median."""
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
    corner = rules.corner
    if corner is not None and corner.start_slack() is not None:
        # the start's cost may differ by what its corner residuals'
        # alternatives move it by
        c0tol = c0tol + corner.start_slack()[2]
    cerr = (ck - cp).abs() / torch.clamp(ctol, min=1e-300)
    c0err = (res_k.cost0.double() - c0p).abs() \
        / torch.clamp(c0tol, min=1e-300)
    if corner is not None and corner.start_excused() is not None and T:
        # at a corner the start's residuals themselves are rounding's
        at = corner.start_excused()
        out["cost0_at_corner"] = int(at.sum())
        c0err = torch.where(at, torch.zeros_like(c0err), c0err)
    s = same.numpy()
    out["max_param_err"] = float(perr[same].max()) if s.any() else 0.0
    out["max_cost_err_over_tol"] = float(cerr[same].max()) \
        if s.any() else 0.0
    out["max_cost0_err_over_tol"] = float(c0err.max()) if T else 0.0
    out["n_accepted_equal"] = bool(torch.equal(
        res_k.n_accepted[same], res_p.n_accepted[same]))
    beyond = ((perr > PARAM_TOL) | (cerr > 1)) & same
    # a row whose decisions agree but whose parameters part (a flat
    # direction drifts, kernel K's bilinear gradients jump at texel
    # edges): witnessed where every decision of the kernel is witnessed
    # from its own states (a valid float32 LM run of the same problem
    # that walked elsewhere with the same accepts)
    same_ok = torch.zeros_like(beyond)
    if rules.moves and beyond.any():
        lam_k = lambdas(acc_k.numpy())
        b_rows = torch.nonzero(beyond)[:, 0].numpy()
        rr = np.repeat(b_rows, n_iter)
        its = np.tile(np.arange(n_iter), len(b_rows))
        ok = witness(tr_k[rr, its], rr, lam_k[rr, its], problem, R,
                     singular, rules)
        done = np.any(list(ok.values()), 0).reshape(len(b_rows), n_iter)
        same_ok[b_rows] = torch.as_tensor(done.all(1))
    bad_same = int((beyond & ~same_ok).sum())
    out["same_rows_beyond_witnessed"] = int(same_ok.sum())
    # parted rows: the first difference witnessed on both sides
    rows = np.nonzero(~s)[0]
    first = (acc_k != acc_p).double().argmax(1).numpy()[rows]
    kinds = dict.fromkeys(WITNESSES, 0)
    witnessed = np.ones(len(rows), bool)
    stalled = np.zeros(len(rows), bool)
    if len(rows):
        lam = lambdas(acc_p.numpy())[rows, first]
        for tr in (tr_k, tr_p):
            ok = witness(tr[rows, first], rows, lam, problem, R, singular,
                         rules)
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
        ok = witness(tr_k[r, its], r, lam_k[r, its], problem, R, singular,
                     rules)
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
    if end_distance is not None:
        far = end_distance(pk[rows].numpy(), pp[rows].numpy()) \
            if len(rows) else np.zeros(0)
        out["parted_end_dist_max_m"] = float(far.max(initial=0.0))
        out["parted_end_dist_median_m"] = float(np.median(far)) \
            if len(far) else 0.0
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
    res = compare_solve(res_k, tr_k, res_p, tr_p, problem, R,
                        end_distance=line_end_distance)
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


# ----------------------------------- kernels K, L and M (refinement and
# association)
def _plucker_np(params0):
    from limap_tpu_torch.base.infinite_line import minimal_to_plucker
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines
    line = unpack_minimal_lines(params0.detach().cpu().double())
    d, m = minimal_to_plucker(line.uvec, line.wvec)
    return d.numpy(), m.numpy()


def _rot(q):
    from scipy.spatial.transform import Rotation
    q = np.asarray(q, np.float64)
    return Rotation.from_quat(np.concatenate([q[..., 1:], q[..., :1]],
                                             -1)).as_matrix()


def _smooth_patches(rng, shape, sigma=2.0):
    """Random smooth patches [..., H, W, C] in [0, 1]: sums of a few
    Gaussian blobs, so bilinear samples have gradients everywhere."""
    *lead, H, W, C = shape
    n = int(np.prod(lead)) if lead else 1
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros((n, H, W, C))
    for k in range(4):
        cy = rng.uniform(0, H, (n, 1, 1, C))
        cx = rng.uniform(0, W, (n, 1, 1, C))
        s = sigma * rng.uniform(1, 3, (n, 1, 1, C))
        out += rng.uniform(0.2, 1.0, (n, 1, 1, C)) * np.exp(
            -((yy[None, ..., None] - cy) ** 2
              + (xx[None, ..., None] - cx) ** 2) / (2 * s * s))
    return (out / out.max()).reshape(shape).astype(np.float32)


def seeded_refine(seed=0, T=64, S=24, F=8, A=16, Pa=11, Pp=21, C=6,
                  device="cuda"):
    """Kernel K's seeded input: seeded_line_ba's tracks with, per valid
    support, a VP (the initial line's direction in the camera, moved by
    about a degree; a third without), a smooth heatmap patch [A, Pa] on
    its segment and, per track, up to F feature terms (reference the
    first support, targets the next ones) with smooth patches around
    the projections of the line's point nearest the origin.  Returns
    (params0, RefineData)."""
    from limap_tpu_torch.ops.lm_line_refine import RefineData
    params0, aux = seeded_line_ba(seed=seed, T=T, S=S, device="cpu")
    kv, qv, tv, ps, pe, w, valid = (x.numpy() for x in aux)
    rng = np.random.default_rng(seed + 1000)
    d, m = _plucker_np(params0)
    R = _rot(qv)                                       # [T, S, 3, 3]
    dc = np.einsum("tsij,tj->tsi", R, d) + rng.normal(0, 0.02, (T, S, 3))
    K = np.zeros((T, S, 3, 3))
    K[..., 0, 0], K[..., 1, 1] = kv[..., 0], kv[..., 1]
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = kv[..., 2], kv[..., 3], 1.0
    vps = np.einsum("tsij,tsj->tsi", K, dc)
    vps /= np.linalg.norm(vps, axis=-1, keepdims=True)
    has = valid & (rng.random((T, S)) > 0.33) & (w > 0)
    vp_w = has * 0.1
    hm = _smooth_patches(rng, (T, S, A, Pa, 1))[..., 0]
    dseg = pe - ps
    length = np.linalg.norm(dseg, axis=-1)
    u = dseg / np.maximum(length, 1e-8)[..., None]
    v = np.stack([-u[..., 1], u[..., 0]], -1)
    # feature terms over a table of every support's view
    N = T * S
    X = np.cross(d, m)                                  # [T, 3]
    pc = np.einsum("tsij,tj->tsi", R, X) + tv
    xy = kv[..., :2] * pc[..., :2] / pc[..., 2:] + kv[..., 2:]
    fr = np.zeros((T, F), np.int32)
    ft = np.zeros((T, F), np.int32)
    coords = np.zeros((T, F, 3), np.float32)
    fro = np.zeros((T, F, 2), np.float32)
    fto = np.zeros((T, F, 2), np.float32)
    fw = np.zeros((T, F), np.float32)
    ang = _epipolar_angles(params0, kv, qv, tv, xy, valid)
    for t in range(T):
        sup = np.nonzero(valid[t])[0]
        # targets whose epipolar line crosses the line's projection at 20
        # degrees or more: a grazing intersection amplifies rounding
        tgts = [s for s in sup[1:] if ang[t, s] >= 20.0][:F]
        for f, s in enumerate(tgts):
            r0 = sup[0]
            fr[t, f], ft[t, f] = t * S + r0, t * S + s
            perp = v[t, r0]
            c = np.array([perp[1], -perp[0],
                          perp[0] * xy[t, r0, 1] - perp[1] * xy[t, r0, 0]])
            coords[t, f] = c / (np.linalg.norm(c[:2]) + 1e-12)
            fro[t, f] = np.round(xy[t, r0] + rng.normal(0, 2, 2)) - Pp // 2
            fto[t, f] = np.round(xy[t, s] + rng.normal(0, 2, 2)) - Pp // 2
            fw[t, f] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    data = RefineData(
        *aux[:6], f32(vps), f32(vp_w), f32(hm), f32(ps), f32(u), f32(v),
        f32(length), f32(kv.reshape(N, 4)), f32(qv.reshape(N, 4)),
        f32(tv.reshape(N, 3)), i32(fr), i32(ft), f32(coords),
        f32(_smooth_patches(rng, (T, F, Pp, Pp, C))),
        f32(_smooth_patches(rng, (T, F, Pp, Pp, C))), f32(fro), f32(fto),
        f32(fw))
    return params0.to(device), RefineData(*(x.contiguous().to(device)
                                            for x in data))


def _epipolar_angles(params0, kv, qv, tv, xy, valid):
    """[T, S] degrees between the line's projection into support s and
    the epipolar line there of the line's point seen in support 0."""
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.infinite_line import (line_world_to_pixel,
                                                    minimal_to_plucker)
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines
    from limap_tpu_torch.triangulation.functions import epipolar_line
    T, S = valid.shape
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    line = unpack_minimal_lines(params0.detach().cpu().double())
    d, m = minimal_to_plucker(line.uvec, line.wvec)
    v = CameraViewsBatch(f(kv), f(qv), f(tv))
    coor = line_world_to_pixel(v.kvec, v.qvec, v.tvec,
                               d[:, None].expand(T, S, 3),
                               m[:, None].expand(T, S, 3))
    v0 = CameraViewsBatch(*(x[:, :1].expand(x.shape) for x in v))
    epl = epipolar_line(v0, v, f(xy)[:, :1].expand(T, S, 2))
    n1 = torch.nn.functional.normalize(coor[..., :2], dim=-1)
    n2 = torch.nn.functional.normalize(epl[..., :2], dim=-1)
    c = torch.clamp(torch.abs(torch.sum(n1 * n2, -1)), max=1.0)
    return np.degrees(np.arccos(c.numpy()))


def refine_terms(which, loss="cauchy"):
    """K's seeded term sets: each term alone and all four together."""
    from limap_tpu_torch.ops.lm_line_refine import RefineTerms
    geo = which in ("geometric", "all")
    return RefineTerms(use_geometric=geo,
                       use_heatmap=which in ("heatmap", "all"),
                       use_fconsis=which in ("fconsis", "all"), loss=loss,
                       fconsis_multiplier=0.1)


def without_vps(data):
    """A RefineData with every VP weight 0 (the VP term off)."""
    return data._replace(vp_w=torch.zeros_like(data.vp_w))


REFINE_CASES = ("geometric", "vp", "heatmap", "fconsis", "all")


def refine_case(params0, data, which, loss="cauchy"):
    terms = refine_terms(which, loss)
    return (data if which in ("vp", "all") else without_vps(data)), terms


def seeded_assoc(seed=0, T=64, S=24, A=8, n_points=160, n_vps=6,
                 corner=True, device="cuda"):
    """Kernels L and M's seeded inputs: seeded_line_ba's tracks; points
    near the initial lines seen in up to 32 of a table of 40 views, each
    with up to A lines (its own with weight 5 and random others with 3,
    some slots empty); VPs near the first tracks' directions, each
    associated with its track and two others.  With ``corner`` the
    first VP is its track's direction exactly (as the host VP step sets
    a VP with a single member line), where the sine's gradient is
    rounding noise.  Returns (line params0, LineAssocData, point params0,
    PointAssocData)."""
    from limap_tpu_torch.ops.lm_assoc import LineAssocData, PointAssocData
    params0, aux = seeded_line_ba(seed=seed, T=T, S=S, device="cpu")
    kv, qv, tv, ps, pe, w, valid = aux
    rng = np.random.default_rng(seed + 2000)
    d, m = _plucker_np(params0)
    X0 = np.cross(d, m)
    # points on the lines, 0.05 m off
    pt_line = rng.integers(0, T, n_points)
    P3 = X0[pt_line] + rng.uniform(-0.5, 0.5, (n_points, 1)) * d[pt_line] \
        + rng.normal(0, 0.05, (n_points, 3))
    # a table of 40 views looking at the origin from 6-10 m
    NV = 40
    centres = rng.normal(size=(NV, 3))
    centres *= rng.uniform(6, 10, (NV, 1)) / np.linalg.norm(
        centres, axis=-1, keepdims=True)
    q, t, Rv = _look_at(centres, rng)
    Kv = np.stack([rng.uniform(450, 600, NV), rng.uniform(450, 600, NV),
                   np.full(NV, 320.0), np.full(NV, 240.0)], -1)
    S_pt = 32
    n_obs = rng.integers(0, S_pt + 1, n_points)
    img = np.stack([rng.permutation(NV)[:S_pt] for _ in range(n_points)])
    mask = np.arange(S_pt)[None] < n_obs[:, None]
    pc = np.einsum("pkij,pj->pki", Rv[img], P3) + t[img]
    p2d = Kv[img][..., :2] * pc[..., :2] / pc[..., 2:] + Kv[img][..., 2:] \
        + rng.normal(0, 0.5, (n_points, S_pt, 2))
    ln_idx = rng.integers(0, T, (n_points, A))
    ln_idx[:, 0] = pt_line
    ln_w = np.where(rng.random((n_points, A)) < 0.4, 3.0, 0.0)
    ln_w[:, 0] = 5.0
    # the lines' view of the same associations: the first A of each line
    pt_idx = np.zeros((T, A), np.int32)
    pt_w = np.zeros((T, A), np.float32)
    fill = np.zeros(T, int)
    for p in range(n_points):
        for k in range(A):
            li = ln_idx[p, k]
            if ln_w[p, k] > 0 and fill[li] < A:
                pt_idx[li, fill[li]], pt_w[li, fill[li]] = p, ln_w[p, k]
                fill[li] += 1
    vps = d[:n_vps] + rng.normal(0, 0.01, (n_vps, 3))
    if corner:
        vps[0] = d[0]
    vps /= np.linalg.norm(vps, axis=1, keepdims=True)
    vp_idx = np.zeros((T, A), np.int32)
    vp_w = np.zeros((T, A), np.float32)
    for v in range(n_vps):
        for k, li in enumerate((v, (v + 7) % T, (v + 13) % T)):
            vp_idx[li, k], vp_w[li, k] = v, 4.0 - k
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    ldata = LineAssocData(kv, qv, tv, ps, pe, w, i32(pt_idx), f32(pt_w),
                          i32(vp_idx), f32(vp_w), f32(P3), f32(vps))
    pdata = PointAssocData(f32(Kv), f32(q), f32(t), i32(img), f32(p2d),
                           torch.as_tensor(mask), i32(ln_idx), f32(ln_w),
                           params0)
    dev = lambda tup: type(tup)(*(x.contiguous().to(device) for x in tup))
    return (params0.to(device), dev(ldata), f32(P3).to(device), dev(pdata))


# an active association norm below this many float32 units (of 1 for a
# sine, of the point's size for a distance) is a corner
CORNER_ULPS = 64


def assoc_corner_lines(data, terms):
    """``corner`` for kernel L: each row's least margin of an active VP
    sine or point distance over CORNER_ULPS float32 units, in float64."""
    from limap_tpu_torch.base.infinite_line import InfiniteLines3d
    from limap_tpu_torch.base.infinite_line import minimal_to_plucker as mp
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines
    x = [t.detach().cpu() for t in data]
    pts, vps = x[10].double(), x[11].double()

    def margins(rows, params):
        rows = torch.as_tensor(np.asarray(rows))
        line = unpack_minimal_lines(torch.as_tensor(np.asarray(params),
                                                    dtype=torch.float64))
        d, m = mp(line.uvec, line.wvec)
        q = pts[x[6][rows].long()]
        dist = InfiniteLines3d(d[:, None], m[:, None]).point_distance(q)
        mdist = dist / (CORNER_ULPS * U32 * torch.clamp(
            torch.linalg.vector_norm(q, dim=-1), min=1.0))
        mdist = torch.where(x[7][rows] > 0, mdist,
                            torch.full_like(mdist, np.inf))
        out = mdist.amin(1)
        if terms.use_vps:
            v = vps[x[8][rows].long()]
            sine = torch.linalg.vector_norm(torch.cross(
                d[:, None].expand(v.shape), v, dim=-1), dim=-1) \
                / torch.linalg.vector_norm(v, dim=-1)
            ms = torch.where(x[9][rows] > 0, sine / (CORNER_ULPS * U32),
                             torch.full_like(sine, np.inf))
            out = torch.minimum(out, ms.amin(1))
        return out.numpy()

    return margins


def assoc_corner_points(data):
    """``corner`` for kernel M: each row's least margin of an active
    point-line distance over CORNER_ULPS float32 units of the point."""
    from limap_tpu_torch.base.infinite_line import InfiniteLines3d
    from limap_tpu_torch.base.infinite_line import minimal_to_plucker as mp
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines
    x = [t.detach().cpu() for t in data]
    line = unpack_minimal_lines(x[8].double())
    d, m = mp(line.uvec, line.wvec)

    def margins(rows, params):
        rows = torch.as_tensor(np.asarray(rows))
        X = torch.as_tensor(np.asarray(params), dtype=torch.float64)
        idx = x[6][rows].long()
        dist = InfiniteLines3d(d[idx], m[idx]).point_distance(
            X[:, None].expand(idx.shape + (3,)))
        mdist = dist / (CORNER_ULPS * U32 * torch.clamp(
            torch.linalg.vector_norm(X, dim=-1), min=1.0))[:, None]
        mdist = torch.where(x[7][rows] > 0, mdist,
                            torch.full_like(mdist, np.inf))
        return mdist.amin(1).numpy()

    return margins


def refine_coords(data, terms, rows, params):
    """Kernel K's sample coordinates of ``rows`` at ``params`` (in its
    dtype and on its device): {kind: (coordinate, weighted)}, the
    heatmap feet's pa and pb [n, S, A] and the feature points' patch
    coordinates rx, ry, tx, ty [n, F]."""
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.infinite_line import (line_world_to_pixel,
                                                    minimal_to_plucker)
    from limap_tpu_torch.ops.lm_line_refine import (fconsis_points,
                                                    heatmap_coords)
    from limap_tpu_torch.optimize.line_ba import unpack_minimal_lines
    x, dtype = data, params.dtype
    r = torch.as_tensor(np.asarray(rows), device=params.device)
    g = lambda i: x[i][r].to(dtype) if x[i].is_floating_point() else x[i][r]
    line = unpack_minimal_lines(params)
    out = {}
    if terms.use_heatmap:
        d, m = minimal_to_plucker(line.uvec, line.wvec)
        S = x[5].shape[1]
        coor = line_world_to_pixel(g(0), g(1), g(2),
                                   d[:, None].expand(-1, S, 3),
                                   m[:, None].expand(-1, S, 3))
        A, Pa = x[8].shape[2:]
        pa, pb = heatmap_coords(coor, g(9), g(10), g(11), g(12), A, Pa)
        on = (g(5) > 0)[..., None].expand(pa.shape)
        out.update(pa=(pa, on), pb=(pb, on))
    if terms.use_fconsis and x[16].shape[1]:
        views = CameraViewsBatch(x[13].to(dtype), x[14].to(dtype),
                                 x[15].to(dtype))
        xr, xt = fconsis_points(line.uvec, line.wvec, views, g(16), g(17),
                                g(18))
        on = g(23) > 0
        lr, lt = xr - g(21), xt - g(22)
        out.update(rx=(lr[..., 0], on), ry=(lr[..., 1], on),
                   tx=(lt[..., 0], on), ty=(lt[..., 1], on))
    return out


class RowCorners:
    """Corners a row at a time (kernels L and M): ``margins`` (rows,
    params) -> each row's least margin to a corner (<= 1: at one).  A
    row at a corner at the start has its normal equations held to their
    scale only and its first cost left uncompared; a decision taken at a
    corner is witnessed."""

    def __init__(self, margins, params0):
        self.margins = margins
        p0 = params0.detach().cpu().numpy()
        self.at0 = margins(np.arange(p0.shape[0]), p0) <= 1

    def start_rtol(self):
        return np.where(self.at0, 1.0, NE_RTOL)

    def start_slack(self):
        return None

    def start_excused(self):
        return torch.as_tensor(self.at0)

    def witness(self, rows, p_now, p_new, lam, accept):
        return self.margins(rows, p_now) <= 1

    def report(self):
        return {"corner_rows": int(self.at0.sum())}


class ResidualCorners:
    """Kernel K's corners, a residual at a time: a heatmap anchor's foot
    (pa, pb) or a feature sample (the reference and target points' x and
    y) within four times its float32 error (float32 against float64 on
    the CPU; at least 2^-20 of its size) of an integer, a texel edge
    where the bilinear gradient jumps or a patch bound where the sample
    switches on or off.  Such a coordinate has two alternatives, just
    below and just above its edge, and the plain residual is evaluated in
    float64 under each combination of sides (bit k the side of an item's
    k-th coordinate: 4 for a heatmap anchor, 16 for a feature term, every
    item meeting each of its own).  At the start each side's normal
    equations and first cost may differ from float64's by the largest
    move, over the combinations, of each corner residual's share: the
    comparison grants twice the sum of those moves.  A decision at a
    corner (at the side's state or its step's end) is witnessed where the
    float64 step under one of the combinations takes it."""

    KINDS = (("pa", 0), ("pb", 1), ("rx", 0), ("ry", 1), ("tx", 2),
             ("ty", 3))

    def __init__(self, data, terms, params0):
        import dataclasses
        from limap_tpu_torch.ops import lm_line_refine as K
        self.dev = params0.device
        self.data = [t.detach() for t in data]
        self.terms = terms
        self.params0 = params0.detach()

        def problem(t, d):
            return RowProblem(K.refine_residual(t, offsets=True),
                              lm.retract_quat_so2, 4, K.plain_aux(d),
                              K.SHARED, self.dev)

        self.problem = problem(terms, data)
        # the shares' moves, a term at a time: a heatmap residual meets
        # its 4 combinations, a feature residual its 16
        no_vp = data._replace(vp_w=torch.zeros_like(data.vp_w))
        alone = lambda **kw: dataclasses.replace(terms, **dict(
            dict(use_geometric=False, use_heatmap=False, use_fconsis=False),
            **kw))
        self.parts = []
        if terms.use_heatmap:
            self.parts.append((problem(alone(use_heatmap=True), no_vp), 4))
        if terms.use_fconsis and data.fc_w.shape[1]:
            self.parts.append((problem(alone(use_fconsis=True), no_vp), 16))
        self.combos = max([n for _, n in self.parts], default=1)
        self._slack = None
        self._count = 0

    def _coords(self, rows, params, dtype):
        return refine_coords(self.data, self.terms, rows,
                             self.problem._p(params, dtype))

    def _items(self, rows, params):
        """{kind: (float64 coordinate, margin to its integer over its
        error, the error)}."""
        c32 = self._coords(rows, params, torch.float32)
        c64 = self._coords(rows, params, torch.float64)
        out = {}
        for k, (b, on) in c64.items():
            a = c32[k][0].double()
            err = torch.maximum(4 * (a - b).abs(),
                                2.0 ** -20 * torch.clamp(b.abs(), min=1.0))
            edge = (b - torch.round(b)).abs()
            out[k] = (b, torch.where(on & torch.isfinite(b), edge / err,
                                     torch.full_like(b, np.inf)), err)
        return out

    def margins(self, rows, params):
        """Each row's least margin over its coordinates."""
        m = np.full(len(rows), np.inf)
        for _, mm, _ in self._items(rows, params).values():
            if mm.numel():
                m = np.minimum(m, mm.flatten(1).amin(1).cpu().numpy())
        return m

    def offsets(self, rows, params, combo=None):
        """The residual's four moves (pa, pb [n, S, A], ref and tgt points
        [n, F, 2]) putting each corner coordinate on ``combo``'s side of
        its integer, in float64; None: no move."""
        x = self.data
        n, (S, A), F = len(rows), x[8].shape[1:3], x[23].shape[1]
        z = lambda *shape: torch.zeros(shape, dtype=torch.float64,
                                       device=self.dev)
        off = {"pa": z(n, S, A), "pb": z(n, S, A)}
        off.update((k, z(n, F)) for k in ("rx", "ry", "tx", "ty"))
        if combo is not None:
            for k, (b, m, err) in self._items(rows, params).items():
                side = 1.0 if combo >> dict(self.KINDS)[k] & 1 else -1.0
                off[k] = torch.where(m <= 1, torch.round(b) + side * err - b,
                                     torch.zeros_like(b))
        return (off["pa"], off["pb"], torch.stack([off["rx"], off["ry"]], -1),
                torch.stack([off["tx"], off["ty"]], -1))

    def _shares(self, problem, rows, params, combo):
        """Each residual's float64 share (J J^T [n, R, D, D], J r [n, R,
        D], r^2 [n, R]) of ``problem`` under ``combo``."""
        p = problem._p(params, torch.float64)
        aux = problem._aux(rows, torch.float64) + list(
            self.offsets(rows, params, combo))
        r, J = residual_jacobian(p, problem.f, problem.retract, problem.D,
                                 aux)
        return J[..., :, None] * J[..., None, :], J * r[..., None], r * r

    def start_slack(self):
        """(J^T J [T, D, D], J^T r [T, D], cost [T]): twice the sum over
        the corner residuals of their shares' largest move at params0."""
        if self._slack is None:
            T, p0 = self.params0.shape[0], self.params0
            f64 = dict(dtype=torch.float64, device=self.dev)
            out = [torch.zeros((T, 4, 4), **f64),
                   torch.zeros((T, 4), **f64), torch.zeros(T, **f64)]
            for problem, combos in self.parts:
                for lo in range(0, T, 64):
                    rows = np.arange(lo, min(T, lo + 64))
                    base = self._shares(problem, rows, p0[rows], None)
                    big = [torch.zeros_like(b) for b in base]
                    for c in range(combos):
                        alt = self._shares(problem, rows, p0[rows], c)
                        big = [torch.maximum(m, torch.nan_to_num(
                            (a - b).abs(), nan=0.0, posinf=0.0))
                            for m, a, b in zip(big, alt, base)]
                    for o, m in zip(out, big):
                        o[lo:lo + len(rows)] += 2 * m.sum(1)
                    self._count += int(((big[0] > 0).flatten(2).any(-1)
                                        | (big[2] > 0)).sum())
            self._slack = [o.cpu() for o in out]
        return self._slack

    def start_rtol(self):
        return None

    def start_excused(self):
        return None

    def witness(self, rows, p_now, p_new, lam, accept):
        ok = np.zeros(len(rows), bool)
        at = (self.margins(rows, p_now) <= 1) | (self.margins(rows, p_new)
                                                 <= 1)
        idx = np.nonzero(at)[0]
        for c in range(self.combos):
            if not len(idx):
                break
            cost, new = self.problem.step(
                rows[idx], p_now[idx], lam[idx], torch.float64,
                lambda r, q: self.offsets(r, q, c))
            hit = (new < cost) == accept[idx]
            ok[idx[hit]] = True
            idx = idx[~hit]
        return ok

    def report(self):
        self.start_slack()
        return {"corner_residuals": self._count}


def _check_lm(kernel_ne, kernel_solve, plain_ne, plain_solve, residual,
              retract, D, aux, shared, params0, data, terms, num_iterations,
              kernels, corner=None, faults=None, end_distance=None):
    """A kernel held to plain on one input: (normal equations, solve);
    ``corner`` the input's :class:`RowCorners` or
    :class:`ResidualCorners`.  ``faults`` {name: data -> data}: controls,
    each the kernel fed a faulty input and held to plain's clean one,
    which the comparison must refuse (the solve compared where the
    normal equations pass); their outcome is the normal equations'
    ``fault_controls`` and a control passed fails ``ok``.
    ``end_distance`` as :func:`compare_solve` takes it."""
    d64 = type(data)(*(x.detach().cpu().double() if x.is_floating_point()
                       else x.detach().cpu() for x in data))
    ne_64 = plain_ne(params0.detach().cpu().double(), d64, terms)
    problem = RowProblem(residual(terms), retract, D, aux(data), shared)
    R = residual(terms)(params0, *aux(data)).shape[1]
    R = np.full(params0.shape[0], float(R))
    ne_p = plain_ne(params0, data, terms)
    moves = []
    p0 = params0.detach().cpu()
    data_cpu = type(data)(*(x.detach().cpu() for x in data))
    for k in range(p0.shape[1]):
        for sgn in (1.0, -1.0):
            pm = p0.clone()
            pm[:, k] = torch.nextafter(pm[:, k], torch.full_like(
                pm[:, k], sgn * np.inf))
            moves.append(plain_ne(pm, data_cpu, terms))
    rules = Rules(sums=abs_sums(params0, residual(terms), retract, D,
                                aux(data)), moves=moves, corner=corner)
    noise = (R, problem.noise(np.arange(len(R)), params0.cpu().numpy()))
    ne_k = kernel_ne(params0, data, terms) if kernels else ne_p
    res_ne = compare_normal_equations(ne_k, ne_p, ne_64, noise=noise,
                                      rules=rules)
    rows_p = []
    res_p = plain_solve(params0, data, terms, num_iterations, rows_p)
    tr_p = torch.stack(rows_p, 1)

    def held(d):
        res_k, tr_k = kernel_solve(params0, d, terms, num_iterations,
                                   trace=True)
        return compare_solve(res_k, tr_k, res_p, tr_p, problem, R,
                             rules=rules, end_distance=end_distance)

    res = held(data) if kernels else compare_solve(
        res_p, tr_p, res_p, tr_p, problem, R, rules=rules,
        end_distance=end_distance)
    if faults:
        out = {}
        for name, fault in faults.items():
            bad = fault(data)
            c = compare_normal_equations(kernel_ne(params0, bad, terms),
                                         ne_p, ne_64, noise=noise,
                                         rules=rules)
            out[name] = {"refused": not (c["ok"] and held(bad)["ok"]),
                         "max_err_over_tol": c["max_err_over_tol"]}
        res_ne["fault_controls"] = out
        res_ne["ok"] = res_ne["ok"] and all(v["refused"]
                                            for v in out.values())
    return res_ne, res


# Planted faults that kernel K's check must refuse (each a change of the
# kernel side's input): a heatmap term off by 5 %, the feature term's
# target sample negated (reference plus target: the whole residual's sign
# would leave the normal equations as they are), reference and target
# patches swapped.
REFINE_FAULTS = {
    "heatmap x 1.05": lambda d: d._replace(hm_patch=d.hm_patch * 1.05),
    "feature target negated": lambda d: d._replace(
        fc_tgt_patch=-d.fc_tgt_patch),
    "feature patches swapped": lambda d: d._replace(
        fc_ref_patch=d.fc_tgt_patch, fc_tgt_patch=d.fc_ref_patch),
}


def check_refine(params0, data, terms, num_iterations=20, kernels=True):
    """K held to plain on one input: (normal equations, solve), with the
    planted faults its terms reach (``REFINE_FAULTS``) as controls, each
    of which must be refused."""
    from limap_tpu_torch.ops import lm_line_refine as K
    faults = {}
    if terms.use_heatmap:
        faults.update(list(REFINE_FAULTS.items())[:1])
    if terms.use_fconsis and bool((data.fc_w > 0).any()):
        faults.update(list(REFINE_FAULTS.items())[1:])
    return _check_lm(K.normal_equations, K.solve, K.normal_equations_plain,
                     K.solve_plain, K.refine_residual, lm.retract_quat_so2,
                     4, K.plain_aux, K.SHARED, params0, data, terms,
                     num_iterations, kernels,
                     ResidualCorners(data, terms, params0)
                     if terms.use_heatmap or terms.use_fconsis else None,
                     faults, line_end_distance)


def check_assoc_lines(params0, data, terms, num_iterations=10,
                      kernels=True):
    """L held to plain on one input: (normal equations, solve)."""
    from limap_tpu_torch.ops import lm_assoc as LA
    return _check_lm(LA.normal_equations_lines, LA.solve_lines,
                     LA.normal_equations_lines_plain, LA.solve_lines_plain,
                     LA.line_residual, lm.retract_quat_so2, 4, LA.line_aux,
                     LA.LINE_SHARED, params0, data, terms, num_iterations,
                     kernels, RowCorners(assoc_corner_lines(data, terms),
                                         params0), None, line_end_distance)


def check_assoc_points(params0, data, terms, num_iterations=10,
                       kernels=True):
    """M held to plain on one input: (normal equations, solve)."""
    from limap_tpu_torch.ops import lm_assoc as LA
    return _check_lm(LA.normal_equations_points, LA.solve_points,
                     LA.normal_equations_points_plain, LA.solve_points_plain,
                     LA.point_residual, LA.retract_add, 3, LA.point_aux,
                     LA.POINT_SHARED, params0, data, terms, num_iterations,
                     kernels, RowCorners(assoc_corner_points(data), params0))


# Scalar operations of K, L and M by hand from their sources (as OPS
# above; a Jet<D> operation counts D + 1): per item the Jet evaluation
# and the float one of the new cost.
OPS_KLM = {
    # the VP term: quat_rotate 30, normalize3 10, cross 9, norm 6, scale 1
    "vp": 56, "vp_const": 18,
    # a heatmap anchor: the foot 15, pa and pb 9, the cell and offsets 8,
    # one channel 12, the residual 2
    "anchor": 46, "anchor_const": 6, "anchor_inside": 4,
    # a feature term: two line projections 178, two intersections 24,
    # the epipolar line 80, the two cells 16; a channel 26 (two samples
    # and the difference and scale); constants (the reference rotation
    # and offset) 70
    "fterm": 298, "fchannel": 26, "fterm_const": 70,
    # a point or VP slot of L (point distance 35; sine 17 + 7 float)
    "pslot": 35, "vslot": 17, "vslot_const": 7,
    # M: a reprojection 44, a line slot's distance 35 and Plücker 44
    # (float, per evaluation), the 3x3 step
    "reproj": 44, "lslot": 35, "plucker": 44, "solve3": 9 + 20 + 18 + 6 + 4,
}


def ops_line_refine(counts, rows, iterations, C=6):
    """Operations of K: ``counts`` the weighted items of the solve
    (geometric supports, VP supports, heatmap anchors of weighted
    supports, feature terms)."""
    geo, vp, anchors, fterms = (counts[k] for k in (
        "geometric", "vp", "anchors", "fconsis_terms"))
    per_row = 5 * (OPS["ba_retract"] + OPS["ba_plucker"]) \
        + OPS["ba_retract"] + OPS["ba_plucker"] + OPS["solve4"]
    acc = accumulate_ops(4)
    jet_geo = 5 * (OPS["ba_support"] + 2) + OPS["irls"] + 2 * acc
    flt_geo = OPS["ba_support"] + 2 + OPS["irls"] + 4
    per_vp = 6 * OPS_KLM["vp"] + acc + 2
    per_anchor = 6 * OPS_KLM["anchor"] + acc + OPS_KLM["anchor_inside"] * 2 \
        + 2
    fch = OPS_KLM["fchannel"]
    per_fterm = 6 * (OPS_KLM["fterm"] + C * fch) + C * (acc + 2) + 16
    return iterations * (rows * per_row + geo * (jet_geo + flt_geo)
                         + vp * per_vp + anchors * per_anchor
                         + fterms * per_fterm) \
        + vp * OPS_KLM["vp_const"] + anchors * OPS_KLM["anchor_const"] \
        + fterms * OPS_KLM["fterm_const"]


def ops_assoc_lines(counts, rows, iterations):
    """Operations of L: ``counts`` its weighted supports, point slots and
    VP slots."""
    per_row = 5 * (OPS["ba_retract"] + OPS["ba_plucker"]) \
        + OPS["ba_retract"] + OPS["ba_plucker"] + OPS["solve4"]
    acc = accumulate_ops(4)
    jet_geo = 5 * (OPS["ba_support"] + 2) + OPS["irls"] + 2 * acc
    flt_geo = OPS["ba_support"] + 2 + OPS["irls"] + 4
    return iterations * (rows * per_row
                         + counts["geometric"] * (jet_geo + flt_geo)
                         + counts["point_slots"] * (6 * OPS_KLM["pslot"]
                                                    + acc + 2)
                         + counts["vp_slots"] * (6 * OPS_KLM["vslot"] + acc
                                                 + 2 * OPS_KLM["vslot_const"]
                                                 + 2))


def ops_assoc_points(counts, rows, iterations):
    """Operations of M: ``counts`` its observations and line slots."""
    acc = accumulate_ops(3)
    per_row = 4 * 3 + 3 + OPS_KLM["solve3"]
    per_obs = 5 * OPS_KLM["reproj"] + 2 * acc + 4
    per_slot = 5 * OPS_KLM["lslot"] + 2 * OPS_KLM["plucker"] + acc + 2
    return iterations * (rows * per_row + counts["observations"] * per_obs
                         + counts["line_slots"] * per_slot)


def refine_counts(data, terms):
    w = data.weights > 0
    return {"geometric": int(w.sum()) if terms.use_geometric else 0,
            "vp": int((data.vp_w > 0).sum()),
            "anchors": int(w.sum()) * data.hm_patch.shape[2]
            if terms.use_heatmap else 0,
            "fconsis_terms": int((data.fc_w > 0).sum())
            if terms.use_fconsis else 0}


def assoc_line_counts(data, terms):
    return {"geometric": int((data.weights > 0).sum()),
            "point_slots": int((data.pt_w > 0).sum()),
            "vp_slots": int((data.vp_w > 0).sum()) if terms.use_vps else 0}


def assoc_point_counts(data):
    return {"observations": int(data.mask.sum()),
            "line_slots": int((data.ln_w > 0).sum())}


VIEW_BYTES = 44   # kvec, qvec, tvec


def bytes_line_refine(params0, data, terms):
    """What K must move, each input read once and each output written
    once: every slot's weights (to know which are empty); a weighted
    support's view, its segment (a geometric weight), its VP (a VP
    weight) and its heatmap frame; a feature term's view rows, sample
    line and patch origins, and the views it names once each; of the
    patches only the texels that the samples at params0 read (the heatmap
    cells of the weighted anchors inside their patches, each texel once;
    a feature term inside both patches 4 texels a channel each side);
    params0 and the results."""
    d = [t.detach().cpu() for t in data]
    (T, S), F = d[5].shape, d[23].shape[1]
    w, vw, fw = d[5] > 0, d[7] > 0, d[23] > 0
    n = 4 * (2 * T * S + T * F) + T * (24 + 36)
    n += VIEW_BYTES * int((w | vw).sum()) + 16 * int(w.sum()) \
        + 12 * int(vw.sum())
    c = refine_coords(d, terms, np.arange(T), params0.detach().cpu().double())
    if terms.use_heatmap:
        A, Pa = d[8].shape[2:]
        pa, on = c["pa"]
        pb = c["pb"][0]
        inside = on & (pa >= 0) & (pa <= A - 1) & (pb >= 0) & (pb <= Pa - 1)
        y0 = torch.clamp(torch.floor(pa), 0, A - 2).long()
        x0 = torch.clamp(torch.floor(pb), 0, Pa - 2).long()
        texels = torch.zeros((T, S, A, Pa), dtype=torch.bool)
        t, s_, a = torch.nonzero(inside, as_tuple=True)
        for dy in (0, 1):
            for dx in (0, 1):
                texels[t, s_, y0[t, s_, a] + dy, x0[t, s_, a] + dx] = True
        n += 28 * int(w.sum()) + 4 * int(texels.sum())
    if terms.use_fconsis and F:
        Pp, C = d[19].shape[3:]
        inside = fw.clone()
        for k in ("rx", "ry", "tx", "ty"):
            inside &= (c[k][0] >= 0) & (c[k][0] <= Pp - 1)
        views = torch.cat([d[16][fw], d[17][fw]]).unique().numel()
        n += 36 * int(fw.sum()) + VIEW_BYTES * views \
            + 2 * 4 * C * 4 * int(inside.sum())
    return n


def bytes_assoc_lines(data, terms):
    """What L must move: every slot's weights, a weighted support's view
    and segment, a weighted point or VP slot's index and each point or VP
    named once, params0 and the results."""
    d = [t.detach().cpu() for t in data]
    T, S = d[5].shape
    A = d[7].shape[1]
    w, pw, vw = d[5] > 0, d[7] > 0, (d[9] > 0) & terms.use_vps
    return (4 * (T * S + 2 * T * A) + T * (24 + 24 + 12)
            + (VIEW_BYTES + 16) * int(w.sum())
            + 4 * int(pw.sum()) + 12 * d[6][pw].unique().numel()
            + 4 * int(vw.sum()) + 12 * d[8][vw].unique().numel())


def bytes_assoc_points(data):
    """What M must move: every slot's mask and line weight, an
    observation's view row and 2D point and each view observed once, a
    weighted line slot's index and each line named once, params0 and the
    results."""
    d = [t.detach().cpu() for t in data]
    P, S = d[5].shape
    A = d[7].shape[1]
    obs, lw = d[5], d[7] > 0
    return (P * S + 4 * P * A + P * (12 + 12 + 12) + 12 * int(obs.sum())
            + VIEW_BYTES * d[3][obs].unique().numel()
            + 4 * int(lw.sum()) + 24 * d[6][lw].unique().numel())


def check_all_klm(device="cuda", kernels=None):
    """K, L and M on their seeded inputs: yields (name, case, result);
    ``kernels`` False compares plain with itself (the default on the
    CPU)."""
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    kernels = device != "cpu" if kernels is None else kernels
    params0, data = seeded_refine(seed=5, device=device)
    for which in REFINE_CASES:
        d, terms = refine_case(params0, data, which)
        ne, sol = check_refine(params0, d, terms, kernels=kernels)
        yield "lm_line_refine normal equations", f"seeded, {which}", ne
        yield "lm_line_refine solve", f"seeded, {which}", sol
    lp, ldata, pp, pdata = seeded_assoc(seed=6, device=device)
    for use_vps in (True, False):
        terms = AssocTerms(use_vps=use_vps)
        ne, sol = check_assoc_lines(lp, ldata, terms, kernels=kernels)
        case = "seeded, " + ("with VPs" if use_vps else "without VPs")
        yield "lm_assoc_lines normal equations", case, ne
        yield "lm_assoc_lines solve", case, sol
    full = pdata
    empty = pdata._replace(ln_w=torch.zeros_like(pdata.ln_w))
    slots = full._replace(ln_w=torch.where(
        full.ln_w > 0, full.ln_w, torch.full_like(full.ln_w, 3.0)))
    for case, d in (("empty slots", empty), ("seeded slots", full),
                    ("full slots", slots)):
        ne, sol = check_assoc_points(pp, d, AssocTerms(), kernels=kernels)
        yield "lm_assoc_points normal equations", f"seeded, {case}", ne
        yield "lm_assoc_points solve", f"seeded, {case}", sol


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
    from limap_tpu_torch.ops import (cuda_build, lm_assoc, lm_jointloc,
                                     lm_line_ba, lm_line_refine)
    for m in (lm_line_ba, lm_jointloc, lm_line_refine, lm_assoc):
        m.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}")
    ok = True
    for checks in (check_all, check_all_klm):
        for name, case, res in checks("cuda"):
            print(f"{name}, {case}: {json.dumps(res)}", flush=True)
            ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
