"""Torch replays of the Hopper designs of kernels I (csrc/lm_jointloc.cu)
and B (csrc/trace_roots.cu), for tests of their order on the CPU.

I: :func:`team_items` lays a chain's active matches out over a team as
the kernel's compaction does, and :func:`fused_solve` runs the kernel's
loop on each chain's compacted matches: one pass an iteration at the
trial parameters (its cost and its normal equations), the normal
equations kept on a rejected step.

B: :func:`sign_change_cells` and :func:`minima_cells` pick the roots'
grid cells by the kernel's warp votes and arg-min butterflies,
:func:`tree_roots` walks the roots' bisection and ternary steps as the
kernel's trees in the phases of ``ops/trace_roots.py::plan``, and
:func:`serial_roots` runs the first design's serial loops, all on a
[B, 32] lane layout through one evaluation of G; :func:`serial_cells`
is the first design's cell selection, instance by instance.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch.ops import lm_jointloc as I
from limap_tpu_torch.ops.trace_roots import family_eval, rot_axis_angle
from limap_tpu_torch.optimize import lm

LANES = 32


# ------------------------------------------------------------ kernel I
def line_warps(nla, npa, S, line_cost):
    """The warps of a team of S threads that take the lines alone, the
    others taking the points (0: both dealt over the whole team): the
    split where it lowers the slowest lane's cost, a line costing
    ``line_cost`` points (csrc/lm_jointloc.cu::line_cost)."""
    nw, best, wl = S // 32, line_cost * -(-nla // S) + -(-npa // S), 0
    for w in range(1, nw) if nla and npa else ():
        c = max(line_cost * -(-nla // (32 * w)), -(-npa // (32 * (nw - w))))
        if c < best:
            best, wl = c, w
    return wl


def team_items(lmask, pmask, S, order, line_cost=3):
    """The matches (line i, point nl + j) each of the S threads of a team
    visits, in its order: OWNER, match i on thread i mod S; BALANCED,
    the active lines in index order dealt round robin over the first
    :func:`line_warps` warps and the points over the others, or both
    over the team (the points continuing the lines' round).  Lines
    before points on every thread."""
    lmask, pmask = np.asarray(lmask, bool), np.asarray(pmask, bool)
    nl = len(lmask)
    lines, points = np.flatnonzero(lmask), nl + np.flatnonzero(pmask)
    if order == I.OWNER:
        return [[int(i) for i in lines if i % S == t]
                + [int(i) for i in points if i % S == t] for t in range(S)]
    sl = 32 * line_warps(len(lines), len(points), S, line_cost)
    if sl:
        return [[int(i) for i in lines[t::sl]] if t < sl
                else [int(i) for i in points[t - sl::S - sl]]
                for t in range(S)]
    return [[int(i) for i in lines[t::S]]
            + [int(i) for i in points[(t - len(lines)) % S::S]]
            for t in range(S)]


def compact_row(data, row):
    """Chain ``row``'s active matches as a problem of their own (lines,
    then points, in index order; every mask set): the data
    :func:`ops.lm_jointloc.solve_plain` takes, for one row."""
    l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv = data
    lk, pk = lmask[row], pmask[row]
    return (l3s[lk], l3e[lk], l2s[lk], l2e[lk],
            torch.ones((1, int(lk.sum())), dtype=torch.bool), p3[pk], p2[pk],
            torch.ones((1, int(pk.sum())), dtype=torch.bool), kv)


def fused_solve(params0, data, cfg, num_iterations=50, trace=None):
    """The kernel's loop, chain by chain, on each chain's compacted
    matches: the first pass at params0 gives cost0 and the normal
    equations; then an iteration solves the damped system, and one pass
    at the trial parameters gives their cost and (but at the last
    iteration) their normal equations, which replace the current ones
    only on an accepted step.  ``trace`` as ``lm.lm_solve`` takes it."""
    from limap_tpu_torch.ops.lm_jointloc import _residual, plain_aux
    rows, traces = [], []
    for t in range(params0.shape[0]):
        d = compact_row(data, t)
        fn, aux = _residual(cfg, d), plain_aux(*d)

        def cost_of(p):
            return torch.sum(fn(p, *aux) ** 2, dim=1)

        def ne_at(p):
            if not (d[0].shape[0] or d[5].shape[0]):   # nothing active
                return torch.zeros((1, I.D, I.D)), torch.zeros((1, I.D))
            return lm.normal_equations(p, fn, lm.retract_pose, I.D, aux)[:2]

        params = params0[t:t + 1]
        JTJ, JTr = ne_at(params)
        cost = cost_of(params)
        cost0, lam = cost, torch.full((1,), lm.LAMBDAS[0])
        n_acc = torch.zeros((1,), dtype=torch.int32)
        tr = []
        for it in range(num_iterations):
            diag = torch.diagonal(JTJ, dim1=-2, dim2=-1)
            A = JTJ + torch.diag_embed(lam[:, None]
                                       * torch.clamp(diag, min=1e-8))
            delta = torch.nan_to_num(-lm.solve_spd(A, JTr))
            new_params = lm.retract_pose(params, delta)
            new_cost = cost_of(new_params)
            accept = bool(new_cost < cost)
            tr.append(torch.cat([cost[:, None], new_cost[:, None], params,
                                 new_params], 1))
            if accept:
                params, cost = new_params, new_cost
                if it < num_iterations - 1:
                    JTJ, JTr = ne_at(params)
                n_acc = n_acc + 1
            lam = torch.clamp(lam * (lm.LAMBDAS[2] if accept
                                     else lm.LAMBDAS[1]),
                              lm.LAMBDAS[3], lm.LAMBDAS[4])
        rows.append((params, cost0, cost, n_acc))
        traces.append(tr)
    if trace is not None:
        trace.extend(torch.cat([tr[k] for tr in traces])
                     for k in range(num_iterations))
    return lm.LMResult(*(torch.cat(x) for x in zip(*rows)))


# ------------------------------------------------------------ kernel B
def lane_eval(v1, n1, C2, C3):
    """G of the instances at alpha [B, 32], one column a lane."""
    data = (v1[:, None], n1[:, None], C2[:, None], C3[:, None])
    return lambda alpha: family_eval(alpha, *data)[0]


def sign_change_cells(G, n_roots):
    """The first n_roots cells k with G[k] G[k + 1] < 0 by ballots over
    chunks of 32 cells in index order, the missing ones at cell 0 with
    cell 0's test as their flag: (cells [B, n_roots], flags)."""
    Bn, n_grid = G.shape[0], G.shape[1] - 1
    sc = G[:, :-1] * G[:, 1:] < 0.0
    sc = torch.cat([sc, sc.new_zeros((Bn, -n_grid % LANES))], 1)
    cells = torch.zeros((Bn, n_roots), dtype=torch.long)
    flags = torch.zeros((Bn, n_roots), dtype=torch.bool)
    found = torch.zeros(Bn, dtype=torch.long)
    lane = torch.arange(LANES)
    for c in range(sc.shape[1] // LANES):
        vote = sc[:, c * LANES:(c + 1) * LANES]
        rank = found[:, None] + torch.cumsum(vote.long(), 1) - vote.long()
        take = vote & (rank < n_roots)
        b, l = torch.nonzero(take, as_tuple=True)
        cells[b, rank[b, l]] = c * LANES + lane[l]
        flags[b, rank[b, l]] = True
        found += vote.sum(1)
    missing = torch.arange(n_roots)[None] >= torch.clamp(found, max=n_roots
                                                          )[:, None]
    flags = torch.where(missing, sc[:, :1].expand(-1, n_roots), flags)
    return cells, flags


def minima_cells(G, n_roots):
    """The n_roots interior minima of |G| with the smallest |G| (inf for
    the cells that are none), each the least (value, cell) after the
    previous pick: lane l's least over its cells l, l + 32, ..., then an
    xor butterfly.  Returns (cells i [B, n_roots]: the minimum is at
    grid point i + 1, is-a-minimum flags)."""
    Bn = G.shape[0]
    absG = torch.abs(G)
    ext = (absG[:, 1:-1] <= absG[:, :-2]) & (absG[:, 1:-1] <= absG[:, 2:])
    v = torch.where(ext, absG[:, 1:-1], torch.full_like(absG[:, 1:-1],
                                                        float("inf")))
    n = v.shape[1]
    big = torch.iinfo(torch.long).max
    pad = -n % LANES
    v = torch.cat([v, torch.full((Bn, pad), float("inf"))], 1)
    idx = torch.arange(n + pad).expand(Bn, -1)
    real = idx < n
    prev_v = torch.full((Bn, 1), -float("inf"))
    prev_i = torch.full((Bn, 1), -1, dtype=torch.long)
    lane = torch.arange(LANES)
    cells = []
    for _ in range(n_roots):
        after = real & ((v > prev_v) | ((v == prev_v) & (idx > prev_i)))
        cv = torch.where(after, v, torch.full_like(v, float("inf")))
        ci = torch.where(after, idx, torch.full_like(idx, big))
        cv = cv.reshape(Bn, -1, LANES)
        ci = ci.reshape(Bn, -1, LANES)
        bv = cv.amin(1)
        bi = torch.where(cv == bv[:, None], ci, torch.full_like(ci, big)
                         ).amin(1)
        for off in (16, 8, 4, 2, 1):
            ov, oi = bv[:, lane ^ off], bi[:, lane ^ off]
            take = (ov < bv) | ((ov == bv) & (oi < bi))
            bv, bi = torch.where(take, ov, bv), torch.where(take, oi, bi)
        prev_v, prev_i = bv[:, :1], bi[:, :1]
        cells.append(bi[:, 0])
    cells = torch.stack(cells, 1)
    return cells, torch.gather(ext, 1, cells)


def serial_cells(G, n_roots):
    """The first design's loops, instance by instance (numpy): (sign
    change cells, flags, minima cells, is-a-minimum flags)."""
    G = np.asarray(G, np.float32)
    out = [[], [], [], []]
    for g in G:
        n_grid = len(g) - 1
        idx = [k for k in range(n_grid) if g[k] * g[k + 1] < 0][:n_roots]
        sc0 = bool(g[0] * g[1] < 0)
        out[0].append(idx + [0] * (n_roots - len(idx)))
        out[1].append([True] * len(idx) + [sc0] * (n_roots - len(idx)))
        prev_v, prev_i, cells, exts = -np.inf, -1, [], []
        for _ in range(n_roots):
            best_v, best_i, best_ext = np.inf, -1, False
            for i in range(n_grid - 1):
                a = abs(g[i + 1])
                ext = bool(a <= abs(g[i]) and a <= abs(g[i + 2]))
                v = a if ext else np.inf
                if not (v > prev_v or (v == prev_v and i > prev_i)):
                    continue
                if best_i < 0 or v < best_v:
                    best_v, best_i, best_ext = v, i, ext
            prev_v, prev_i = best_v, best_i
            cells.append(best_i)
            exts.append(best_ext)
        out[2].append(cells)
        out[3].append(exts)
    return tuple(torch.as_tensor(np.asarray(x)) for x in out)


def _intervals(G, alphas, cells, mcells):
    """The roots' starting intervals: (lo, hi [B, 2 n_roots], G(lo) of
    the simple roots [B, n_roots])."""
    lo = torch.cat([alphas[cells], alphas[mcells]], 1)
    hi = torch.cat([alphas[cells + 1], alphas[mcells + 2]], 1)
    return lo, hi, torch.gather(G, 1, cells)


def serial_roots(geval, lo, hi, glo, n_bisect):
    """The first design's loops on the lane layout: simple root r on lane
    r, double root r's m1 on lane 8 + r and m2 on lane 16 + r, one step a
    round.  Returns the roots [B, 2 n_roots]."""
    Bn, n = glo.shape
    lo, hi, glo = lo.clone(), hi.clone(), glo.clone()
    for _ in range(n_bisect):
        mid = 0.5 * (lo[:, :n] + hi[:, :n])
        m1 = lo[:, n:] + (hi[:, n:] - lo[:, n:]) / 3.0
        m2 = hi[:, n:] - (hi[:, n:] - lo[:, n:]) / 3.0
        x = torch.zeros((Bn, LANES))
        x[:, :n], x[:, 8:8 + n], x[:, 16:16 + n] = mid, m1, m2
        g = geval(x)
        gm, h1, h2 = g[:, :n], g[:, 8:8 + n], g[:, 16:16 + n]
        take = glo * gm < 0.0
        hi[:, :n] = torch.where(take, mid, hi[:, :n])
        lo[:, :n] = torch.where(take, lo[:, :n], mid)
        glo = torch.where(take, glo, gm)
        take = h1 * h1 < h2 * h2
        hi[:, n:] = torch.where(take, m2, hi[:, n:])
        lo[:, n:] = torch.where(take, lo[:, n:], m1)
    return 0.5 * (lo + hi)


def _roles(n, ds, dd):
    """Each lane's root (kind 1 simple, 2 double, 0 none), that root's
    first lane, the lane's node (1 the tree's root) and point (0 m1, 1
    m2), as the kernel assigns them in a phase."""
    ws, wd = (1 << ds) - 1 if ds else 0, 2 * ((1 << dd) - 1) if dd else 0
    kind, job, base = np.zeros(LANES, int), np.zeros(LANES, int), \
        np.arange(LANES)
    node, which = np.ones(LANES, int), np.zeros(LANES, int)
    for lane in range(LANES):
        if lane < n * ws:
            kind[lane], job[lane] = 1, lane // ws
            base[lane] = job[lane] * ws
            node[lane] = lane - base[lane] + 1
        elif lane - n * ws < n * wd:
            o = lane - n * ws
            jd = o // wd
            kind[lane], job[lane] = 2, n + jd
            base[lane] = n * ws + jd * wd
            node[lane], which[lane] = (o - jd * wd) // 2 + 1, (o - jd * wd) % 2
    return kind, job, base, node, which


def tree_roots(geval, lo, hi, glo, n_bisect, phases):
    """The kernel's trees: in each phase (simple depth, double depth,
    rounds) a lane replays its node's path from its root's interval and
    evaluates its node's point, then the root's lanes walk the levels
    with the serial rule.  Returns the roots [B, 2 n_roots]."""
    Bn, n = glo.shape
    jlo, jhi, jglo = lo.clone(), hi.clone(), glo.clone()
    done_s = done_d = 0
    lanes = torch.arange(LANES).expand(Bn, -1)
    for ds, dd, rounds in phases:
        kind, job, base, node, which = (torch.as_tensor(x) for x in
                                        _roles(n, ds, dd))
        simple, double = (kind == 1)[None], (kind == 2)[None]
        level = torch.as_tensor([int(v).bit_length() - 1 for v in node])
        zero = torch.zeros((Bn, LANES))
        lo = torch.where(kind[None] > 0, jlo[:, job], zero)
        hi = torch.where(kind[None] > 0, jhi[:, job], zero)
        gl = torch.where(simple, jglo[:, torch.clamp(job, max=n - 1)], zero)
        for _ in range(rounds):
            Ls = min(ds, n_bisect - done_s) if ds else 0
            Ld = min(dd, n_bisect - done_d) if dd else 0
            L = torch.where(kind == 1, Ls, torch.where(kind == 2, Ld, 0))
            a, c = lo.clone(), hi.clone()
            for bit in range(int(level.max()) - 1, -1, -1):
                on = (bit < level)[None]
                right = (((node >> bit) & 1) == 1)[None]
                mid = 0.5 * (a + c)
                m1 = a + (c - a) / 3.0
                m2 = c - (c - a) / 3.0
                a, c = (torch.where(on & right,
                                    torch.where(simple, mid, m1), a),
                        torch.where(on & ~right,
                                    torch.where(simple, mid, m2), c))
            x = torch.where(simple, 0.5 * (a + c),
                            torch.where((which == 1)[None], c - (c - a) / 3.0,
                                        a + (c - a) / 3.0))
            active = ((kind > 0) & (level < L))[None].expand(Bn, -1)
            g = torch.where(active, geval(torch.where(active, x, zero)),
                            zero)
            at = torch.ones((Bn, LANES), dtype=torch.long)
            for step in range(max(Ls, Ld)):
                src = torch.where(simple, base + at - 1,
                                  torch.where(double, base + 2 * (at - 1),
                                              lanes))
                h1 = g.gather(1, src)
                h2 = g.gather(1, torch.where(double, src + 1, lanes))
                on = (step < L)[None]
                mid = 0.5 * (lo + hi)
                m1 = lo + (hi - lo) / 3.0
                m2 = hi - (hi - lo) / 3.0
                left = torch.where(simple, gl * h1 < 0.0, h1 * h1 < h2 * h2)
                hi = torch.where(on & left, torch.where(simple, mid, m2), hi)
                lo = torch.where(on & ~left, torch.where(simple, mid, m1),
                                 lo)
                gl = torch.where(on & ~left & simple, h1, gl)
                at = torch.where(on & (kind > 0)[None],
                                 2 * at + (~left).long(), at)
            done_s += Ls
            done_d += Ld
        for lane in range(LANES):
            if kind[lane] > 0 and base[lane] == lane:
                jlo[:, job[lane]], jhi[:, job[lane]] = lo[:, lane], hi[:, lane]
                if kind[lane] == 1:
                    jglo[:, job[lane]] = gl[:, lane]
    return 0.5 * (jlo + jhi)


def trace_roots_replay(v1, n1, C2, C3, alphas, n_bisect=48, n_roots=8,
                       phases=None, serial=False):
    """The kernel's (R [B, 2 n_roots, 3, 3], ok, roots): G on the grid,
    the cells by votes and butterflies, the roots by the trees of
    ``phases`` (``plan``'s by default) or with ``serial`` by the first
    design's loops, then the rotations as trace_roots_plain takes them."""
    from limap_tpu_torch.ops.trace_roots import plan
    data = (v1[:, None], n1[:, None], C2[:, None], C3[:, None])
    G, _, det, _, _ = family_eval(alphas.expand(v1.shape[0], -1), *data)
    g_scale = torch.abs(G).amax(1, keepdim=True) + 1e-12
    det_scale = torch.abs(det).amax(1, keepdim=True) + 1e-12
    cells, flags = sign_change_cells(G, n_roots)
    mcells, ext = minima_cells(G, n_roots)
    lo, hi, glo = _intervals(G, alphas, cells, mcells)
    geval = lane_eval(v1, n1, C2, C3)
    roots = serial_roots(geval, lo, hi, glo, n_bisect) if serial else \
        tree_roots(geval, lo, hi, glo, n_bisect,
                   plan(n_roots, n_bisect) if phases is None else phases)
    Gr, beta, det_r, d, R0 = family_eval(roots, *data)
    ok = torch.cat([flags, ext & (torch.abs(Gr[:, n_roots:])
                                  < 1e-2 * g_scale)], 1)
    ok = ok & (torch.abs(det_r) > 1e-9 * det_scale)
    R = rot_axis_angle(d, beta) @ R0
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=R.dtype).expand(R.shape)
    return torch.where(finite[..., None, None], R, eye), ok & finite, roots
