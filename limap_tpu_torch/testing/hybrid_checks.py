"""Kernels O, P and Q (``ops/hybrid_ba.py``) held to their plain versions.

``chip_smoke.py`` (phases 2 and 14) and ``tests/test_torch_cuda.py``
share these inputs and comparisons.

    python -m limap_tpu_torch.testing.hybrid_checks

builds the kernel library on one GPU and prints each comparison.

The kernels follow the plain versions' formulas, but they sum in another
order, invert the landmark block by their own elimination and round
their transcendentals their own way.  The reduced camera system is a
Schur complement, H_cc less H_cl H_ll^-1 H_cl^T, two terms of nearly the
same size, with H_ll^-1 as ill-conditioned as a track's geometry makes it
(a track seen once has a rank-2 block damped by lam alone).  So O is
checked in its two stages:

- each support's and track's own terms (H_cl, H_cc from the Jets; H_ll,
  b_l, the cost) against the plain version: the kernel's error against
  the plain float64 result within ``FACTOR`` times the plain float32
  result's own error, or within ``RTOL`` of the quantity's largest
  magnitude where that is larger.  The Jets' gradient g_c is not an
  output: it is g_red + A b_l, taken in float64 from each version's
  g_red, A and b_l, and held so with the further slack of ``GAMMA``
  times |g_red| + |A| |b_l| (the rounding of the kernel's g_red =
  g_c - A b_l);
- the elimination and the assembly from the kernel's own terms, computed
  again in float64: H_ll^-1 within ``INV_C`` eps cond(H_ll + lam) of its
  size (per track), A = H_cl H_ll^-1 and the reduced system's g, diag0
  and matrix within ``GAMMA`` of the sum of their contributions'
  magnitudes (computed beside them).

The kernel leaves the per-support factors of a slot of weight 0
unwritten; the checks read them as 0, as the plain version writes them.

P is held the same way to the plain product on the kernel's own terms,
and to its first design (``hybrid_apply_scan``) bit for bit
(:func:`check_all_scan`), Q to the plain cost within ``COST_RTOL``.  Every kernel must repeat its
results bit for bit (no atomics; the LM's accept test compares two of
Q's values).
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

FACTOR = 8.0
RTOL = 1e-6
GAMMA = 1e-5
INV_C = 16.0
EPS32 = 2.0 ** -24
COST_RTOL = 1e-5
OWN_TERMS = ("H_cl", "H_cc", "H_ll", "b_l", "cost")
ELIMINATED = ("Hinv", "A", "g", "diag0", "Hp")
PER_SUPPORT = ("H_cl", "H_cc", "A", "g_red")
CHUNK = 1 << 22     # floats of S_red a chunk of the float64 assembly


def _t(x, device, dtype=None):
    t = torch.as_tensor(np.asarray(x), device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def seeded_problem(seed=0, n_views=8, n_lines=24, n_points=40, S=6, Sp=None,
                   n_cameras=2, ragged=True, device="cuda"):
    """A scene as the hybrid BA meets it: views along a street looking at
    a wall 8 m away, line tracks with S support slots (images drawn with
    repeats, so a track may see an image twice) and point tracks with Sp,
    2D observations projected from the true geometry with 0.5 px noise,
    and a state with poses (all but the first two), lines and points
    perturbed.  ``ragged`` gives slots weight 0 at random (and some tracks
    none at all).  Returns (state, line_data, point_data, n_images,
    n_cameras)."""
    from limap_tpu_torch.base.infinite_line import MinimalInfiniteLines3d
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.base.pose import axis_angle_to_quat, quat_multiply
    from limap_tpu_torch.optimize.line_ba import pack_minimal_lines
    from limap_tpu_torch.parallel.sharded_ba import HybridBAState

    rng = np.random.default_rng(seed)
    Sp = S if Sp is None else Sp
    I = n_views
    cam_of = rng.integers(0, n_cameras, I)
    fxfy = rng.uniform(480, 520, (n_cameras, 2))
    cxcy = np.array([320.0, 240.0])
    aa = rng.normal(size=(I, 3)) * 0.05
    q = axis_angle_to_quat(torch.as_tensor(aa)).numpy()
    t = np.stack([-0.4 * np.arange(I) + 1.4, rng.normal(size=I) * 0.05,
                  rng.normal(size=I) * 0.05], 1)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()

    def project(X, i):
        pc = np.einsum("...ij,...j->...i", R[i], X) + t[i]
        return pc[..., :2] / pc[..., 2:] * fxfy[cam_of[i]] + cxcy

    def slots(T, S):
        img = rng.integers(0, I, (T, S))
        w = rng.uniform(0.5, 2.0, (T, S))
        if ragged:
            w[rng.random((T, S)) < 0.3] = 0.0
            w[rng.random(T) < 0.1] = 0.0
        return img, w

    st = rng.normal(size=(n_lines, 3)) * [2.0, 1.0, 0.5] + [0, 0, 8]
    en = st + rng.normal(size=(n_lines, 3)) * [1.0, 1.0, 0.2]
    img_l, w_l = slots(n_lines, S)
    ts = rng.uniform(-0.1, 0.1, (n_lines, S, 2)) + [0, 1]
    p1 = st[:, None] + ts[..., :1] * (en - st)[:, None]
    p2 = st[:, None] + ts[..., 1:] * (en - st)[:, None]
    l2s = np.stack([project(p1[:, s], img_l[:, s]) for s in range(S)], 1)
    l2e = np.stack([project(p2[:, s], img_l[:, s]) for s in range(S)], 1)
    l2s = l2s + rng.normal(size=l2s.shape) * 0.5
    l2e = l2e + rng.normal(size=l2e.shape) * 0.5
    pts = rng.normal(size=(n_points, 3)) * [2.0, 1.0, 0.5] + [0, 0, 8]
    img_p, w_p = slots(n_points, Sp)
    p2d = np.stack([project(pts, img_p[:, s]) for s in range(Sp)], 1) \
        + rng.normal(size=(n_points, Sp, 2)) * 0.5

    f32 = torch.float32
    dq = axis_angle_to_quat(torch.as_tensor(rng.normal(size=(I, 3)) * 0.01))
    qn = quat_multiply(dq, torch.as_tensor(q)).numpy()
    tn = t + rng.normal(size=(I, 3)) * 0.02
    qn[:2], tn[:2] = q[:2], t[:2]
    pose = np.concatenate([qn, tn], 1)
    stn = st + rng.normal(size=st.shape) * 0.03
    enn = en + rng.normal(size=en.shape) * 0.03
    lines = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(Segments(
        torch.as_tensor(stn, dtype=f32), torch.as_tensor(enn, dtype=f32))))
    kv = lambda img: np.concatenate(
        [fxfy[cam_of[img]], np.broadcast_to(cxcy, img.shape + (2,))], -1)
    state = HybridBAState(
        lines.to(device), _t(pts + rng.normal(size=pts.shape) * 0.05, device,
                             f32),
        _t(pose, device, f32), _t(fxfy, device, f32))
    i32 = lambda a: _t(a.astype(np.int32), device)
    line_data = (_t(kv(img_l), device, f32), i32(cam_of[img_l]), i32(img_l),
                 _t(l2s, device, f32), _t(l2e, device, f32),
                 _t(w_l, device, f32))
    point_data = (_t(kv(img_p), device, f32), i32(cam_of[img_p]), i32(img_p),
                  _t(p2d, device, f32), _t(w_p, device, f32))
    return state, line_data, point_data, I, n_cameras


def _double(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def compare(k, p, p64):
    """(ok, kernel error, plain error, scale) of a float32 kernel result
    ``k`` and plain result ``p`` against the plain float64 ``p64``."""
    k, p, p64 = (x.detach().double().cpu() for x in (k, p, p64))
    if k.shape != p64.shape:
        return False, float("inf"), 0.0, 0.0
    if not torch.isfinite(p64).all():
        same = torch.equal(torch.isfinite(k), torch.isfinite(p64))
        fin = torch.isfinite(p64)
        k, p, p64 = k[fin], p[fin], p64[fin]
    else:
        same = bool(torch.isfinite(k).all())
    if k.numel() == 0:
        return same, 0.0, 0.0, 0.0
    ek = float((k - p64).abs().max())
    ep = float((p - p64).abs().max())
    scale = float(p64.abs().max())
    ok = same and ek <= FACTOR * max(ep, RTOL * scale)
    return ok, ek, ep, scale


def _parts(kind, state, data):
    land = state.line_params if kind == "line" else state.point_params
    obs = (data[3], data[4]) if kind == "line" else (data[3],)
    return land, data[:3], obs, data[-1]


def assembled(terms, absolute=False):
    """(g, diag0, Hp or None) of the reduced system from a Terms' own
    factors (A, H_cl, H_cc, g_red) in their dtype, in chunks of tracks;
    with ``absolute`` the sums of the contributions' magnitudes."""
    from limap_tpu_torch.parallel import sharded_ba as sb
    from limap_tpu_torch.ops.hybrid_ba import dims
    D = dims(terms.n_images, terms.n_cameras, terms.focal)
    f = torch.abs if absolute else (lambda x: x)
    T, S, Dc, L = terms.A.shape
    g = terms.A.new_zeros(D)
    diag0 = terms.A.new_zeros(D)
    Hp = terms.A.new_zeros((D, D)) if terms.Hp is not None else None
    step = max(1, CHUNK // max(1, S * S * Dc * Dc))
    for a in range(0, T, step):
        sl = slice(a, min(T, a + step))
        A, H_cl, H_cc = terms.A[sl], terms.H_cl[sl], terms.H_cc[sl]
        cols = terms.cols[sl]
        g = g + sb._scatter_g(D, cols, f(terms.g_red[sl]))
        self_red = torch.einsum("spa,spa->sp", f(A).flatten(0, 1),
                                f(H_cl).flatten(0, 1)).reshape(A.shape[:3])
        dg = torch.diagonal(f(H_cc), dim1=-2, dim2=-1)
        diag0 = diag0 + sb._scatter_g(
            D, cols, dg + self_red if absolute else dg - self_red)
        if Hp is not None:
            S_red = torch.einsum("tspa,tuqa->tsupq", f(A), f(H_cl))
            Hp = Hp + sb._accumulate_dense(D, cols, f(H_cc),
                                           S_red if absolute else -S_red)
    return g, diag0, Hp


def _within(a, ref, mag, gamma=GAMMA):
    """(ok, max error, max allowed) of ``a`` against float64 ``ref``,
    entry by entry within gamma times ``mag``."""
    a, ref, mag = (x.detach().double() for x in (a, ref, mag))
    err = (a.to(ref.device) - ref).abs()
    allowed = gamma * mag + 1e-30
    fin = torch.isfinite(ref)
    ok = bool(torch.isfinite(a.to(ref.device)[fin]).all()) and bool(
        (err[fin] <= allowed[fin]).all())
    return ok, float(err[fin].max()) if fin.any() else 0.0, \
        float(allowed[fin].max()) if fin.any() else 0.0


def _to64(terms):
    names = ("Hinv", "b_l", "H_cl", "H_cc", "H_ll", "A", "g_red")
    return terms._replace(**{n: _double(getattr(terms, n)) for n in names},
                          Hp=None if terms.Hp is None else terms.Hp.double())


def weighted_only(terms):
    """``terms`` with the per-support factors of every slot of weight 0
    set to 0 (the kernel leaves them unwritten)."""
    w = terms.weight > 0
    return terms._replace(**{
        n: torch.where(w.reshape(w.shape + (1,) * (getattr(terms, n).dim()
                                                   - 2)),
                       getattr(terms, n), 0.0) for n in PER_SUPPORT})


def _g_c(terms):
    """(g_red + A b_l, |g_red| + |A| |b_l|) in float64."""
    t = _to64(terms)
    return (t.g_red + torch.einsum("tspa,ta->tsp", t.A, t.b_l),
            t.g_red.abs() + torch.einsum("tspa,ta->tsp", t.A.abs(),
                                         t.b_l.abs()))


def compare_g_c(k, p, p64):
    """(ok, kernel error beyond the slack, plain error, scale) of the
    Jets' gradient g_c (see the module docstring)."""
    (gk, mag), (gp, _), (g64, _) = _g_c(k), _g_c(p), _g_c(p64)
    gk, mag, gp, g64 = (x.cpu() for x in (gk, mag, gp, g64))
    if gk.numel() == 0:
        return True, 0.0, 0.0, 0.0
    ek = float(((gk - g64).abs() - GAMMA * mag).clamp(min=0).max())
    ep = float((gp - g64).abs().max())
    scale = float(g64.abs().max())
    ok = bool(torch.isfinite(gk).all()) and ek <= FACTOR * max(
        ep, RTOL * scale)
    return ok, ek, ep, scale


def assembly_refs(k64):
    """{name: (float64 value, sum of the contributions' magnitudes)} of
    g, diag0 and (dense) the matrix, from a float64 Terms' own factors."""
    g, diag0, Hp = assembled(k64)
    mg, mdiag, mHp = assembled(k64, absolute=True)
    refs = {"g": (g, mg), "diag0": (diag0, mdiag)}
    if Hp is not None:
        refs["Hp"] = (Hp, mHp)
    return refs


def check_assembly(terms):
    """O's stage 2 alone: g, diag0 and the matrix of ``terms`` (the
    kernel's, slots of weight 0 read as 0) within ``GAMMA`` of their
    float64 recomputation from the same terms' factors.  Returns {name:
    [error, allowed]} and ok."""
    res = {}
    for name, (ref, mag) in assembly_refs(_to64(terms)).items():
        good, err, allowed = _within(getattr(terms, name), ref, mag)
        res[name] = [err, allowed]
        res["ok"] = res.get("ok", True) and good
    return res


def check_terms(kind, state, data, opts, lam, n_images, n_cameras, dense,
                terms=None, apply=None):
    """O and P against their plain versions on one kind of track (see
    the module docstring), then P's product and back-substitution on O's
    terms with a seeded v.  ``terms`` / ``apply`` are the kernel entries
    (the public wrappers by default).  Returns (result dict, the kernel's
    terms with the slots of weight 0 read as 0)."""
    from limap_tpu_torch.ops import hybrid_ba as O
    terms = terms or O.hybrid_terms
    apply = apply or O.hybrid_apply
    land, (kv, ci, ii), obs, w = _parts(kind, state, data)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=land.device)
    args = (kind, land, state.pose_params, state.cam_fxfy, kv, ci, ii)
    k = weighted_only(terms(*args, obs, w, opts, lam, n_images, n_cameras,
                            dense))
    k2 = weighted_only(terms(*args, obs, w, opts, lam, n_images, n_cameras,
                             dense))
    p = O.hybrid_terms_plain(*args, obs, w, opts, lam, n_images, n_cameras,
                             dense)
    p64 = O.hybrid_terms_plain(*map(_double, args),
                               tuple(map(_double, obs)), _double(w), opts,
                               lam.double(), n_images, n_cameras, dense)
    res = {"T": int(ii.shape[0]), "S": int(ii.shape[1]),
           "weighted": int((w > 0).sum())}
    failed = []
    for name in OWN_TERMS:
        a, b, c = getattr(k, name), getattr(p, name), getattr(p64, name)
        good, ek, ep, sc = compare(a, b, c)
        res[name] = [ek, ep, sc]
        if not good:
            failed.append(name)
    good, ek, ep, sc = compare_g_c(k, p, p64)
    res["g_c"] = [ek, ep, sc]
    if not good:
        failed.append("g_c")
    # the elimination, again in float64 from the kernel's own terms
    k64 = _to64(k)
    L = k64.H_ll.shape[-1]
    eye = torch.eye(L, dtype=torch.float64, device=k64.H_ll.device)
    H = k64.H_ll + (lam.double() + 1e-8) * eye
    inv = torch.linalg.inv(H)
    cond = torch.linalg.cond(H)
    size = inv.abs().amax(dim=(-2, -1))
    refs = {
        "Hinv": (inv, (INV_C * EPS32 / GAMMA) * (cond * size)[:, None, None]
                 .expand(inv.shape)),
        "A": (k64.H_cl @ k64.Hinv[:, None],
              k64.H_cl.abs() @ k64.Hinv.abs()[:, None]),
    }
    refs.update(assembly_refs(k64))
    for name, (ref, mag) in refs.items():
        good, err, allowed = _within(getattr(k, name), ref, mag)
        res[name] = [err, allowed]
        if not good:
            failed.append(name)
    repeat = all(torch.equal(getattr(k, n), getattr(k2, n))
                 for n in ("g", "diag0", "Hinv", "H_cl", "A", "g_red")) and (
        k.Hp is None or torch.equal(k.Hp, k2.Hp))
    res["repeats"] = repeat
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(k.g.shape[0], generator=gen).to(land.device)
    kabs = k64._replace(**{n: getattr(k64, n).abs() for n in
                           ("Hinv", "b_l", "H_cl", "H_cc")})
    for name, backsub in (("apply", False), ("backsub", True)):
        a = apply(k, v, backsub)
        a2 = apply(k, v, backsub)
        ref = O.hybrid_apply_plain(k64, v.double(), backsub)
        if backsub:
            mag = torch.einsum("tab,tb->ta", kabs.Hinv, kabs.b_l + torch.einsum(
                "tspa,tsp->ta", kabs.H_cl, v.double().abs()[k.cols]))
        else:
            vc = v.double().abs()[k.cols]
            y = torch.einsum("tab,tb->ta", kabs.Hinv, torch.einsum(
                "tspa,tsp->ta", kabs.H_cl, vc))
            out = torch.einsum("tspq,tsq->tsp", kabs.H_cc, vc) \
                + torch.einsum("tspa,ta->tsp", kabs.H_cl, y)
            mag = torch.zeros_like(ref).index_add_(0, k.cols.reshape(-1),
                                                   out.reshape(-1))
        good, err, allowed = _within(a, ref, mag)
        good = good and torch.equal(a, a2)
        res[name] = [err, allowed]
        if not good:
            failed.append(name)
    if failed:
        res["failed"] = failed
    res["ok"] = bool(not failed and repeat)
    return res, k


def check_cost(state, line_data, point_data, opts, cost=None):
    """Q against its plain version (float32 and float64), twice."""
    from limap_tpu_torch.ops import hybrid_ba as O
    cost = cost or O.hybrid_cost
    a = cost(state, line_data, point_data, opts)
    a2 = cost(state, line_data, point_data, opts)
    b = O.hybrid_cost_plain(state, line_data, point_data, opts)
    c = O.hybrid_cost_plain(type(state)(*map(_double, state)),
                            tuple(map(_double, line_data)),
                            tuple(map(_double, point_data)), opts)
    err = abs(float(a) - float(c))
    ok = err <= COST_RTOL * max(abs(float(c)), 1e-30) and torch.equal(a, a2)
    return {"cost": float(a), "plain": float(b), "float64": float(c),
            "abs_err": err, "repeats": bool(torch.equal(a, a2)),
            "ok": bool(ok)}


def cases():
    """(case, problem kwargs, options kwargs) of the seeded comparisons."""
    base = dict(n_views=8, n_lines=24, n_points=40, S=6, Sp=8)
    yield "dense", base, {}
    yield "dense, optimize_focal", base, {"optimize_focal": True}
    yield "cg, optimize_focal", base, {"optimize_focal": True, "solver": "cg"}
    for flag in ("constant_pose", "constant_line", "constant_point"):
        yield f"dense, {flag}", base, {flag: True}
    yield "dense, constant_pose, optimize_focal", base, {
        "constant_pose": True, "optimize_focal": True}
    yield "huber, ragged S 40", dict(base, S=40, Sp=37), {"loss": "huber"}
    yield "trivial, full slots", dict(base, ragged=False), {
        "loss": "trivial"}
    yield "one track", dict(base, n_lines=1, n_points=1), {}
    yield "one support", dict(base, S=1, Sp=1, ragged=False), {
        "optimize_focal": True}


def check_all(device="cuda", terms=None, apply=None, cost=None):
    """The seeded cases: yields (name, case, result)."""
    from limap_tpu_torch.parallel.sharded_ba import HybridBAOptions
    for i, (case, prob, okw) in enumerate(cases()):
        state, ld, pd, I, C = seeded_problem(seed=10 + i, device=device,
                                             **prob)
        opts = HybridBAOptions(**okw)
        dense = opts.solver != "cg"
        for kind, data in (("line", ld), ("point", pd)):
            res, _ = check_terms(kind, state, data, opts, opts.damping, I, C,
                                 dense, terms, apply)
            yield f"hybrid_terms + hybrid_apply, {kind}s", case, res
        yield "hybrid_cost", case, check_cost(state, ld, pd, opts, cost)


def check_apply_scan(tl, tp, v):
    """P's product and back-substitution on each kind's kernel terms,
    and the product of both kinds, against the first design (the
    yardstick ``hybrid_apply_scan``) bit for bit."""
    from limap_tpu_torch.ops import hybrid_ba as O
    res = {}
    for t in (tl, tp):
        for backsub in (False, True):
            res[f"{t.kind}, {'backsub' if backsub else 'apply'}"] = bool(
                torch.equal(O.hybrid_apply(t, v, backsub),
                            O.hybrid_apply_scan(t, v, backsub)))
    res["both"] = bool(torch.equal(
        O.hybrid_apply_both(tl, tp, v),
        O.hybrid_apply_scan(tl, v) + O.hybrid_apply_scan(tp, v)))
    res["ok"] = all(res.values())
    return res


def check_all_scan(device="cuda"):
    """The seeded cases: P against its first design bit for bit; yields
    (case, result)."""
    from limap_tpu_torch.parallel.sharded_ba import HybridBAOptions
    for i, (case, prob, okw) in enumerate(cases()):
        state, ld, pd, I, C = seeded_problem(seed=10 + i, device=device,
                                             **prob)
        tl, tp = kernel_terms(state, ld, pd, HybridBAOptions(**okw), I, C)
        gen = torch.Generator().manual_seed(i)
        v = torch.randn(tl.g.shape[0], generator=gen).to(tl.g.device)
        yield case, check_apply_scan(tl, tp, v)


def kernel_terms(state, ld, pd, opts, n_images, n_cameras):
    """Kernel O's terms of the lines and of the points (the dense matrix
    unless ``opts`` asks for CG)."""
    from limap_tpu_torch.ops import hybrid_ba as O
    lam = torch.tensor(opts.damping, device=state.pose_params.device)
    terms = []
    for kind, data in (("line", ld), ("point", pd)):
        land, (kv, ci, ii), obs, w = _parts(kind, state, data)
        terms.append(O.hybrid_terms(
            kind, land, state.pose_params, state.cam_fxfy, kv, ci, ii, obs,
            w, opts, lam, n_images, n_cameras, opts.solver != "cg"))
    return terms


def device_ms(fn, reps):
    """ms of the device's work a call of ``fn``, over ``reps`` calls
    queued behind a sleep kernel (so the host's own time a call does not
    count), and ms of the host's time a call (no synchronization)."""
    import time
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))          # ~10 ms at 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def apply_split(kinds, v, reps=20, scan=False):
    """Kernel P's time by part on the card, for the terms ``kinds`` (one
    kind, or the lines' and the points' for the product of both) and v:
    the launch with no work, stage 1, the barrier between the stages (the
    first design's two), stage 2, each the difference of two device
    times (:func:`device_ms`, the launches' arguments prepared once), and
    the host's time a call of the wrapper."""
    from limap_tpu_torch.ops import hybrid_ba as O
    launch = O.ApplyLaunch(kinds, v.device, scan=scan)
    parts = (0, O.APPLY_STAGE1, O.APPLY_STAGE1 | O.APPLY_BARRIER,
             O.APPLY_ALL)
    ms = [device_ms(lambda: launch(v, stages), reps)[0] for stages in parts]
    if scan:
        call = lambda: O.hybrid_apply_scan(kinds[0], v)
    elif len(kinds) == 2:
        call = lambda: O.hybrid_apply_both(*kinds, v)
    else:
        call = lambda: O.hybrid_apply(kinds[0], v)
    whole, host = device_ms(call, reps)
    return {"launch_ms": ms[0], "stage1_ms": ms[1] - ms[0],
            "barrier_ms": ms[2] - ms[1], "stage2_ms": ms[3] - ms[2],
            "device_ms": ms[3], "wrapper_device_ms": whole,
            "wrapper_host_ms": host,
            "design": "first (scan)" if scan else "contributions"}


@contextlib.contextmanager
def summed_in_shares(share):
    """Within the block, ``ops.hybrid_terms`` on the CPU gives g, diag0
    and (dense) the matrix summed as O's stage 2 adds them: a block's
    pairs cut into shares of ``share`` consecutive pairs, each share
    summed, then the shares in order (``assemble_from_pairs`` on the
    plain version's factors, in their dtype).  A replay of the card's
    summation order, with the share size free, for the multi-rank runs
    of ``tests/torch_parallel_checks.py``: in float64 a fault of the
    order (a pair dropped or added twice) shows as a gap between ranks,
    rounding does not."""
    from limap_tpu_torch.ops import hybrid_ba as O
    plain = O.hybrid_terms

    def terms(kind, land, pose, fxfy, kvec, cam, img, obs, weight, opts,
              lam, n_images, n_cameras, dense, index=None):
        t = plain(kind, land, pose, fxfy, kvec, cam, img, obs, weight,
                  opts, lam, n_images, n_cameras, dense, index=index)
        focal = bool(opts.optimize_focal)
        img32, cam32 = O._i32(img), O._i32(cam)
        grouping = O.group_index(img32, cam32, weight, n_images, n_cameras,
                                 focal)
        ix = O.Index(*grouping, *O.pair_index(
            img32, cam32, weight, n_images, n_cameras, focal, dense,
            *grouping[:2], share=share), bool(dense))
        g, diag0, Hp = O.assemble_from_pairs(t, ix)
        return t._replace(g=g, diag0=diag0, Hp=Hp if dense else t.Hp)

    O.hybrid_terms = terms
    try:
        yield
    finally:
        O.hybrid_terms = plain


def terms_split(args, reps=10):
    """Kernel O's time by part on the card, for one kind's input
    ``args`` (hybrid_terms' positional arguments): the index build's
    grouping (what the first design rebuilt every call) and its pair
    lists (host clock around a synchronized build, in ms), then stage 1,
    stage 2 on the pair lists and the first design's stage 2, each alone
    (CUDA events over ``reps`` launches into the same buffers).  Returns
    a dict of ms and the index's sizes."""
    import time
    from limap_tpu_torch.ops import hybrid_ba as O
    (kind, land, pose, fxfy, kvec, cam, img, obs, w, opts, lam, I, C,
     dense) = args
    focal = bool(opts.optimize_focal)
    img32, cam32 = O._i32(img), O._i32(cam)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    grouping, group_ms = host_ms(lambda: O.group_index(img32, cam32, w, I,
                                                       C, focal))
    _, pairs_ms = host_ms(lambda: O.pair_index(img32, cam32, w, I, C, focal,
                                               dense, *grouping[:2]))
    index, build_ms = host_ms(lambda: O.build_index(img32, cam32, w, I, C,
                                                    focal, dense))
    ob = torch.cat(obs, dim=-1) if kind == "line" else obs[0]
    T, S = img.shape
    call = O.terms_launcher(kind, land, pose, fxfy, kvec, cam32, img32, ob,
                            w, opts, lam, I, C, dense, index,
                            O.terms_buffers(kind, T, S, I, C, focal, dense,
                                            land.device))

    def events_ms(**kw):
        call(**kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            call(**kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    n_t = (w > 0).sum(1).double()
    # stage 1 first: each stage 2 reads the factors it left in the buffers
    return {"index_grouping_ms": group_ms, "index_pairs_ms": pairs_ms,
            "index_ms": build_ms,
            "stage1_ms": events_ms(stages=O.STAGE_TERMS),
            "stage2_ms": events_ms(stages=O.STAGE_ASSEMBLY),
            "stage2_scan_ms": events_ms(stages=O.STAGE_ASSEMBLY, scan=True),
            "supports": int((w > 0).sum()),
            "pairs_sum_n_t_squared": int((n_t * n_t).sum()),
            "pairs_listed": int(index.pair_s.numel()),
            "shares": int(index.share_block.numel()),
            "blocks": int(index.pair_ptr.numel() - 1)}


def main():
    from limap_tpu_torch.ops import cuda_build, hybrid_ba
    hybrid_ba.build()
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        print(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}")
    ok = True
    for name, case, res in check_all():
        print(f"{name}, {case}: {json.dumps(res)}", flush=True)
        ok = ok and res["ok"]
    for case, res in check_all_scan():
        print(f"hybrid_apply vs its first design, {case}: "
              f"{json.dumps(res)}", flush=True)
        ok = ok and res["ok"]
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())


# ------------------------------------------------------------- the bounds
# float operations of one support's two weighted residuals, counted from
# csrc/hybrid_ba.cu (an add, sub, mul, divide, sqrt, exp, abs or clamp
# counts one): the line's minimal_to_plucker 44, two quaternion rotations
# 60, the moment 12, the image line 10 and its normalization 10, the
# distances 18, the segment 7, the angle weight 9, the products 2; the
# point's rotation 30, translation 3, projection 9, error 4; each with
# the robust weighting 12
OPS_RESIDUAL = {"line": 184, "point": 56}


def _touched(weight, img, cam):
    """(weighted slots, tracks with one, images named, cameras named)."""
    w = weight > 0
    return (int(w.sum()), int(w.any(1).sum()), int(img[w].unique().numel()),
            int(cam[w].unique().numel()))


def terms_work(kind, weight, img, cam, L, Dc, D, dense, P, S_obs):
    """(operations, bytes) of kernel O on one kind's input: the Jets'
    arithmetic (each residual operation also on each of the L + Dc
    tangents), each weighted support's outer products, the landmark
    block and its elimination, and on the dense path every pair of
    weighted supports of a track (the Schur block A[s] H_cl[u]^T, Dc x Dc
    x L).  Bytes: every slot's weight; a weighted support's principal
    point, camera and image indices and observation; each landmark with
    a weighted support, each pose and camera it names once; the outputs
    written once (H_ll^-1 and b_l a track, H_cl and H_cc a weighted
    support, the cost, g, diag0 and on the dense path the matrix)."""
    n_w, t_w, n_img, n_cam = _touched(weight, img, cam)
    per_track = (weight > 0).sum(1).double()
    pairs = int((per_track * per_track).sum())
    T, S = weight.shape
    ops = n_w * (OPS_RESIDUAL[kind] * (1 + L + Dc)
                 + 4 * Dc * L + 2 * Dc * (Dc + 1) + 4 * Dc
                 + 2 * L * (L + 1) + 4 * L + 2 * Dc * L * L + 2 * Dc * L)
    ops += T * 2 * L ** 3
    if dense:
        ops += pairs * 2 * Dc * Dc * L
    nbytes = 4 * (T * S + n_w * (2 + 1 + 1 + S_obs) + t_w * P + 7 * n_img
                  + 2 * n_cam) \
        + 4 * (T * L * L + T * L + n_w * Dc * (L + Dc) + 1 + 2 * D
               + (D * D if dense else 0))
    return float(ops), float(nbytes)


def apply_work(weight, img, cam, L, Dc, D, backsub):
    """(operations, bytes) of kernel P: y from every weighted support's
    H_cl^T v and the track's H_ll^-1, then (the product) each weighted
    support's H_cc v - H_cl y.  Bytes: every slot's weight; a weighted
    support's image index (and camera index with the focal lengths) and
    H_cl (and H_cc for the product); H_ll^-1 (and b_l for the
    back-substitution) of each track with a weighted support; v; the
    output written once ([T, L] or [D])."""
    n_w, t_w, _, _ = _touched(weight, img, cam)
    T, S = weight.shape
    idx = 1 if Dc == 6 else 2
    ops = n_w * 2 * Dc * L + t_w * 2 * L * L
    nbytes = 4 * (T * S + n_w * (idx + Dc * L) + t_w * L * L + D)
    if backsub:
        ops += t_w * L
        nbytes += 4 * (t_w * L + T * L)
    else:
        ops += n_w * 2 * Dc * (Dc + L)
        nbytes += 4 * (n_w * Dc * Dc + D)
    return float(ops), float(nbytes)


def cost_work(kinds):
    """(operations, bytes) of kernel Q on {kind: (weight, img, cam, P,
    S_obs)}: each weighted residual and its square, over lines and
    points.  Bytes: every slot's weight; a weighted support's principal
    point, indices and observation; each landmark with a weighted
    support, each pose and camera named once over both kinds; the
    cost."""
    ops, nbytes, imgs, cams = 0, 4, [], []
    for kind, (w, img, cam, P, S_obs) in kinds.items():
        n_w, t_w, _, _ = _touched(w, img, cam)
        ops += n_w * (OPS_RESIDUAL[kind] + 3)
        nbytes += 4 * (w.numel() + n_w * (2 + 1 + 1 + S_obs) + t_w * P)
        imgs.append(img[w > 0])
        cams.append(cam[w > 0])
    nbytes += 4 * (7 * torch.cat(imgs).unique().numel()
                   + 2 * torch.cat(cams).unique().numel())
    return float(ops), float(nbytes)
