"""Kernels O, P and Q: the hybrid bundle adjustment's step on the card.

``hybrid_terms`` (O) takes one kind of track (lines [T, 6] minimal lines
or points [T, 3]) with its S padded supports and returns their
:class:`Terms`: per track H_ll^-1 [T, L, L] (the landmark block damped by
``lam + 1e-8``), b_l [T, L], H_cl [T, S, Dc, L] and H_cc [T, S, Dc, Dc];
the sum of squares at the state; and the reduced camera system's gradient
g [D], its Jacobi diagonal diag0 [D] and, on the dense path, its matrix
[D, D] (D = 6 I, + 2 C with the focal lengths).  ``hybrid_apply`` (P) is
CG's matrix-free product from those terms, or with ``backsub`` the
landmark updates.  ``hybrid_cost`` (Q) is the cost of a state.

CUDA tensors launch ``csrc/hybrid_ba.cu``; on the card a slot of weight
0 is read for its weight alone, and its per-support factors (H_cl,
H_cc, A, g_red) are left unwritten.  CPU tensors take the plain
versions, which compute the terms as the JAX program does
(``parallel/sharded_ba.py``: jvp Jacobians, the Schur complement with the
reduced blocks [T, S, S, Dc, Dc] in chunks of tracks, scatters), the
product and the back-substitution from the factors.

The kernel adds each entry of g, diag0 and the matrix in a fixed order
(a warp per block of the matrix sums the supports of the block's row
image, in track order, lane by lane, then across lanes by a butterfly),
P adds a group's supports in 16 shares of consecutive supports and then
the shares in order, and Q sums a track's supports and then the tracks
in a fixed order, so the same state gives the same numbers on every run.

Each wrapper counts its launches in ``.launches``; O and P also count
them by kind and mode in ``.counts`` (``"line"``, ``"point, apply"``,
``"point, backsub"``, ...).  ``reset_counts()`` sets them all to 0.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor

SOURCE = "hybrid_ba.cu"
KINDS = ("line", "point")
LAND = {"line": 4, "point": 3}      # landmark tangent
PARAMS = {"line": 6, "point": 3}    # landmark parameters
OBS = {"line": 4, "point": 2}       # observation floats a support
INT_MAX = 2 ** 31 - 1
S_RED_BUDGET = 1 << 24              # floats of S_red a chunk of plain O
SPLIT = 16                          # P's shares of a group (hybrid_ba.cu)


class Index(NamedTuple):
    """The supports of weight > 0 grouped by the camera block they feed:
    group g < I the pose of image g, I + c the focal lengths of camera
    c.  ``inc`` holds t * S + s, by group then track then slot; a track's
    weighted images sorted (``sorted_img``, INT_MAX after) with their
    slots (``sorted_pos``)."""
    grp_ptr: torch.Tensor     # [G + 1] int32
    inc: torch.Tensor         # [E] int32
    sorted_img: torch.Tensor  # [T, S] int32
    sorted_pos: torch.Tensor  # [T, S] int32


class Terms(NamedTuple):
    kind: str
    Hinv: torch.Tensor        # [T, L, L]
    b_l: torch.Tensor         # [T, L]
    H_cl: torch.Tensor        # [T, S, Dc, L]
    H_cc: torch.Tensor        # [T, S, Dc, Dc]
    cost: torch.Tensor        # [] sum of squares at the state
    g: torch.Tensor           # [D]
    diag0: torch.Tensor       # [D]
    Hp: Optional[torch.Tensor]  # [D, D] on the dense path
    img: torch.Tensor         # [T, S]
    cam: torch.Tensor         # [T, S]
    weight: torch.Tensor      # [T, S]
    cols: torch.Tensor        # [T, S, Dc] int64
    n_images: int
    n_cameras: int
    focal: bool
    index: Optional[Index]    # on the card
    H_ll: torch.Tensor        # [T, L, L] undamped, for the checks
    A: torch.Tensor           # [T, S, Dc, L] H_cl H_ll^-1
    g_red: torch.Tensor       # [T, S, Dc] g_c - A b_l, a support's share of g


def dims(n_images, n_cameras, focal):
    return n_images * 6 + (n_cameras * 2 if focal else 0)


def _track_terms(kind, land, pose, fxfy, kvec, cam, img, obs, weight, opts,
                 lam):
    from limap_tpu_torch.parallel import sharded_ba as sb
    if kind == "line":
        return sb._line_track_terms(land, pose, fxfy, kvec, cam, img,
                                    obs[0], obs[1], weight, opts, lam, True)
    return sb._point_track_terms(land, pose, fxfy, kvec, cam, img, obs[0],
                                 weight, opts, lam, True)


def hybrid_terms_plain(kind, land, pose, fxfy, kvec, cam, img, obs, weight,
                       opts, lam, n_images, n_cameras, dense) -> Terms:
    """Kernel O's plain version: the JAX program's per-track terms, in
    chunks of tracks that keep S_red within ``S_RED_BUDGET`` floats."""
    from limap_tpu_torch.parallel import sharded_ba as sb
    T, S = img.shape
    focal = opts.optimize_focal
    D = dims(n_images, n_cameras, focal)
    Dc = 8 if focal else 6
    L = LAND[kind]
    cols = sb._cols_for(img, cam, n_images, opts)
    g = land.new_zeros(D)
    diag0 = land.new_zeros(D)
    Hp = land.new_zeros((D, D)) if dense else None
    cost = land.new_zeros(())
    parts = []
    step = max(1, S_RED_BUDGET // max(1, S * S * Dc * Dc))
    for a in range(0, T, step):
        sl = slice(a, min(T, a + step))
        r0, Hd, Sr, g_red, Hinv, b_l, H_cl, H_ll = _track_terms(
            kind, land[sl], pose, fxfy, kvec[sl], cam[sl], img[sl],
            tuple(o[sl] for o in obs), weight[sl], opts, lam)
        c = cols[sl]
        g = g + sb._scatter_g(D, c, g_red)
        self_diag = torch.diagonal(Hd, dim1=-2, dim2=-1) + torch.diagonal(
            torch.diagonal(Sr, dim1=1, dim2=2).movedim(-1, 1), dim1=-2,
            dim2=-1)
        diag0 = diag0 + sb._scatter_g(D, c, self_diag)
        if dense:
            Hp = Hp + sb._accumulate_dense(D, c, Hd, Sr)
        cost = cost + torch.sum(r0 * r0)
        parts.append((Hinv, b_l, H_cl, Hd, g_red, H_ll))
        del Sr
    if parts:
        Hinv, b_l, H_cl, H_cc, g_red, H_ll = (torch.cat(p)
                                              for p in zip(*parts))
    else:
        Hinv = land.new_zeros((0, L, L))
        b_l = land.new_zeros((0, L))
        H_cl = land.new_zeros((0, S, Dc, L))
        H_cc = land.new_zeros((0, S, Dc, Dc))
        g_red = land.new_zeros((0, S, Dc))
        H_ll = land.new_zeros((0, L, L))
    A = H_cl @ Hinv[:, None]
    return Terms(kind, Hinv, b_l, H_cl, H_cc, cost, g, diag0, Hp, img, cam,
                 weight, cols, n_images, n_cameras, focal, None, H_ll, A,
                 g_red)


def hybrid_apply_plain(terms: Terms, v, backsub=False):
    """Kernel P's plain version: y = H_ll^-1 (sum_s H_cl[s]^T v[cols_s]
    (+ b_l)); the product adds H_cc[s] v_s - H_cl[s] y at cols_s, the
    back-substitution returns -y."""
    vc = v[terms.cols]                                    # [T, S, Dc]
    rhs = torch.einsum("tspa,tsp->ta", terms.H_cl, vc)
    if backsub:
        return -torch.einsum("tab,tb->ta", terms.Hinv, terms.b_l + rhs)
    y = torch.einsum("tab,tb->ta", terms.Hinv, rhs)
    out = torch.einsum("tspq,tsq->tsp", terms.H_cc, vc) \
        - torch.einsum("tspa,ta->tsp", terms.H_cl, y)
    return torch.zeros_like(v).index_add_(0, terms.cols.reshape(-1),
                                          out.reshape(-1))


def hybrid_cost_plain(state, line_data, point_data, opts):
    """Kernel Q's plain version: the JAX program's cost of a state."""
    from limap_tpu_torch.parallel import sharded_ba as sb
    r_l = sb._line_cost(state.line_params, state.pose_params,
                        state.cam_fxfy, *line_data, opts)
    r_p = sb._point_cost(state.point_params, state.pose_params,
                         state.cam_fxfy, *point_data, opts)
    return torch.sum(r_l * r_l) + torch.sum(r_p * r_p)


# ------------------------------------------------------------ the kernels
def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, pp, lp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
        ctypes.POINTER(ctypes.c_longlong)
    fp = ctypes.POINTER(ctypes.c_float)
    for name in ("hybrid_terms_launch", "hybrid_apply_launch",
                 "hybrid_cost_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [pp, lp, fp, ptr]
        fn.restype = ctypes.c_int
    return lib


def _ptrs(*ts):
    return (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr()
                                         for t in ts])


def _ints(*xs):
    return (ctypes.c_longlong * len(xs))(*[int(x) for x in xs])


def _floats(*xs):
    return (ctypes.c_float * len(xs))(*[float(x) for x in xs])


def _call(name, ptrs, ints, floats, dev):
    with torch.cuda.device(dev):
        err = getattr(build(), name)(
            _ptrs(*ptrs), _ints(*ints), _floats(*floats),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def build_index(img, cam, weight, n_images, n_cameras, focal) -> Index:
    """The supports' grouping for the kernels (see :class:`Index`)."""
    T, S = img.shape
    valid = weight > 0
    flat = torch.nonzero(valid.reshape(-1)).squeeze(1)
    grp = img.reshape(-1)[flat].long()
    if focal:
        grp = torch.cat([grp, n_images + cam.reshape(-1)[flat].long()])
        flat = torch.cat([flat, flat])
    order = torch.argsort(grp * (T * S) + flat)
    G = n_images + (n_cameras if focal else 0)
    counts = torch.bincount(grp, minlength=G)
    grp_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    key = torch.where(valid, img.to(torch.int64), INT_MAX)
    sorted_img, sorted_pos = torch.sort(key, dim=1, stable=True)
    return Index(grp_ptr.to(torch.int32), flat[order].to(torch.int32),
                 sorted_img.to(torch.int32), sorted_pos.to(torch.int32))


def _hyper(opts, lam):
    from limap_tpu_torch.optimize.lm import LOSSES
    if opts.loss not in LOSSES:
        raise ValueError(f"unknown loss {opts.loss}")
    s = float(opts.loss_scale)
    return (opts.geometric_alpha, s, s * s,
            float(np.float32(np.sqrt(opts.lw_point))), float(lam)), \
        LOSSES.index(opts.loss)


def _check(kind, land, pose, fxfy, kvec, cam, img, obs, weight):
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    T, S = img.shape
    dev = land.device
    f32, i = torch.float32, img.dtype
    check_tensor("land", land, f32, (T, PARAMS[kind]), dev)
    check_tensor("pose", pose, f32, (pose.shape[0], 7), dev)
    check_tensor("fxfy", fxfy, f32, (fxfy.shape[0], 2), dev)
    check_tensor("kvec", kvec, f32, (T, S, 4), dev)
    check_tensor("cam", cam, cam.dtype, (T, S), dev)
    check_tensor("img", img, i, (T, S), dev)
    check_tensor("obs", obs, f32, (T, S, OBS[kind]), dev)
    check_tensor("weight", weight, f32, (T, S), dev)


def _i32(t):
    return t.to(torch.int32).contiguous()


def hybrid_terms(kind, land, pose, fxfy, kvec, cam, img, obs, weight, opts,
                 lam, n_images, n_cameras, dense) -> Terms:
    """Kernel O (see the module docstring); ``obs`` is (l2d_start,
    l2d_end) for lines and (p2d,) for points, ``lam`` the damping of the
    landmark blocks.  ``hybrid_terms.launches`` counts the launches."""
    if land.device.type == "cpu":
        return hybrid_terms_plain(kind, land, pose, fxfy, kvec, cam, img,
                                  obs, weight, opts, lam, n_images,
                                  n_cameras, dense)
    ob = torch.cat(obs, dim=-1) if kind == "line" else obs[0]
    _check(kind, land, pose, fxfy, kvec, cam, img, ob, weight)
    return _terms_kernel(kind, land, pose, fxfy, kvec, cam, img, ob, weight,
                         opts, lam, n_images, n_cameras, dense)


def _terms_kernel(kind, land, pose, fxfy, kvec, cam, img, ob, weight, opts,
                  lam, n_images, n_cameras, dense) -> Terms:
    from limap_tpu_torch.parallel import sharded_ba as sb
    T, S = img.shape
    focal = bool(opts.optimize_focal)
    Dc, L, D = (8 if focal else 6), LAND[kind], dims(n_images, n_cameras,
                                                     focal)
    dev = land.device
    img32, cam32 = _i32(img), _i32(cam)
    weight = weight.contiguous()
    index = build_index(img32, cam32, weight, n_images, n_cameras, focal)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    Hinv, b_l, H_cl, A = e(T, L, L), e(T, L), e(T, S, Dc, L), e(T, S, Dc, L)
    H_cc, g_red, cost_t = e(T, S, Dc, Dc), e(T, S, Dc), e(T)
    H_ll = e(T, L, L)
    g, diag0 = e(D), e(D)
    Hp = e(D, D) if dense else None
    hp, loss = _hyper(opts, lam)
    if T:
        _call("hybrid_terms_launch",
              [land.contiguous(), pose.contiguous(), fxfy.contiguous(),
               kvec.contiguous(), cam32, img32, ob.contiguous(), weight,
               *index, Hinv, b_l, H_cl, A, H_cc, g_red, cost_t, Hp, g,
               diag0, H_ll],
              [KINDS.index(kind), focal, T, S, n_images, n_cameras, loss,
               opts.constant_pose,
               opts.constant_line if kind == "line" else opts.constant_point,
               dense], hp, dev)
        _count(_TERMS, kind)
    else:
        g.zero_()
        diag0.zero_()
        if Hp is not None:
            Hp.zero_()
    return Terms(kind, Hinv, b_l, H_cl, H_cc, cost_t.sum(), g, diag0, Hp,
                 img32, cam32, weight,
                 sb._cols_for(img32, cam32, n_images, opts), n_images,
                 n_cameras, focal, index, H_ll, A, g_red)


def _count(fn, key):
    fn.launches += 1
    fn.counts[key] += 1


hybrid_terms.launches = 0
hybrid_terms.counts = Counter()
_TERMS = hybrid_terms    # the count stays on this function when wrapped


def hybrid_apply(terms: Terms, v, backsub=False):
    """Kernel P: CG's product of the reduced matrix (from one kind's
    terms) with v [D] -> [D], or with ``backsub`` the landmark updates
    [T, L] for the camera update v.  ``hybrid_apply.launches`` counts the
    launches."""
    if v.device.type == "cpu":
        return hybrid_apply_plain(terms, v, backsub)
    return _apply_kernel(terms, v, backsub)


def _apply_kernel(terms: Terms, v, backsub):
    T, S = terms.img.shape
    L = LAND[terms.kind]
    dev = v.device
    D = dims(terms.n_images, terms.n_cameras, terms.focal)
    check_tensor("v", v, torch.float32, (D,), dev)
    G = terms.n_images + (terms.n_cameras if terms.focal else 0)
    y = torch.empty((T, L), dtype=torch.float32, device=dev)
    out = part = None
    if not backsub:
        out = torch.empty(D, dtype=torch.float32, device=dev)
        part = torch.empty(G * SPLIT * 6, dtype=torch.float32, device=dev)
    if T:
        _call("hybrid_apply_launch",
              [terms.img, terms.cam, terms.weight, terms.Hinv, terms.b_l,
               terms.H_cl, terms.H_cc, v.contiguous(), y,
               terms.index.grp_ptr, terms.index.inc, out, part],
              [KINDS.index(terms.kind), terms.focal, T, S, terms.n_images,
               terms.n_cameras, backsub], (), dev)
        _count(_APPLY, f"{terms.kind}, {'backsub' if backsub else 'apply'}")
    elif out is not None:
        out.zero_()
    return y if backsub else out


hybrid_apply.launches = 0
hybrid_apply.counts = Counter()
_APPLY = hybrid_apply


def hybrid_cost(state, line_data, point_data, opts):
    """Kernel Q: the sum of squared weighted residuals of a state [], each
    track's supports and then the tracks summed in a fixed order.
    ``hybrid_cost.launches`` counts the launches."""
    if state.pose_params.device.type == "cpu":
        return hybrid_cost_plain(state, line_data, point_data, opts)
    return _cost_kernel(state, line_data, point_data, opts)


def _cost_kernel(state, line_data, point_data, opts):
    dev = state.pose_params.device
    kv_l, ci_l, ii_l, l2s, l2e, w_l = line_data
    kv_p, ci_p, ii_p, p2d, w_p = point_data
    ob_l = torch.cat([l2s, l2e], dim=-1)
    _check("line", state.line_params, state.pose_params, state.cam_fxfy,
           kv_l, ci_l, ii_l, ob_l, w_l)
    _check("point", state.point_params, state.pose_params, state.cam_fxfy,
           kv_p, ci_p, ii_p, p2d, w_p)
    Tl, Sl = ii_l.shape
    Tp, Sp = ii_p.shape
    out = torch.empty((), dtype=torch.float32, device=dev)
    per_track = torch.empty(Tl + Tp, dtype=torch.float32, device=dev)
    hp, loss = _hyper(opts, 0.0)
    _call("hybrid_cost_launch",
          [state.line_params.contiguous(), state.point_params.contiguous(),
           state.pose_params.contiguous(), state.cam_fxfy.contiguous(),
           kv_l.contiguous(), _i32(ci_l), _i32(ii_l), ob_l.contiguous(),
           w_l.contiguous(), kv_p.contiguous(), _i32(ci_p), _i32(ii_p),
           p2d.contiguous(), w_p.contiguous(), per_track, out],
          [Tl, Sl, Tp, Sp, loss], hp, dev)
    _COST.launches += 1
    return out


hybrid_cost.launches = 0
_COST = hybrid_cost


def reset_counts():
    """Set the launch counts of O, P and Q to 0."""
    for fn in (_TERMS, _APPLY, _COST):
        fn.launches = 0
    _TERMS.counts.clear()
    _APPLY.counts.clear()
