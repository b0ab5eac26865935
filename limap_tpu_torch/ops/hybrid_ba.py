"""Kernels O, P and Q: the hybrid bundle adjustment's step on the card.

``hybrid_terms`` (O) takes one kind of track (lines [T, 6] minimal lines
or points [T, 3]) with its S padded supports and returns their
:class:`Terms`: per track H_ll^-1 [T, L, L] (the landmark block damped by
``lam + 1e-8``), b_l [T, L], H_cl [T, S, Dc, L] and H_cc [T, S, Dc, Dc];
the sum of squares at the state; and the reduced camera system's gradient
g [D], its Jacobi diagonal diag0 [D] and, on the dense path, its matrix
[D, D] (D = 6 I, + 2 C with the focal lengths).  ``hybrid_apply`` (P) is
CG's matrix-free product from those terms, or with ``backsub`` the
landmark updates; ``hybrid_apply_both`` the product of the lines' and
the points' terms in one launch.  ``hybrid_cost`` (Q) is the cost of a
state.

CUDA tensors launch ``csrc/hybrid_ba.cu``; on the card a slot of weight
0 is read for its weight alone, and its per-support factors (H_cl,
H_cc, A, g_red) are left unwritten.  CPU tensors take the plain
versions, which compute the terms as the JAX program does
(``parallel/sharded_ba.py``: jvp Jacobians, the Schur complement with the
reduced blocks [T, S, S, Dc, Dc] in chunks of tracks, scatters), the
product and the back-substitution from the factors.

The kernel adds each entry of g, diag0 and the matrix in a fixed order
(O's stage 2 walks the pairs of supports of one track that feed a block
of the matrix, listed once a solve by :func:`build_index`: a warp sums
each share of ``SHARE`` consecutive pairs lane by lane, then across lanes
by a butterfly, and the shares are added in order), P adds a group's
supports' contributions (each written once by its track's warp, before
a grid barrier) in 16 shares of consecutive supports and then the
shares in order, and Q sums a track's supports and then the tracks in
a fixed order, so the same state gives the same numbers on every run.  The
index depends on the images, cameras and weights alone, which do not
change during a solve: the step builds it once (``step.index``) and
hands it to every call; without one, ``hybrid_terms`` builds its own.
``hybrid_terms_scan`` is O with the first design's stage 2 (a warp a
block walks all supports of the block's row group and searches each
one's track), and ``hybrid_apply_scan`` P's first design (stage 2
re-reads each support's factors), kept as yardsticks for timing.

Each wrapper counts its launches in ``.launches``; O and P also count
them by kind and mode in ``.counts`` (``"line"``, ``"point, apply"``,
``"point, backsub"``, ...).  ``reset_counts()`` sets them all to 0.
"""

from __future__ import annotations

import ctypes
import functools
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
SHARE = 128                         # O's pairs a share (hybrid_ba.cu)
PART = 48                           # a share's partials (hybrid_ba.cu)
CHUNK = 32                          # O's shares a chunk (hybrid_ba.cu)
# O's stages (the kernel's ``stages`` argument)
STAGE_TERMS, STAGE_ASSEMBLY, STAGES_ALL = 1, 2, 3
# P's parts (the kernels' ``stages`` argument): the tracks, the grid
# barrier between the stages (the first design's two), the groups
APPLY_STAGE1, APPLY_BARRIER, APPLY_STAGE2, APPLY_ALL = 1, 2, 4, 7


class Index(NamedTuple):
    """The supports of weight > 0 grouped by the camera block they feed:
    group g < I the pose of image g, I + c the focal lengths of camera
    c.  ``inc`` holds t * S + s, by group then track then slot; a track's
    weighted images sorted (``sorted_img``, INT_MAX after) with their
    slots (``sorted_pos``).  O's stage 2 walks the pairs of each block b
    of the reduced system (b = g G + h with ``dense``, else the diagonal
    block g alone): ``pair_s`` and ``pair_u`` hold t * S + s and t * S + u
    of two weighted supports of one track, s in group g and u in group h
    (with ``dense`` every such pair, else u == s), block by block
    (``pair_ptr``), in each block by s's place in ``inc`` and then by u;
    each block's pairs are cut into shares of ``SHARE`` consecutive pairs,
    or without ``dense`` one share a block, so that g and diag0 add up as
    the first design's (``share_first`` each share's first pair,
    ``share_ptr`` by block, ``share_block`` the block of each share), and
    its shares into chunks of ``CHUNK`` (``chunk_ptr``, ``chunk_block``)."""
    grp_ptr: torch.Tensor     # [G + 1] int32
    inc: torch.Tensor         # [E] int32
    sorted_img: torch.Tensor  # [T, S] int32
    sorted_pos: torch.Tensor  # [T, S] int32
    pair_ptr: torch.Tensor    # [NB + 1] int32, NB = G^2 or G
    pair_s: torch.Tensor      # [P] int32
    pair_u: torch.Tensor      # [P] int32
    share_ptr: torch.Tensor   # [NB + 1] int32
    share_block: torch.Tensor  # [NS] int32
    chunk_ptr: torch.Tensor   # [NB + 1] int32
    chunk_block: torch.Tensor  # [NC] int32
    share_first: torch.Tensor  # [NS + 1] int32
    dense: bool


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
@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, pp, lp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
        ctypes.POINTER(ctypes.c_longlong)
    fp = ctypes.POINTER(ctypes.c_float)
    for name in ("hybrid_terms_launch", "hybrid_apply_launch",
                 "hybrid_apply_scan_launch", "hybrid_cost_launch"):
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


def n_groups(n_images, n_cameras, focal):
    return n_images + (n_cameras if focal else 0)


def group_index(img, cam, weight, n_images, n_cameras, focal):
    """The supports' grouping (grp_ptr, inc, sorted_img, sorted_pos; see
    :class:`Index`): P's index, and all the first design's stage 2
    read."""
    T, S = img.shape
    valid = weight > 0
    flat = torch.nonzero(valid.reshape(-1)).squeeze(1)
    grp = img.reshape(-1)[flat].long()
    if focal:
        grp = torch.cat([grp, n_images + cam.reshape(-1)[flat].long()])
        flat = torch.cat([flat, flat])
    order = torch.argsort(grp * (T * S) + flat)
    G = n_groups(n_images, n_cameras, focal)
    counts = torch.bincount(grp, minlength=G)
    grp_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    key = torch.where(valid, img.to(torch.int64), INT_MAX)
    sorted_img, sorted_pos = torch.sort(key, dim=1, stable=True)
    return (grp_ptr.to(torch.int32), flat[order].to(torch.int32),
            sorted_img.to(torch.int32), sorted_pos.to(torch.int32))


def track_pairs(weight):
    """Every ordered pair (s, u) of weighted supports of one track, as
    t * S + s and t * S + u [P] int64, by s in track-major order, then
    by u."""
    T, S = weight.shape
    flat = torch.nonzero((weight > 0).reshape(-1)).squeeze(1)
    t = flat // S
    n_t = torch.bincount(t, minlength=T)
    first = (torch.cumsum(n_t, 0) - n_t)[t]   # the track's first support
    rep = n_t[t]
    s_idx = torch.repeat_interleave(
        torch.arange(len(flat), device=flat.device), rep)
    j = torch.arange(len(s_idx), device=flat.device) \
        - (torch.cumsum(rep, 0) - rep)[s_idx]
    return flat[s_idx], flat[first[s_idx] + j]


def pair_index(img, cam, weight, n_images, n_cameras, focal, dense,
               grp_ptr, inc, share=None):
    """(pair_ptr, pair_s, pair_u, share_ptr, share_block, chunk_ptr,
    chunk_block, share_first) of O's stage 2 (see :class:`Index`);
    ``share``, pairs a share in place of the kernel's cut, is for replays
    of other summation orders (:func:`assemble_from_pairs`)."""
    G = n_groups(n_images, n_cameras, focal)
    dev = weight.device
    if dense:
        s, u = track_pairs(weight)
        img_f, cam_f = img.reshape(-1).long(), cam.reshape(-1).long()
        gs = [img_f[s]] + ([n_images + cam_f[s]] if focal else [])
        gu = [img_f[u]] + ([n_images + cam_f[u]] if focal else [])
        # the blocks of the (image, image), (image, camera), (camera,
        # image) and (camera, camera) groups are apart, so the stable sort
        # keeps each block's pairs in (s, u) order
        block = torch.cat([a * G + b for a in gs for b in gu])
        n_copies = len(gs) * len(gu)
        order = torch.argsort(block, stable=True)
        pair_s = s.repeat(n_copies)[order]
        pair_u = u.repeat(n_copies)[order]
        NB = G * G
        counts = torch.bincount(block, minlength=NB)
        pair_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    else:
        pair_ptr, pair_s, pair_u = grp_ptr.long(), inc.long(), inc.long()
        NB = G

    def cut(ptr, size):
        n = (ptr[1:] - ptr[:-1] + size - 1) // size
        return (torch.cat([n.new_zeros(1), torch.cumsum(n, 0)]),
                torch.repeat_interleave(torch.arange(NB, device=dev), n))

    size = share or (SHARE if dense else max(
        1, int((pair_ptr[1:] - pair_ptr[:-1]).max()) if NB else 1))
    share_ptr, share_block = cut(pair_ptr, size)
    share_first = torch.minimum(
        pair_ptr[share_block] + (torch.arange(len(share_block), device=dev)
                                 - share_ptr[share_block]) * size,
        pair_ptr[-1])
    share_first = torch.cat([share_first, pair_ptr[-1:]])
    chunk_ptr, chunk_block = cut(share_ptr, CHUNK)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return tuple(map(i32, (pair_ptr, pair_s, pair_u, share_ptr, share_block,
                           chunk_ptr, chunk_block, share_first)))


def build_index(img, cam, weight, n_images, n_cameras, focal,
                dense=True) -> Index:
    """The kernels' index of one kind's supports (see :class:`Index`):
    torch ops on the supports' device, built once a solve."""
    img, cam = _i32(img), _i32(cam)
    grouping = group_index(img, cam, weight, n_images, n_cameras, focal)
    return Index(*grouping, *pair_index(img, cam, weight, n_images,
                                        n_cameras, focal, dense,
                                        *grouping[:2]), bool(dense))


def grouping_index(img, cam, weight, n_images, n_cameras, focal,
                   dense=True) -> Index:
    """An :class:`Index` of the supports' grouping alone, its pair lists
    empty: all the first design's stage 2 reads, built as its path built
    it on every call."""
    img, cam = _i32(img), _i32(cam)
    none = torch.zeros(0, dtype=torch.int32, device=img.device)
    return Index(*group_index(img, cam, weight, n_images, n_cameras, focal),
                 *(none,) * 8, bool(dense))


def check_index(index, T, S, n_images, n_cameras, focal, dense, device,
                grouping_only=False):
    """``index`` was built for T x S supports of these groups on
    ``device`` (:func:`build_index` with the same ``dense``; with
    ``grouping_only`` its grouping alone is checked, as
    :func:`grouping_index` builds it)."""
    G = n_groups(n_images, n_cameras, focal)
    NB = G * G if dense else G
    if not isinstance(index, Index) or index.dense != bool(dense):
        raise ValueError(f"an index for dense={bool(dense)} expected")
    ptrs = (("grp_ptr", G + 1),) + (() if grouping_only else (
        ("pair_ptr", NB + 1), ("share_ptr", NB + 1), ("chunk_ptr", NB + 1)))
    for name, n in ptrs:
        check_tensor(name, getattr(index, name), torch.int32, (n,), device)
    for name in ("sorted_img", "sorted_pos"):
        check_tensor(name, getattr(index, name), torch.int32, (T, S), device)
    for name in ("inc",) + (() if grouping_only else (
            "pair_s", "pair_u", "share_block", "chunk_block",
            "share_first")):
        t = getattr(index, name)
        check_tensor(name, t, torch.int32, tuple(t.shape), device)


def _group_span(g, n_images):
    """(first column, size, first entry of a support's camera tangent) of
    group g."""
    if g < n_images:
        return 6 * g, 6, 0
    return 6 * n_images + 2 * (g - n_images), 2, 6


def assemble_from_pairs(terms, index):
    """O's stage 2 replayed in torch on ``terms``' own factors (A, H_cl,
    H_cc, g_red, in their dtype): each share of the index's pairs summed,
    then each block's shares in order; (g, diag0, Hp or None).  The sums
    within a share run in torch's order, not the kernel's lanes'."""
    T, S, Dc, L = terms.A.shape
    I, C = terms.n_images, terms.n_cameras
    G = n_groups(I, C, terms.focal)
    D = dims(I, C, terms.focal)
    dense = index.dense
    A = terms.A.reshape(T * S, Dc, L)
    H_cl = terms.H_cl.reshape(T * S, Dc, L)
    H_cc = terms.H_cc.reshape(T * S, Dc, Dc)
    g_red = terms.g_red.reshape(T * S, Dc)
    share_ptr = index.share_ptr.tolist()
    first = index.share_first.tolist()
    part = A.new_zeros((index.share_block.numel(), PART))
    for k, b in enumerate(index.share_block.tolist()):
        g, h = divmod(b, G) if dense else (b, b)
        _, rg, ro = _group_span(g, I)
        _, cg, co = _group_span(h, I)
        p0, p1 = first[k], first[k + 1]
        s = index.pair_s[p0:p1].long()
        u = index.pair_u[p0:p1].long()
        same = s == u
        if g == h:
            ss = s[same]
            sr = (A[ss, ro:ro + rg] * H_cl[ss, ro:ro + rg]).sum(-1)
            part[k, 36:36 + rg] = g_red[ss, ro:ro + rg].sum(0)
            part[k, 42:42 + rg] = (torch.diagonal(
                H_cc[ss, ro:ro + rg, ro:ro + rg], dim1=-2, dim2=-1)
                - sr).sum(0)
        if dense:
            x = -(A[s, ro:ro + rg] @ H_cl[u, co:co + cg].transpose(-1, -2))
            x[same] += H_cc[s[same], ro:ro + rg, co:co + cg]
            part[k, :36].view(6, 6)[:rg, :cg] = x.sum(0)
    g_out, diag0 = A.new_zeros(D), A.new_zeros(D)
    Hp = A.new_zeros((D, D)) if dense else None
    for b in range(G * G if dense else G):
        x = part[share_ptr[b]:share_ptr[b + 1]].sum(0)
        g, h = divmod(b, G) if dense else (b, b)
        rb, rg, _ = _group_span(g, I)
        cb, cg, _ = _group_span(h, I)
        if dense:
            Hp[rb:rb + rg, cb:cb + cg] = x[:36].view(6, 6)[:rg, :cg]
        if g == h:
            g_out[rb:rb + rg] = x[36:36 + rg]
            diag0[rb:rb + rg] = x[42:42 + rg]
    return g_out, diag0, Hp


def contributions(terms, v):
    """P's stage 1 replayed in torch: y [T, L] and each support's
    contribution c [T, S, Dc] = H_cc v[cols] - H_cl y to its groups'
    entries, over the weighted supports (the rest 0), in ``terms``'
    dtype."""
    w = (terms.weight > 0).to(terms.H_cl.dtype)
    vc = v[terms.cols] * w[..., None]
    y = torch.einsum("tab,tb->ta", terms.Hinv,
                     torch.einsum("tspa,tsp->ta", terms.H_cl, vc))
    c = torch.einsum("tspq,tsq->tsp", terms.H_cc, vc) \
        - torch.einsum("tspa,ta->tsp", terms.H_cl, y)
    return y, c * w[..., None]


def apply_from_contributions(terms, v):
    """P's product replayed in torch (B.1-B.2 of the kernel's design): the
    contributions (:func:`contributions`), then each group's supports
    (``group_index``'s lists) cut into ``SPLIT`` shares of consecutive
    supports as the kernel cuts them, each share summed, the shares added
    in order.  The sums within a share run in torch's order, not the
    kernel's lanes'."""
    T, S = terms.weight.shape
    I, C, focal = terms.n_images, terms.n_cameras, terms.focal
    Dc = 8 if focal else 6
    _, c = contributions(terms, v)
    c = c.reshape(T * S, Dc)
    grp_ptr, inc, _, _ = group_index(terms.img, terms.cam, terms.weight, I,
                                     C, focal)
    ptr = grp_ptr.tolist()
    out = torch.zeros_like(v)
    for g in range(n_groups(I, C, focal)):
        base, size, ro = _group_span(g, I)
        e = inc[ptr[g]:ptr[g + 1]].long()
        n = len(e)
        per = -(-n // SPLIT)
        x = v.new_zeros(size)
        for k in range(SPLIT):
            lo = min(k * per, n)
            x = x + c[e[lo:min(lo + per, n)], ro:ro + size].sum(0)
        out[base:base + size] = x
    return out


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
                 lam, n_images, n_cameras, dense, index=None) -> Terms:
    """Kernel O (see the module docstring); ``obs`` is (l2d_start,
    l2d_end) for lines and (p2d,) for points, ``lam`` the damping of the
    landmark blocks, ``index`` the supports' :func:`build_index` (built
    here when None; the plain version on the CPU reads none, but a given
    one is checked on both).  ``hybrid_terms.launches`` counts the
    launches."""
    T, S = img.shape
    if index is not None:
        check_index(index, T, S, n_images, n_cameras, opts.optimize_focal,
                    dense, land.device)
    if land.device.type == "cpu":
        return hybrid_terms_plain(kind, land, pose, fxfy, kvec, cam, img,
                                  obs, weight, opts, lam, n_images,
                                  n_cameras, dense)
    ob = torch.cat(obs, dim=-1) if kind == "line" else obs[0]
    _check(kind, land, pose, fxfy, kvec, cam, img, ob, weight)
    terms = _terms_kernel(kind, land, pose, fxfy, kvec, cam, img, ob, weight,
                          opts, lam, n_images, n_cameras, dense, index)
    if T:
        _count(_TERMS, kind)
    return terms


def hybrid_terms_scan(kind, land, pose, fxfy, kvec, cam, img, obs, weight,
                      opts, lam, n_images, n_cameras, dense, index=None):
    """Kernel O with the first design's stage 2 (a warp a block walks the
    row group's supports and searches each one's track for the column
    group), the yardstick of the pair lists; CUDA tensors only, for
    timing.  Without ``index`` it builds the grouping alone
    (:func:`grouping_index`), as the first design's path did on every
    call.  ``hybrid_terms_scan.launches`` counts its launches."""
    if land.device.type != "cuda":
        raise ValueError("hybrid_terms_scan is a kernel of the card")
    T, S = img.shape
    if index is None:
        index = grouping_index(img, cam, weight, n_images, n_cameras,
                               opts.optimize_focal, dense)
    else:
        # its stage 2 reads the grouping alone
        check_index(index, T, S, n_images, n_cameras, opts.optimize_focal,
                    dense, land.device, grouping_only=True)
    ob = torch.cat(obs, dim=-1) if kind == "line" else obs[0]
    _check(kind, land, pose, fxfy, kvec, cam, img, ob, weight)
    terms = _terms_kernel(kind, land, pose, fxfy, kvec, cam, img, ob, weight,
                          opts, lam, n_images, n_cameras, dense, index,
                          scan=True)
    if T:
        _SCAN.launches += 1
    return terms


def terms_buffers(kind, T, S, n_images, n_cameras, focal, dense, device):
    """O's outputs [T, ...] (float32, unwritten), by Terms field name
    (``cost_t`` the per-track costs)."""
    Dc, L, D = (8 if focal else 6), LAND[kind], dims(n_images, n_cameras,
                                                     focal)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    return {"Hinv": e(T, L, L), "b_l": e(T, L), "H_cl": e(T, S, Dc, L),
            "A": e(T, S, Dc, L), "H_cc": e(T, S, Dc, Dc),
            "g_red": e(T, S, Dc), "cost_t": e(T), "H_ll": e(T, L, L),
            "g": e(D), "diag0": e(D), "Hp": e(D, D) if dense else None}


def terms_launcher(kind, land, pose, fxfy, kvec, cam, img, ob, weight, opts,
                   lam, n_images, n_cameras, dense, index, buffers):
    """A function ``launch(stages, scan)`` that launches O on these
    inputs into ``buffers`` (:func:`terms_buffers`), its arguments
    prepared once (to time a stage alone)."""
    T, S = img.shape
    focal = bool(opts.optimize_focal)
    n_shares = index.share_block.numel()
    n_chunks = index.chunk_block.numel()
    e = lambda n: torch.empty(max(n, 1) * PART, dtype=torch.float32,
                              device=land.device)
    part, part2 = e(n_shares), e(n_chunks)
    hp, loss = _hyper(opts, lam)
    o = buffers
    ptrs = [land.contiguous(), pose.contiguous(), fxfy.contiguous(),
            kvec.contiguous(), _i32(cam), _i32(img), ob.contiguous(),
            weight.contiguous(), index.grp_ptr, index.inc, index.sorted_img,
            index.sorted_pos,
            *(o[n] for n in ("Hinv", "b_l", "H_cl", "A", "H_cc", "g_red",
                             "cost_t", "Hp", "g", "diag0", "H_ll")),
            index.pair_ptr, index.pair_s, index.pair_u, index.share_ptr,
            index.share_block, part, index.chunk_ptr, index.chunk_block,
            part2, index.share_first]
    ints = [KINDS.index(kind), focal, T, S, n_images, n_cameras, loss,
            opts.constant_pose,
            opts.constant_line if kind == "line" else opts.constant_point,
            dense, n_shares]

    def launch(stages=STAGES_ALL, scan=False):
        _call("hybrid_terms_launch", ptrs, ints + [stages, scan, n_chunks],
              hp, land.device)

    return launch


def _terms_kernel(kind, land, pose, fxfy, kvec, cam, img, ob, weight, opts,
                  lam, n_images, n_cameras, dense, index=None,
                  scan=False) -> Terms:
    from limap_tpu_torch.parallel import sharded_ba as sb
    T, S = img.shape
    focal = bool(opts.optimize_focal)
    img32, cam32 = _i32(img), _i32(cam)
    weight = weight.contiguous()
    if index is None:
        index = build_index(img32, cam32, weight, n_images, n_cameras, focal,
                            dense)
    o = terms_buffers(kind, T, S, n_images, n_cameras, focal, dense,
                      land.device)
    if T:
        terms_launcher(kind, land, pose, fxfy, kvec, cam32, img32, ob,
                       weight, opts, lam, n_images, n_cameras, dense, index,
                       o)(scan=scan)
    else:
        o["g"].zero_()
        o["diag0"].zero_()
        if o["Hp"] is not None:
            o["Hp"].zero_()
    return Terms(kind, o["Hinv"], o["b_l"], o["H_cl"], o["H_cc"],
                 o["cost_t"].sum(), o["g"], o["diag0"], o["Hp"], img32, cam32,
                 weight, sb._cols_for(img32, cam32, n_images, opts),
                 n_images, n_cameras, focal, index, o["H_ll"], o["A"],
                 o["g_red"])


def _count(fn, key):
    fn.launches += 1
    fn.counts[key] += 1


hybrid_terms.launches = 0
hybrid_terms.counts = Counter()
_TERMS = hybrid_terms    # the count stays on this function when wrapped
hybrid_terms_scan.launches = 0
_SCAN = hybrid_terms_scan


def hybrid_apply(terms: Terms, v, backsub=False):
    """Kernel P: CG's product of the reduced matrix (from one kind's
    terms) with v [D] -> [D], or with ``backsub`` the landmark updates
    [T, L] for the camera update v.  ``hybrid_apply.launches`` counts the
    launches."""
    if v.device.type == "cpu":
        return hybrid_apply_plain(terms, v, backsub)
    return _apply_kernel((terms,), v, backsub)


def hybrid_apply_both_plain(tl: Terms, tp: Terms, v):
    """The plain version of :func:`hybrid_apply_both`: the two kinds'
    plain products, added."""
    return hybrid_apply_plain(tl, v) + hybrid_apply_plain(tp, v)


def hybrid_apply_both(tl: Terms, tp: Terms, v):
    """Kernel P on both kinds at once: CG's product of the reduced matrix
    of the lines' and the points' terms with v [D], ``hybrid_apply(tl, v)
    + hybrid_apply(tp, v)`` bit for bit in one launch (counted in
    ``hybrid_apply.launches``, key ``"line+point, apply"``)."""
    if v.device.type == "cpu":
        return hybrid_apply_both_plain(tl, tp, v)
    _check_both(tl, tp)
    return _apply_kernel((tl, tp), v, False)


def _check_both(tl, tp):
    if (tl.kind, tp.kind) != KINDS or (tl.n_images, tl.n_cameras,
                                       tl.focal) != (tp.n_images,
                                                     tp.n_cameras, tp.focal):
        raise ValueError("hybrid_apply_both takes the lines' and the "
                         "points' terms of one system")


class ApplyLaunch:
    """P's launch on fixed terms (one kind, or the lines' and the
    points' for the product of both), its arguments and scratch prepared
    once: ``launch(v, stages=APPLY_ALL)`` launches it on v [D] and
    returns a new output ([D], or [T, L] with ``backsub``).  ``stages``
    times a part alone (``APPLY_STAGE1`` the tracks, ``APPLY_BARRIER``
    the barrier between the stages, or the first design's two,
    ``APPLY_STAGE2`` the groups); ``scan`` launches the first design (one
    kind).  Counts nothing: the wrappers count."""

    def __init__(self, kinds, device, backsub=False, scan=False):
        t0 = kinds[0]
        if scan and len(kinds) != 1:
            raise ValueError("the first design takes one kind")
        self.device, self.backsub = torch.device(device), bool(backsub)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.D = dims(t0.n_images, t0.n_cameras, t0.focal)
        self.L = LAND[t0.kind]
        self.T = t0.img.shape[0]
        G = n_groups(t0.n_images, t0.n_cameras, t0.focal)
        Dc = 8 if t0.focal else 6
        f32 = lambda n: torch.empty(n, dtype=torch.float32,
                                    device=self.device)
        # y is the product's scratch, the back-substitution's output (a
        # new tensor a call)
        self.y = None if backsub else f32(max(self.T, 1) * self.L)
        if scan:
            self.scratch = [None if backsub else f32(G * SPLIT * 6)]
            ptrs = [t0.img, t0.cam, t0.weight, t0.Hinv, t0.b_l, t0.H_cl,
                    t0.H_cc, None, self.y, t0.index.grp_ptr, t0.index.inc,
                    None, self.scratch[0]]
            self.slots = (7, 11, 8)          # v, out, y
            ints = [KINDS.index(t0.kind), t0.focal, self.T, t0.img.shape[1],
                    t0.n_images, t0.n_cameras, backsub, APPLY_ALL]
            name = "hybrid_apply_scan_launch"
        else:
            ptrs = [None, None]
            ints = [len(kinds), t0.focal, t0.n_images, t0.n_cameras,
                    backsub, APPLY_ALL]
            self.scratch = []
            for i, t in enumerate(kinds):
                T, S = t.img.shape
                y = self.y if i == 0 else f32(max(T, 1) * LAND[t.kind])
                contrib = None if backsub else f32(max(T * S * Dc, 1))
                self.scratch += [y, contrib]
                ptrs += [t.img, t.cam, t.weight, t.Hinv, t.b_l, t.H_cl,
                         t.H_cc, y, t.index.grp_ptr, t.index.inc, contrib]
                ints += [KINDS.index(t.kind), T, S]
            self.slots = (0, 1, 9)
            name = "hybrid_apply_launch"
        self.kinds = kinds               # the tensors the pointers name
        self.ptrs = _ptrs(*ptrs)
        self.ints = _ints(*ints)
        self.stage_slot = 7 if scan else 5
        self.fn = getattr(build(), name)
        self.name = name

    def __call__(self, v, stages=APPLY_ALL):
        check_tensor("v", v, torch.float32, (self.D,), self.device)
        v = v.contiguous()
        iv, io, iy = self.slots
        self.ptrs[iv] = v.data_ptr()
        if self.backsub:
            out = torch.empty((self.T, self.L), dtype=torch.float32,
                              device=self.device)
            self.ptrs[iy] = out.data_ptr()
        else:
            out = torch.empty(self.D, dtype=torch.float32,
                              device=self.device)
            self.ptrs[io] = out.data_ptr()
        self.ints[self.stage_slot] = stages
        if torch.cuda.current_device() == self.device.index:
            err = self.fn(self.ptrs, self.ints, None,
                          torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(self.device):
                err = self.fn(self.ptrs, self.ints, None,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name} failed: CUDA error {err}")
        return out


def _no_tracks(terms, v, backsub):
    """P's output where no kind has a track (nothing is launched)."""
    D = dims(terms.n_images, terms.n_cameras, terms.focal)
    check_tensor("v", v, torch.float32, (D,), v.device)
    if backsub:
        return torch.empty((0, LAND[terms.kind]), dtype=torch.float32,
                           device=v.device)
    return torch.zeros_like(v)


def _count_apply(kinds, backsub):
    key = "+".join(t.kind for t in kinds)
    _count(_APPLY, f"{key}, {'backsub' if backsub else 'apply'}")


def _apply_kernel(kinds, v, backsub):
    if not any(t.img.shape[0] for t in kinds):
        return _no_tracks(kinds[0], v, backsub)
    out = ApplyLaunch(kinds, v.device, backsub)(v)
    _count_apply(kinds, backsub)
    return out


def product_fn(tl: Terms, tp: Terms, device):
    """CG's product for one solve: a function v -> ``hybrid_apply_both(tl,
    tp, v)``, its launch prepared once (the terms do not change during a
    solve; each call allocates its output and counts its launch)."""
    if torch.device(device).type == "cpu":
        return lambda v: hybrid_apply_both_plain(tl, tp, v)
    _check_both(tl, tp)
    if not (tl.img.shape[0] or tp.img.shape[0]):
        return lambda v: _no_tracks(tl, v, False)
    launch = ApplyLaunch((tl, tp), device)
    key = "line+point, apply"

    def product(v):
        out = launch(v)
        _count(_APPLY, key)
        return out

    return product


hybrid_apply.launches = 0
hybrid_apply.counts = Counter()
_APPLY = hybrid_apply


def hybrid_apply_scan(terms: Terms, v, backsub=False):
    """Kernel P's first design (stage 2 re-reads each support's factors,
    two grid barriers), the yardstick; CUDA tensors only.
    ``hybrid_apply_scan.launches`` counts its launches."""
    if v.device.type != "cuda":
        raise ValueError("hybrid_apply_scan is a kernel of the card")
    if not terms.img.shape[0]:
        return _no_tracks(terms, v, backsub)
    out = ApplyLaunch((terms,), v.device, backsub, scan=True)(v)
    hybrid_apply_scan.launches += 1
    return out


hybrid_apply_scan.launches = 0
_APPLY_SCAN = hybrid_apply_scan


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
    """Set the launch counts of O (and its yardstick), P and Q to 0."""
    for fn in (_TERMS, _SCAN, _APPLY, _APPLY_SCAN, _COST):
        fn.launches = 0
    _TERMS.counts.clear()
    _APPLY.counts.clear()
