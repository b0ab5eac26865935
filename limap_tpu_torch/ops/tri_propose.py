"""Kernel F: the proposal half of the triangulator's bucket program.

For each (line a of an image, candidate line b of a neighbour) pair: the
ray-plane angle cull, the epipolar IoU, algebraic (or endpoint)
triangulation, the sensitivity cull, ``score > 0``, the ranges test and
the uncertainty min(u1, u2).  A proposal row is 9 floats: start (3), end
(3), depths in the own view (2), uncertainty; ``ok`` says whether the
pair survives every cull.

With ``use_vp`` and the lines' VPs given (``vp [I, L, 4]``: the VP in
its own image's pixels, then 1 where the line has one), form (a) adds
two VP banks: the triangulation along the world direction of line a's
VP (bank 1, a's view) and of line b's VP (bank 2, b's view), each with
no cull but ``has VP``, then ``score > 0``, the ranges and the
uncertainty.  The banks are bank-major columns, ``[algebraic T | VP of a
T | VP of b T]`` (the first absent under
``disable_algebraic_triangulation``).  The JAX package turns b's VP into
a direction with a's view; the port uses b's own view (ROADMAP.md
section 3).

Two input forms:

- :func:`propose`, the matcher paths: edge words ``[G, L, T]`` int32
  (``(b << 7) | slot``, -1 empty) from the host bucket, decoded through
  ``meta [G, K + 1]`` (the image's neighbour rows by slot, then its own
  row).  Out: tri ``[G * L, T, 9]`` and ok ``[G * L, T]``.
- :func:`count_exhaustive` and :func:`propose_exhaustive`, the
  exhaustive matcher: line a against every valid line of each neighbour,
  enumerated inside the kernel in the order slot, then neighbour line
  index.  The first counts each line's survivors (or each (line, slot)'s
  with ``per_slot``); the second writes them compacted in that order into
  a bucket of width ``W`` (words, tri, ok), with no cap: ``W`` must cover
  the largest count.  Each survivor goes to its line's offset of its slot
  (:func:`slot_offsets` of the per-slot counts, which the second pass takes
  from the first as ``slot_counts`` or counts itself) plus its rank in the
  slot.

CUDA tensors launch ``csrc/tri_propose.cu`` (the exhaustive passes: a
table launch of what depends on one line, :func:`exhaustive_tables`,
which the caller builds once and hands to both passes, then a launch a
pass over tiles of candidates staged in shared memory;
``count_exhaustive_scan`` and
``propose_exhaustive_scan`` launch the first design, a block a line
recomputing every candidate, kept as a yardstick for timing and
bit-equality); CPU tensors take the plain torch version (``*_plain``),
which evaluates the candidates of a chunk of lines at a time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from limap_tpu_torch.base import line_geometry as lgeo
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.triangulation import functions as trifun

SOURCE = "tri_propose.cu"
# candidates the plain exhaustive form evaluates at once
CANDIDATE_BUDGET = 1 << 18


# the kinds of proposal bank: algebraic (or endpoint), along the VP of
# the own line, along the VP of the neighbour line
BANK_ALGEBRAIC, BANK_VP_OWN, BANK_VP_NEIGHBOUR = 0, 1, 2


def banks(cfg, vp=None):
    """The proposal banks of form (a), in column order."""
    kinds = [] if cfg.disable_algebraic_triangulation else [BANK_ALGEBRAIC]
    if cfg.use_vp and not cfg.disable_vp_triangulation and vp is not None:
        kinds += [BANK_VP_OWN, BANK_VP_NEIGHBOUR]
    if not kinds:
        raise ValueError("no proposal bank: disable_algebraic_triangulation "
                         "needs use_vp and the lines' VPs")
    return kinds


def check_exhaustive(cfg) -> None:
    """The exhaustive form has the algebraic / endpoint bank only."""
    if cfg.use_vp and not cfg.disable_vp_triangulation:
        raise NotImplementedError(
            "the exhaustive matcher with VP triangulation is not ported "
            "(ROADMAP.md queue 2): its VP banks have no cull, so every "
            "(line, neighbour line) pair with a VP would survive")
    if cfg.disable_algebraic_triangulation:
        raise NotImplementedError(
            "the exhaustive matcher has only the algebraic / endpoint bank")


def bucket_width(max_count: int) -> int:
    """The bucket's cover of a line's largest edge or survivor count: 2
    or 4 for tiny scenes, else the next multiple of 8."""
    if max_count <= 2:
        return 2
    if max_count <= 4:
        return 4
    return int(8 * ((max_count + 7) // 8))


def _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges, vp=None):
    I = cam_packed.shape[0]
    G = meta.shape[0]
    dev = meta.device
    check_tensor("l2d_packed", l2d_packed, torch.float32, (I, L, 6), dev)
    check_tensor("cam_packed", cam_packed, torch.float32, (I, 12), dev)
    check_tensor("meta", meta, torch.int32, (G, K + 1), dev)
    if vp is not None:
        check_tensor("vp", vp, torch.float32, (I, L, 4), dev)
    if ranges is not None:
        for r in ranges:
            check_tensor("ranges", r, torch.float32, (3,), dev)
    if K > 127:
        raise ValueError("at most 127 neighbours per image: the edge word "
                         "keeps the slot in 7 bits")


def _pairs(l2d_packed, cam_packed, row, a, ng_row, b, cand_ok):
    """Segments and views of the pairs and which pairs have a valid line
    on both sides: (l1, v1, l2, v2, valid)."""
    L = l2d_packed.shape[1]
    l2d_flat = l2d_packed.reshape(-1, 6)
    own = l2d_flat[row * L + a]                                 # [M, 6]
    nb = l2d_flat[ng_row * L + b]                               # [M, T, 6]
    cam1 = cam_packed[row][:, None]                             # [M, 1, 12]
    cam2 = cam_packed[ng_row]                                   # [M, T, 12]
    l1 = Segments(own[:, None, 0:2], own[:, None, 2:4])
    l2 = Segments(nb[..., 0:2], nb[..., 2:4])
    v1 = CameraViewsBatch(cam1[..., 0:4], cam1[..., 4:8], cam1[..., 8:11])
    v2 = CameraViewsBatch(cam2[..., 0:4], cam2[..., 4:8], cam2[..., 8:11])
    valid = cand_ok & (own[:, None, 4] > 0.5) & (nb[..., 4] > 0.5)
    return l1, v1, l2, v2, valid


def _finish(cfg, tri, ok, v1, v2, ranges):
    """``score > 0``, the ranges and the uncertainty: (rows [..., 9],
    ok)."""
    ok = ok & (tri.score > 0)
    if ranges is not None:
        ok = ok & trifun.test_line_inside_ranges(tri, ranges)
    unc = torch.minimum(lgeo.compute_uncertainty(tri, v1, cfg.var2d),
                        lgeo.compute_uncertainty(tri, v2, cfg.var2d))
    rows = torch.cat([tri.start, tri.end, tri.depths, unc[..., None]], -1)
    return rows, ok


def propose_rows(cfg, l2d_packed, cam_packed, row, a, ng_row, b, cand_ok,
                 ranges=None):
    """The algebraic (or endpoint) proposal of each pair, plain torch.
    ``row``, ``a`` [M]: the own image row and line; ``ng_row``, ``b`` [M,
    T]: the neighbour's; ``cand_ok`` [M, T]: the pair is a candidate.
    Returns tri [M, T, 9] and ok [M, T]."""
    l1, v1, l2, v2, valid = _pairs(l2d_packed, cam_packed, row, a, ng_row,
                                   b, cand_ok)
    n2 = trifun.get_normal_direction(l2, v2)

    def ray_angle(p):
        c = torch.abs(torch.sum(n2 * v1.ray_direction(p), -1))
        return 90.0 - torch.rad2deg(torch.arccos(torch.clamp(c, 0, 1)))

    ok = ((ray_angle(l1.start) >= cfg.line_tri_angle_threshold)
          & (ray_angle(l1.end) >= cfg.line_tri_angle_threshold))
    ok = ok & (trifun.compute_epipolar_iou(l1, v1, l2, v2)
               >= cfg.IoU_threshold)
    if cfg.use_endpoints_triangulation:
        tri = trifun.triangulate_line_by_endpoints(l1, v1, l2, v2)
    else:
        tri = trifun.triangulate_line_algebraic(l1, v1, l2, v2)
    s1 = lgeo.sensitivity(tri, v1)
    s2 = lgeo.sensitivity(tri, v2)
    ok = ok & ~((s1 > cfg.sensitivity_threshold)
                & (s2 > cfg.sensitivity_threshold))
    return _finish(cfg, tri, ok & valid, v1, v2, ranges)


def vp_direction(kind, vp, row, a, ng_row, b, v1, v2):
    """World direction [M, T, 3] and has-VP [M, T] of a VP bank: the own
    line's VP in its view or the neighbour line's VP in its view."""
    L = vp.shape[1]
    flat = vp.reshape(-1, 4)
    if kind == BANK_VP_OWN:
        v = flat[row * L + a][:, None].expand(ng_row.shape + (4,))
        view = v1
    else:
        v = flat[ng_row * L + b]
        view = v2
    return trifun.get_direction_from_vp(v[..., :3], view), v[..., 3] > 0.5


def propose_rows_vp(cfg, kind, vp, l2d_packed, cam_packed, row, a, ng_row,
                    b, cand_ok, ranges=None):
    """A VP bank's proposal of each pair, plain torch: no cull but the
    VP, then ``score > 0``, the ranges and the uncertainty."""
    l1, v1, l2, v2, valid = _pairs(l2d_packed, cam_packed, row, a, ng_row,
                                   b, cand_ok)
    direc, has = vp_direction(kind, vp, row, a, ng_row, b, v1, v2)
    tri = trifun.triangulate_line_with_direction(l1, v1, l2, v2, direc)
    return _finish(cfg, tri, valid & has, v1, v2, ranges)


def decode_words(words: torch.Tensor, meta: torch.Tensor, L: int, K: int):
    """Edge words [G, L, T] -> (row [N], a [N], ng_row [N, T], b [N, T],
    slot [N, T], valid [N, T]) with N = G * L."""
    G, _, T = words.shape
    dev = words.device
    word = words.reshape(G * L, T)
    valid = word >= 0
    w = torch.clamp(word, min=0)
    b = (w >> 7).long()
    slot = (w & 0x7F).long()
    g_ids = torch.arange(G, device=dev).repeat_interleave(L)
    ng_row = meta[:, :K].long().reshape(G * K)[
        g_ids[:, None] * K + torch.clamp(slot, 0, K - 1)]
    valid = valid & (ng_row >= 0)
    row = meta[:, K].long()[g_ids]
    a = torch.arange(L, device=dev).repeat(G)
    return row, a, torch.clamp(ng_row, min=0), b, slot, valid


def propose_plain(cfg, L, K, l2d_packed, cam_packed, words, meta,
                  ranges=None, vp=None):
    """Form (a) in torch ops, its banks concatenated bank-major."""
    row, a, ng_row, b, _, valid = decode_words(words, meta, L, K)
    outs = []
    for kind in banks(cfg, vp):
        if kind == BANK_ALGEBRAIC:
            outs.append(propose_rows(cfg, l2d_packed, cam_packed, row, a,
                                     ng_row, b, valid, ranges))
        else:
            outs.append(propose_rows_vp(cfg, kind, vp, l2d_packed,
                                        cam_packed, row, a, ng_row, b,
                                        valid, ranges))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([t for t, _ in outs], 1),
            torch.cat([o for _, o in outs], 1))


def _exhaustive_chunks(cfg, L, K, l2d_packed, cam_packed, meta, ranges):
    """Yield (first line n0, words [c, K * L], ok [c, K * L], tri) over
    chunks of the G * L lines, every candidate in slot-major order."""
    G = meta.shape[0]
    dev = meta.device
    C = K * L
    slot = torch.arange(K, device=dev).repeat_interleave(L)      # [C]
    b = torch.arange(L, device=dev).repeat(K)                   # [C]
    word = (b << 7) | slot
    nbr = meta[:, :K].long()
    step = max(1, CANDIDATE_BUDGET // max(C, 1))
    for n0 in range(0, G * L, step):
        n = torch.arange(n0, min(n0 + step, G * L), device=dev)
        g = n // L
        ng_row = nbr[g][:, slot]                                # [c, C]
        tri, ok = propose_rows(
            cfg, l2d_packed, cam_packed, meta[g, K].long(), n % L,
            torch.clamp(ng_row, min=0), b.expand(len(n), C), ng_row >= 0,
            ranges)
        yield n0, word.expand(len(n), C), ok, tri


def count_slots_plain(cfg, L, K, l2d_packed, cam_packed, meta,
                      ranges=None):
    """Form (b)'s count of each (line, slot) [G * L, K] int32, in torch
    ops."""
    check_exhaustive(cfg)
    counts = torch.zeros((meta.shape[0] * L, K), dtype=torch.int32,
                         device=meta.device)
    for n0, _, ok, _ in _exhaustive_chunks(cfg, L, K, l2d_packed,
                                           cam_packed, meta, ranges):
        counts[n0:n0 + len(ok)] = ok.reshape(len(ok), K, L).sum(-1).to(
            torch.int32)
    return counts


def slot_offsets(slot_counts):
    """Each (line, slot)'s first place in the line's bucket, the
    exclusive scan of ``slot_counts`` [N, K] in slot order, and each
    line's survivors [N]."""
    ends = torch.cumsum(slot_counts, 1, dtype=torch.int32)
    return (ends - slot_counts).contiguous(), slot_counts.sum(
        1, dtype=torch.int32)


def count_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed, meta,
                           ranges=None):
    """Form (b)'s count in torch ops."""
    check_exhaustive(cfg)
    counts = torch.zeros(meta.shape[0] * L, dtype=torch.int32,
                         device=meta.device)
    for n0, _, ok, _ in _exhaustive_chunks(cfg, L, K, l2d_packed,
                                           cam_packed, meta, ranges):
        counts[n0:n0 + len(ok)] = ok.sum(1).to(torch.int32)
    return counts


def propose_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed, meta, W,
                             ranges=None):
    """Form (b)'s write in torch ops."""
    check_exhaustive(cfg)
    N = meta.shape[0] * L
    dev = meta.device
    words = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    tri = torch.zeros((N, W, 9), dtype=torch.float32, device=dev)
    ok_out = torch.zeros((N, W), dtype=torch.bool, device=dev)
    for n0, word, ok, rows in _exhaustive_chunks(cfg, L, K, l2d_packed,
                                                 cam_packed, meta, ranges):
        c = len(ok)
        cnt = int(ok.sum(1).max()) if c else 0
        if cnt > W:
            raise ValueError(f"a line has {cnt} survivors, more than the "
                             f"bucket width {W}")
        # stable compaction: survivors first, in candidate order
        order = torch.argsort((~ok).to(torch.int32), dim=1,
                              stable=True)[:, :W]
        keep = torch.gather(ok, 1, order)
        sl = slice(n0, n0 + c)
        words[sl, :order.shape[1]] = torch.where(
            keep, torch.gather(word, 1, order).to(torch.int32),
            torch.full_like(order, -1, dtype=torch.int32))
        tri[sl, :order.shape[1]] = torch.where(
            keep[..., None],
            torch.gather(rows, 1, order[..., None].expand(-1, -1, 9)),
            torch.zeros((), device=dev))
        ok_out[sl, :order.shape[1]] = keep
    return words, tri, ok_out


def config_params(cfg) -> np.ndarray:
    """The kernel's float parameters, in the order of its Params."""
    return np.asarray([cfg.line_tri_angle_threshold, cfg.IoU_threshold,
                       cfg.sensitivity_threshold, cfg.var2d,
                       float(cfg.use_endpoints_triangulation)], np.float32)


def bank_code(kinds) -> int:
    """The kernel's bank argument: the first bank's kind, then 4 x the
    number of banks (consecutive kinds)."""
    return kinds[0] + 4 * len(kinds)


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # l2d, cam, meta, words, ranges, params, vp, G, L, K, T/W, mode,
    # banks, counts, words_out, tri, ok, stream
    lib.tri_propose_launch.argtypes = [ptr] * 7 + [i64] * 6 + [ptr] * 5
    lib.tri_propose_launch.restype = ctypes.c_int
    pp, pi = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(i64)
    lib.tri_exhaustive_tables.argtypes = [pp, pi, ptr]
    lib.tri_exhaustive_tables.restype = ctypes.c_int
    lib.tri_exhaustive_launch.argtypes = [pp, pi,
                                          ctypes.POINTER(ctypes.c_float), ptr]
    lib.tri_exhaustive_launch.restype = ctypes.c_int
    return lib


MODE_WORDS, MODE_COUNT, MODE_WRITE = 0, 1, 2


def _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, mode,
            words=None, W=0, counts=None, words_out=None, tri=None,
            ok=None, vp=None, kinds=(BANK_ALGEBRAIC,), counter=None):
    G = meta.shape[0]
    rng = None
    if ranges is not None:
        rng = torch.cat([ranges[0], ranges[1]]).contiguous()
    params = config_params(cfg)
    args = [l2d_packed.contiguous(), cam_packed.contiguous(),
            meta.contiguous(), words, rng]
    with torch.cuda.device(meta.device):
        err = build().tri_propose_launch(
            *(None if t is None else t.data_ptr() for t in args),
            params.ctypes.data, None if vp is None else vp.data_ptr(),
            G, L, K, W, mode, bank_code(kinds),
            *(None if t is None else t.data_ptr()
              for t in (counts, words_out, tri, ok)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tri_propose launch failed: CUDA error {err}")
    (counter or _COUNTER).launches += 1


def propose(cfg, L, K, l2d_packed, cam_packed, words, meta, ranges=None,
            vp=None):
    """Form (a): tri [G * L, B * T, 9] and ok [G * L, B * T] of the
    bucketed edge words, for the B banks of :func:`banks`
    (``propose.launches`` counts the kernel's launches, of every
    form)."""
    kinds = banks(cfg, vp)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges, vp)
    G, T = meta.shape[0], words.shape[-1]
    check_tensor("words", words, torch.int32, (G, L, T), meta.device)
    if meta.device.type == "cpu":
        return propose_plain(cfg, L, K, l2d_packed, cam_packed, words, meta,
                             ranges, vp)
    B = len(kinds)
    tri = torch.empty((G * L, B * T, 9), dtype=torch.float32,
                      device=meta.device)
    ok = torch.empty((G * L, B * T), dtype=torch.bool, device=meta.device)
    if G * L * T:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_WORDS,
                words=words.contiguous(), W=T, tri=tri, ok=ok,
                vp=None if vp is None else vp.contiguous(), kinds=kinds)
    return tri, ok


propose.launches = 0
# the count lives on propose itself, also while a caller has wrapped the
# module's name (chip_smoke records the path's inputs that way)
_COUNTER = propose


class ExhaustiveTables(NamedTuple):
    """What the exhaustive passes read of one line or one image, written
    once by the table launch (csrc/tri_propose.cu, step 1)."""
    L: int
    cull: torch.Tensor        # [I * L, 12] the culls' fields of a line
    rest: torch.Tensor        # [I * L, 12] its rays, normal, end point
    views: torch.Tensor       # [I, 20] an image's view and centre


def exhaustive_tables(L, l2d_packed, cam_packed):
    """The exhaustive passes' tables of every line slot and image (one
    launch), to hand to both passes; None for CPU tensors, whose plain
    version reads none.  ``exhaustive_tables.launches`` counts the
    launches."""
    I, dev = cam_packed.shape[0], cam_packed.device
    check_tensor("l2d_packed", l2d_packed, torch.float32, (I, L, 6), dev)
    if dev.type == "cpu":
        return None
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    tables = ExhaustiveTables(L, e(I * L, 12), e(I * L, 12), e(I, 20))
    ptrs = [l2d_packed.contiguous(), cam_packed.contiguous(), tables.cull,
            tables.rest, tables.views]
    with torch.cuda.device(dev):
        err = build().tri_exhaustive_tables(
            (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs]),
            (ctypes.c_longlong * 2)(I, L),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tri_exhaustive_tables failed: CUDA error {err}")
    exhaustive_tables.launches += 1
    return tables


exhaustive_tables.launches = 0


def _check_tables(L, cam_packed, tables):
    """``tables`` are :func:`exhaustive_tables` of L lines an image of
    these cameras, on their device."""
    I, dev = cam_packed.shape[0], cam_packed.device
    if not isinstance(tables, ExhaustiveTables) or tables.L != L:
        raise ValueError(f"exhaustive tables of L = {L} expected")
    for name, t, n in (("cull", tables.cull, (I * L, 12)),
                       ("rest", tables.rest, (I * L, 12)),
                       ("views", tables.views, (I, 20))):
        check_tensor(name, t, torch.float32, n, dev)


def _tables_for(L, l2d_packed, cam_packed, tables):
    return (exhaustive_tables(L, l2d_packed, cam_packed) if tables is None
            else tables)


def _launch_tiled(cfg, L, K, tables, meta, ranges, mode, scounts, W=0,
                  offsets=None, words=None, tri=None, ok=None):
    """One tiled exhaustive pass (tri_exhaustive_launch) on ``tables``."""
    lo_hi = [0.0] * 6
    if ranges is not None:
        lo_hi = torch.cat([ranges[0], ranges[1]]).cpu().tolist()
    f = np.asarray(list(config_params(cfg)) + [float(ranges is not None)]
                   + lo_hi, np.float32)
    ptrs = [meta.contiguous(), tables.cull, tables.rest, tables.views,
            offsets, scounts, words, tri, ok]
    with torch.cuda.device(meta.device):
        err = build().tri_exhaustive_launch(
            (ctypes.c_void_p * len(ptrs))(
                *[None if t is None else t.data_ptr() for t in ptrs]),
            (ctypes.c_longlong * 5)(meta.shape[0], L, K, W, mode),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tri_exhaustive launch failed: CUDA error {err}")
    _COUNTER.launches += 1


def count_exhaustive(cfg, L, K, l2d_packed, cam_packed, meta, ranges=None,
                     per_slot=False, tables=None):
    """Form (b), first pass: each line's survivors [G * L] int32, or
    with ``per_slot`` each (line, slot)'s [G * L, K].  ``tables`` is
    :func:`exhaustive_tables` of these lines (built here when None)."""
    check_exhaustive(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    if tables is not None:
        _check_tables(L, cam_packed, tables)
    if meta.device.type == "cpu":
        if per_slot:
            return count_slots_plain(cfg, L, K, l2d_packed, cam_packed,
                                     meta, ranges)
        return count_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed,
                                      meta, ranges)
    scounts = torch.zeros((meta.shape[0] * L, K), dtype=torch.int32,
                          device=meta.device)
    if scounts.numel():
        _launch_tiled(cfg, L, K, _tables_for(L, l2d_packed, cam_packed,
                                             tables),
                      meta, ranges, MODE_COUNT, scounts)
    return scounts if per_slot else slot_offsets(scounts)[1]


def propose_exhaustive(cfg, L, K, l2d_packed, cam_packed, meta, W,
                       ranges=None, slot_counts=None, tables=None):
    """Form (b), second pass: each line's survivors compacted in the
    order slot, then neighbour line, into words [G * L, W] int32 (-1
    empty), tri [G * L, W, 9] and ok [G * L, W].  ``W`` must cover the
    largest count; the wrapper raises otherwise.  ``slot_counts`` [G * L,
    K] is the first pass's per-slot count of these lines
    (:func:`count_exhaustive` with ``per_slot``; without it the pass
    counts first, one launch more), ``tables`` the first pass's
    :func:`exhaustive_tables` (built here when None)."""
    check_exhaustive(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    N = meta.shape[0] * L
    dev = meta.device
    if slot_counts is not None:
        check_tensor("slot_counts", slot_counts, torch.int32, (N, K), dev)
    if tables is not None:
        _check_tables(L, cam_packed, tables)
    if meta.device.type == "cpu":
        return propose_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed,
                                        meta, W, ranges)
    words = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    tri = torch.zeros((N, W, 9), dtype=torch.float32, device=dev)
    ok = torch.zeros((N, W), dtype=torch.bool, device=dev)
    if not (N and K):
        return words, tri, ok
    tables = _tables_for(L, l2d_packed, cam_packed, tables)
    if slot_counts is None:
        slot_counts = count_exhaustive(cfg, L, K, l2d_packed, cam_packed,
                                       meta, ranges, per_slot=True,
                                       tables=tables)
    offsets, totals = slot_offsets(slot_counts)
    if int(totals.max()) > W:
        raise ValueError(f"a line has {int(totals.max())} survivors, "
                         f"more than the bucket width {W}")
    scounts = torch.zeros((N, K), dtype=torch.int32, device=dev)
    _launch_tiled(cfg, L, K, tables, meta, ranges, MODE_WRITE, scounts, W,
                  offsets, words, tri, ok)
    if not torch.equal(scounts, slot_counts):
        raise RuntimeError("tri_propose: the write pass found other "
                           "survivors than the slot counts it was given")
    return words, tri, ok


def count_exhaustive_scan(cfg, L, K, l2d_packed, cam_packed, meta,
                          ranges=None):
    """The first design's count (a block a line, every candidate from
    scratch): the yardstick of :func:`count_exhaustive`, CUDA only."""
    check_exhaustive(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    if meta.device.type != "cuda":
        raise ValueError("count_exhaustive_scan is a kernel of the card")
    counts = torch.zeros(meta.shape[0] * L, dtype=torch.int32,
                         device=meta.device)
    if counts.numel() and K:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_COUNT,
                counts=counts, counter=_SCAN)
    return counts


def propose_exhaustive_scan(cfg, L, K, l2d_packed, cam_packed, meta, W,
                            ranges=None):
    """The first design's write (a block a line): the yardstick of
    :func:`propose_exhaustive`, CUDA only; words, tri, ok and each line's
    count.  ``propose_exhaustive_scan.launches`` counts the launches of
    both scan passes."""
    check_exhaustive(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    if meta.device.type != "cuda":
        raise ValueError("propose_exhaustive_scan is a kernel of the card")
    N = meta.shape[0] * L
    dev = meta.device
    words = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    tri = torch.zeros((N, W, 9), dtype=torch.float32, device=dev)
    ok = torch.zeros((N, W), dtype=torch.bool, device=dev)
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    if N and K:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_WRITE,
                W=W, counts=counts, words_out=words, tri=tri, ok=ok,
                counter=_SCAN)
    return words, tri, ok, counts


propose_exhaustive_scan.launches = 0
_SCAN = propose_exhaustive_scan
