"""Kernel F: the proposal half of the triangulator's bucket program.

For each (line a of an image, candidate line b of a neighbour) pair: the
ray-plane angle cull, the epipolar IoU, algebraic (or endpoint)
triangulation, the sensitivity cull, ``score > 0``, the ranges test and
the uncertainty min(u1, u2).  A proposal row is 9 floats: start (3), end
(3), depths in the own view (2), uncertainty; ``ok`` says whether the
pair survives every cull.

Two input forms:

- :func:`propose`, the matcher paths: edge words ``[G, L, T]`` int32
  (``(b << 7) | slot``, -1 empty) from the host bucket, decoded through
  ``meta [G, K + 1]`` (the image's neighbour rows by slot, then its own
  row).  Out: tri ``[G * L, T, 9]`` and ok ``[G * L, T]``.
- :func:`count_exhaustive` and :func:`propose_exhaustive`, the
  exhaustive matcher: line a against every valid line of each neighbour,
  enumerated inside the kernel in the order slot, then neighbour line
  index.  The first counts each line's survivors; the second writes them
  compacted in that order into a bucket of width ``W`` (words, tri, ok),
  with no cap: ``W`` must cover the largest count.

CUDA tensors launch ``csrc/tri_propose.cu``; CPU tensors take the plain
torch version (``*_plain``), which evaluates the candidates of a chunk
of lines at a time.
"""

from __future__ import annotations

import ctypes

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


def check_config(cfg) -> None:
    """The proposal bank the port has: algebraic or endpoint, no VP."""
    if cfg.use_vp and not cfg.disable_vp_triangulation:
        raise NotImplementedError("VP triangulation is not ported yet "
                                  "(ROADMAP.md queue 1 item 12)")
    if cfg.disable_algebraic_triangulation:
        raise NotImplementedError(
            "only the algebraic / endpoint proposal bank is ported")


def bucket_width(max_count: int) -> int:
    """The bucket's cover of a line's largest edge or survivor count: 2
    or 4 for tiny scenes, else the next multiple of 8."""
    if max_count <= 2:
        return 2
    if max_count <= 4:
        return 4
    return int(8 * ((max_count + 7) // 8))


def _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges):
    I = cam_packed.shape[0]
    G = meta.shape[0]
    dev = meta.device
    check_tensor("l2d_packed", l2d_packed, torch.float32, (I, L, 6), dev)
    check_tensor("cam_packed", cam_packed, torch.float32, (I, 12), dev)
    check_tensor("meta", meta, torch.int32, (G, K + 1), dev)
    if ranges is not None:
        for r in ranges:
            check_tensor("ranges", r, torch.float32, (3,), dev)
    if K > 127:
        raise ValueError("at most 127 neighbours per image: the edge word "
                         "keeps the slot in 7 bits")


def propose_rows(cfg, l2d_packed, cam_packed, row, a, ng_row, b, cand_ok,
                 ranges=None):
    """The proposal of each pair, plain torch.  ``row``, ``a`` [M]: the
    own image row and line; ``ng_row``, ``b`` [M, T]: the neighbour's;
    ``cand_ok`` [M, T]: the pair is a candidate.  Returns tri [M, T, 9]
    and ok [M, T]."""
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
    ok = ok & valid & (tri.score > 0)
    if ranges is not None:
        ok = ok & trifun.test_line_inside_ranges(tri, ranges)
    unc = torch.minimum(lgeo.compute_uncertainty(tri, v1, cfg.var2d),
                        lgeo.compute_uncertainty(tri, v2, cfg.var2d))
    rows = torch.cat([tri.start, tri.end, tri.depths, unc[..., None]], -1)
    return rows, ok


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
                  ranges=None):
    """Form (a) in torch ops."""
    row, a, ng_row, b, _, valid = decode_words(words, meta, L, K)
    return propose_rows(cfg, l2d_packed, cam_packed, row, a, ng_row, b,
                        valid, ranges)


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


def count_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed, meta,
                           ranges=None):
    """Form (b)'s count in torch ops."""
    counts = torch.zeros(meta.shape[0] * L, dtype=torch.int32,
                         device=meta.device)
    for n0, _, ok, _ in _exhaustive_chunks(cfg, L, K, l2d_packed,
                                           cam_packed, meta, ranges):
        counts[n0:n0 + len(ok)] = ok.sum(1).to(torch.int32)
    return counts


def propose_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed, meta, W,
                             ranges=None):
    """Form (b)'s write in torch ops."""
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


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # l2d, cam, meta, words, ranges, params, G, L, K, T/W, mode, counts,
    # words_out, tri, ok, stream
    lib.tri_propose_launch.argtypes = [ptr] * 6 + [i64] * 5 + [ptr] * 5
    lib.tri_propose_launch.restype = ctypes.c_int
    return lib


MODE_WORDS, MODE_COUNT, MODE_WRITE = 0, 1, 2


def _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, mode,
            words=None, W=0, counts=None, words_out=None, tri=None,
            ok=None):
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
            params.ctypes.data, G, L, K, W, mode,
            *(None if t is None else t.data_ptr()
              for t in (counts, words_out, tri, ok)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tri_propose launch failed: CUDA error {err}")
    _COUNTER.launches += 1


def propose(cfg, L, K, l2d_packed, cam_packed, words, meta, ranges=None):
    """Form (a): tri [G * L, T, 9] and ok [G * L, T] of the bucketed
    edge words (``propose.launches`` counts the kernel's launches, of
    every form)."""
    check_config(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    G, T = meta.shape[0], words.shape[-1]
    check_tensor("words", words, torch.int32, (G, L, T), meta.device)
    if meta.device.type == "cpu":
        return propose_plain(cfg, L, K, l2d_packed, cam_packed, words, meta,
                             ranges)
    tri = torch.empty((G * L, T, 9), dtype=torch.float32, device=meta.device)
    ok = torch.empty((G * L, T), dtype=torch.bool, device=meta.device)
    if G * L * T:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_WORDS,
                words=words.contiguous(), W=T, tri=tri, ok=ok)
    return tri, ok


propose.launches = 0
# the count lives on propose itself, also while a caller has wrapped the
# module's name (chip_smoke records the path's inputs that way)
_COUNTER = propose


def count_exhaustive(cfg, L, K, l2d_packed, cam_packed, meta, ranges=None):
    """Form (b), first pass: each line's survivors [G * L] int32."""
    check_config(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    if meta.device.type == "cpu":
        return count_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed,
                                      meta, ranges)
    counts = torch.zeros(meta.shape[0] * L, dtype=torch.int32,
                         device=meta.device)
    if counts.numel() and K:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_COUNT,
                counts=counts)
    return counts


def propose_exhaustive(cfg, L, K, l2d_packed, cam_packed, meta, W,
                       ranges=None):
    """Form (b), second pass: each line's survivors compacted in the
    order slot, then neighbour line, into words [G * L, W] int32 (-1
    empty), tri [G * L, W, 9] and ok [G * L, W].  ``W`` must cover the
    largest count of :func:`count_exhaustive`; the kernel raises
    otherwise."""
    check_config(cfg)
    _check_inputs(L, K, l2d_packed, cam_packed, meta, ranges)
    if meta.device.type == "cpu":
        return propose_exhaustive_plain(cfg, L, K, l2d_packed, cam_packed,
                                        meta, W, ranges)
    N = meta.shape[0] * L
    dev = meta.device
    words = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    tri = torch.zeros((N, W, 9), dtype=torch.float32, device=dev)
    ok = torch.zeros((N, W), dtype=torch.bool, device=dev)
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    if N and K:
        _launch(cfg, L, K, l2d_packed, cam_packed, meta, ranges, MODE_WRITE,
                W=W, counts=counts, words_out=words, tri=tri, ok=ok)
        if int(counts.max()) > W:
            raise ValueError(f"a line has {int(counts.max())} survivors, "
                             f"more than the bucket width {W}")
    return words, tri, ok
