"""Kernel G: the scoring half of the triangulator's bucket program.

For each line, every ordered pair (i, j) of its proposals with different
slots scores min(score_3d (shared-parent linker), score_2d (proposal i
projected into j's neighbour view, against j's 2D segment)).  A
proposal's score is the per-slot maximum over j, summed over the slots
in slot order; -1 for a proposal that is not ok.  Then the best proposal
(first index on ties), the valid edges (ok, score >= ``fullscore_th``,
among the ``max_valid_conns`` best with ties by index) and their stable
pack.

Inputs: edge words ``[G, L, T]`` (``(b << 7) | slot``), ``meta [G, K +
1]``, the proposals ``tri [G * L, T, 9]`` and ``ok [G * L, T]`` of
kernel F.  Outputs: floats ``[G, L, 10]`` (best start, end, depths,
uncertainty, score; a line with no ok proposal writes the start, end and
depths of its proposal 0 as they are, as the JAX package does, which in
the exhaustive bucket is the zero row of an empty slot, then uncertainty
1e30 and score -1) and ints ``[G, L, T + 1]`` (packed valid edges as
global node ids ``ng_row * L + b``, -1 padded, then their count).

CUDA tensors launch ``csrc/tri_score.cu``, one block a line, which never
builds the ``[T, T]`` pair grid; CPU tensors take :func:`score_plain`,
torch ops over chunks of lines of similar width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.base import line_geometry as lgeo
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import score_2d, score_3d
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.ops import tri_propose

SOURCE = "tri_score.cu"
# proposal pairs the plain version scores at once
PAIR_BUDGET = 1 << 21


def _score_chunk(cfg, K, T, l2d_packed, cam_packed, ng_row, b, slot, tri,
                 ok, per_slot_only=False):
    """Rows of the lines of one chunk: (floats [c, 10], ints [c, T + 1],
    scores [c, w]) for proposals trimmed to width w; with
    ``per_slot_only`` the per-slot maxima [c, w, K] and which pairs
    [c, w, w] pass every gate (score > 0)."""
    c, w = ok.shape
    dev = ok.device
    L = l2d_packed.shape[1]
    nb = l2d_packed.reshape(-1, 6)[ng_row * L + b]              # [c, w, 6]
    cam2 = cam_packed[ng_row]                                   # [c, w, 12]
    tS, tE, tD, tU = tri[..., 0:3], tri[..., 3:6], tri[..., 6:8], tri[..., 8]
    # pairs [c, w (i), w (j)]
    l_i = Segments(tS[:, :, None], tE[:, :, None], depths=tD[:, :, None],
                   uncertainty=tU[:, :, None])
    l_j = Segments(tS[:, None], tE[:, None], depths=tD[:, None],
                   uncertainty=tU[:, None])
    s3d = score_3d(l_i, l_j, cfg.linker3d.to_shared_parent_scoring())
    vj = CameraViewsBatch(cam2[:, None, :, 0:4], cam2[:, None, :, 4:8],
                          cam2[:, None, :, 8:11])
    proj = lgeo.project_segments(Segments(tS[:, :, None], tE[:, :, None]),
                                 vj)
    s2d = score_2d(proj, Segments(nb[:, None, :, 0:2], nb[:, None, :, 2:4]),
                   cfg.linker2d)
    s = torch.minimum(s3d, s2d)
    del s3d, s2d, proj
    pair_ok = ok[:, :, None] & ok[:, None] & (slot[:, :, None]
                                              != slot[:, None])
    s = torch.where(pair_ok, s, torch.zeros_like(s))
    per_slot = torch.zeros((c, w, K), dtype=s.dtype, device=dev)
    per_slot.scatter_reduce_(2, slot[:, None].expand(c, w, w), s,
                             reduce="amax", include_self=True)
    if per_slot_only:
        return per_slot, s > 0
    total = torch.zeros((c, w), dtype=s.dtype, device=dev)
    for k in range(K):
        total = total + per_slot[..., k]
    scores = torch.where(ok, total, torch.full_like(total, -1.0))

    r = torch.arange(c, device=dev)
    best = torch.argmax(scores, dim=1)
    has_any = ok[r, best]
    row = tri[r, best]
    floats = torch.cat([
        row[:, :8],
        torch.where(has_any, row[:, 8], torch.full_like(row[:, 8], 1e30))[
            :, None],
        torch.where(has_any, scores[r, best],
                    torch.full_like(row[:, 8], -1.0))[:, None]], 1)
    valid_e = ok & (scores >= cfg.fullscore_th)
    if cfg.max_valid_conns < w:
        rank = torch.argsort(torch.argsort(-scores, dim=1, stable=True),
                             dim=1, stable=True)
        valid_e = valid_e & (rank < cfg.max_valid_conns)
    cnt = torch.clamp(valid_e.sum(1), max=T)
    order = torch.argsort((~valid_e).to(torch.int32), dim=1, stable=True)
    packed = torch.gather(ng_row * L + b, 1, order)[:, :T]
    ints = torch.full((c, T + 1), -1, dtype=torch.int64, device=dev)
    ints[:, :packed.shape[1]] = packed
    ints[torch.arange(T + 1, device=dev)[None].expand(c, T + 1)
         >= cnt[:, None]] = -1
    ints[:, T] = cnt
    return floats, ints.to(torch.int32), scores


def width_chunks(width: torch.Tensor, budget: int):
    """Lines of width >= 1 in chunks of similar width: yields (line
    indices, the chunk's width w) with len * w^2 <= budget (or a single
    line)."""
    order = torch.argsort(width, stable=True)
    ws = width[order].cpu().numpy()
    i = int(np.searchsorted(ws, 1))
    while i < len(ws):
        j = min(len(ws), i + max(1, budget // int(ws[i]) ** 2))
        while j > i + 1 and (j - i) * int(ws[j - 1]) ** 2 > budget:
            j = i + max(1, budget // int(ws[j - 1]) ** 2)
        yield order[i:j], int(ws[j - 1])
        i = j


def score_plain(cfg, L, K, l2d_packed, cam_packed, words, meta, tri, ok,
                return_scores=False):
    """Torch ops over chunks of lines, in the proposals' dtype.  A
    line's proposals are trimmed
    to its last ok one (the rest score -1 and pair with nothing), and
    the lines go in chunks of similar width of at most ``PAIR_BUDGET``
    pairs."""
    G, _, T = words.shape
    N = G * L
    dev = words.device
    _, _, ng_row, b, slot, _ = tri_propose.decode_words(words, meta, L, K)
    pos = torch.arange(T, device=dev)
    width = torch.where(ok, pos + 1, torch.zeros_like(pos)).amax(1) \
        if T else torch.zeros(N, dtype=torch.long, device=dev)
    floats = torch.zeros((N, 10), dtype=tri.dtype, device=dev)
    if T:
        floats[:, :8] = tri[:, 0, :8]
    floats[:, 8] = 1e30
    floats[:, 9] = -1.0
    ints = torch.full((N, T + 1), -1, dtype=torch.int32, device=dev)
    ints[:, T] = 0
    scores = torch.full((N, T), -1.0, dtype=tri.dtype, device=dev)
    for n, w in width_chunks(width, PAIR_BUDGET):
        f, it, sc = _score_chunk(cfg, K, T, l2d_packed, cam_packed,
                                 ng_row[n, :w], b[n, :w], slot[n, :w],
                                 tri[n, :w], ok[n, :w])
        floats[n], ints[n], scores[n, :w] = f, it, sc
    out = (floats.reshape(G, L, 10), ints.reshape(G, L, T + 1))
    return out + (scores,) if return_scores else out


def config_params(cfg) -> np.ndarray:
    """The kernel's float parameters, in the order of its Params: the 2D
    linker (score_th, th_angle, th_overlap, th_smartoverlap,
    th_smartangle, th_perp, th_innerseg, multiplier, the smart-angle
    denominator and span, the angle, perpendicular and inner-segment
    sigmas, flags use_angle, use_overlap, use_smartangle, use_perp,
    use_innerseg), the 3D shared-parent linker (score_th, angle and
    scale-invariant sigmas), fullscore_th.  Products and differences of
    config values are taken in float64, as the plain version's Python
    scalars are."""
    c2 = cfg.linker2d
    c3 = cfg.linker3d.to_shared_parent_scoring()
    m2, m3 = c2.multiplier, c3.multiplier
    return np.asarray([
        c2.score_th, c2.th_angle, c2.th_overlap, c2.th_smartoverlap,
        c2.th_smartangle, c2.th_perp, c2.th_innerseg, m2,
        c2.th_smartoverlap - c2.th_overlap, c2.th_angle - c2.th_smartangle,
        c2.th_angle * m2, c2.th_perp * m2, c2.th_innerseg * m2,
        float(c2.use_angle), float(c2.use_overlap),
        float(c2.use_smartangle), float(c2.use_perp),
        float(c2.use_innerseg),
        c3.score_th, c3.th_angle * m3, c3.th_scaleinv * m3,
        cfg.fullscore_th], np.float32)


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # l2d, cam, meta, words, tri, ok, params, G, L, K, T, max_valid_conns,
    # floats, ints, scores, stream
    lib.tri_score_launch.argtypes = [ptr] * 7 + [i64] * 5 + [ptr] * 4
    lib.tri_score_launch.restype = ctypes.c_int
    return lib


def score(cfg, L, K, l2d_packed, cam_packed, words, meta, tri, ok,
          return_scores=False):
    """floats [G, L, 10] and ints [G, L, T + 1] (and, with
    ``return_scores``, every proposal's score [G * L, T]);
    ``score.launches`` counts the kernel's launches."""
    G, T = meta.shape[0], words.shape[-1]
    I = cam_packed.shape[0]
    dev = meta.device
    for name, t, dtype, shape in (
            ("l2d_packed", l2d_packed, torch.float32, (I, L, 6)),
            ("cam_packed", cam_packed, torch.float32, (I, 12)),
            ("meta", meta, torch.int32, (G, K + 1)),
            ("words", words, torch.int32, (G, L, T)),
            ("tri", tri, torch.float32, (G * L, T, 9)),
            ("ok", ok, torch.bool, (G * L, T))):
        check_tensor(name, t, dtype, shape, dev)
    if K > 127:
        raise ValueError("at most 127 neighbour slots")
    if dev.type == "cpu":
        return score_plain(cfg, L, K, l2d_packed, cam_packed, words, meta,
                           tri, ok, return_scores)
    floats = torch.empty((G, L, 10), dtype=torch.float32, device=dev)
    ints = torch.empty((G, L, T + 1), dtype=torch.int32, device=dev)
    scores = torch.empty((G * L, T), dtype=torch.float32, device=dev)
    if G * L:
        params = config_params(cfg)
        args = [t.contiguous() for t in (l2d_packed, cam_packed, meta,
                                         words, tri, ok)]
        with torch.cuda.device(dev):
            err = build().tri_score_launch(
                *(t.data_ptr() for t in args),
                params.ctypes.data, G, L, K, T,
                min(int(cfg.max_valid_conns), 1 << 30), floats.data_ptr(),
                ints.data_ptr(), scores.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tri_score launch failed: CUDA error {err}")
        _COUNTER.launches += 1
    return (floats, ints, scores) if return_scores else (floats, ints)


score.launches = 0
# the count lives on score itself, also while a caller has wrapped the
# module's name
_COUNTER = score
