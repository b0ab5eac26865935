"""The edge test of fit-and-merge: which pairs of per-image 3D segments
the joint 2D + 3D linker connects.

Per image i, the self pairs a < b of its L lines (``check_3d`` and
``check_2d`` of the 2D segments), and the cross pairs of its lines
against each neighbour j = nbrs[i, k] (``check_3d``; ``check_2d`` of
line a projected into j against j's 2D line b; ``check_2d`` of j's line
b projected into i against i's 2D line a), both masked by the line masks
and, for a neighbour slot, by ``nmask``.

:func:`linker_edges` returns bit masks: self [I, L, W] and cross
[I, K, L, W] int32 words, W = ceil(L / 32), bit q of word w of row a
holding the pair (a, 32 w + q).  CUDA tensors launch
``csrc/linker_edges.cu``; CPU tensors take :func:`linker_edges_plain`,
the same test in torch ops, chunked over images, that never holds more
than ``PAIR_BUDGET`` pairs at once.  :func:`edges_from_bits` turns the
masks into the node-pair list in ``np.argwhere`` order of the dense
masks (self pairs first, then cross pairs).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.base import line_geometry as lg
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_linker import (LineLinker2dConfig,
                                              LineLinker3dConfig, check_2d,
                                              check_3d)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.cuda_build import check_tensor

SOURCE = "linker_edges.cu"
PAIR_BUDGET = 1 << 22
_SHIFTS = torch.arange(32, dtype=torch.int64)


def n_words(L: int) -> int:
    return (L + 31) // 32


def pack_bits(ok: torch.Tensor) -> torch.Tensor:
    """bool [..., L] -> int32 words [..., W] (bit q of word w = entry
    32 w + q)."""
    L = ok.shape[-1]
    W = n_words(L)
    pad = torch.zeros(ok.shape[:-1] + (W * 32 - L,), dtype=torch.bool,
                      device=ok.device)
    bits = torch.cat([ok, pad], -1).reshape(ok.shape[:-1] + (W, 32))
    words = torch.sum(bits.long() << _SHIFTS.to(ok.device), dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(words: torch.Tensor, L: int) -> torch.Tensor:
    """int32 words [..., W] -> bool [..., L]."""
    bits = (words.long()[..., None] >> _SHIFTS.to(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :L].bool()


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words, without unpacking them."""
    x = words.long() & 0xffffffff
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0f0f0f0f
    return int((((x * 0x01010101) & 0xffffffff) >> 24).sum())


def set_bits(words: torch.Tensor) -> torch.Tensor:
    """Indices (..., bit position) of the set bits, in row-major order of
    the unpacked mask, without unpacking the zero words."""
    nz = torch.nonzero(words)                        # [E_w, ndim]
    w = words[tuple(nz.T)].long() & 0xffffffff
    hit = torch.nonzero((w[:, None] >> _SHIFTS.to(w.device)) & 1)
    idx = nz[hit[:, 0]]
    col = idx[:, -1] * 32 + hit[:, 1]
    return torch.cat([idx[:, :-1], col[:, None]], 1)


def edges_from_bits(self_bits: torch.Tensor, cross_bits: torch.Tensor,
                    nbrs: torch.Tensor, L: int) -> torch.Tensor:
    """Node pairs [E, 2] int64 (node = image row * L + line): the self
    edges (i, a, b) then the cross edges (i, k, a, b), each in row-major
    order, as ``np.argwhere`` of the dense masks lists them."""
    es = set_bits(self_bits)
    ec = set_bits(cross_bits)
    e_self = torch.stack([es[:, 0] * L + es[:, 1], es[:, 0] * L + es[:, 2]],
                         1)
    e_cross = torch.stack([ec[:, 0] * L + ec[:, 2],
                           nbrs.long()[ec[:, 0], ec[:, 1]] * L + ec[:, 3]], 1)
    return torch.cat([e_self, e_cross]).reshape(-1, 2)


def linker_edges_plain(l2d: Segments, l3d: Segments, mask: torch.Tensor,
                       views: CameraViewsBatch, nbrs: torch.Tensor,
                       nmask: torch.Tensor, cfg2d: LineLinker2dConfig,
                       cfg3d: LineLinker3dConfig):
    """The edge test in torch ops over chunks of images."""
    I, L = mask.shape
    K = nbrs.shape[1]
    c = max(1, PAIR_BUDGET // max(K * L * L, L * L, 1))
    nbrs = nbrs.long()
    parts_s, parts_c = [], []
    iu = torch.triu(torch.ones((L, L), dtype=torch.bool, device=mask.device),
                    diagonal=1)
    for i0 in range(0, I, c):
        sl = slice(i0, min(i0 + c, I))
        a2 = Segments(l2d.start[sl], l2d.end[sl])
        a3 = Segments(l3d.start[sl], l3d.end[sl],
                      uncertainty=None if l3d.uncertainty is None
                      else l3d.uncertainty[sl])
        m = mask[sl]
        ok = check_3d(a3.expand(2), a3.expand(1), cfg3d)
        ok &= check_2d(a2.expand(2), a2.expand(1), cfg2d)
        ok &= m[:, :, None] & m[:, None, :] & iu[None]
        parts_s.append(pack_bits(ok))

        nb = nbrs[sl]
        ng3 = Segments(*(None if x is None else x[nb] for x in l3d))
        ng2 = Segments(l2d.start[nb], l2d.end[nb])
        ng_mask = mask[nb] & nmask[sl][:, :, None]
        ngv = views.select(nb)
        row3 = a3.expand(1).expand(3)                       # [c, 1, L, 1]
        col3 = ng3.expand(2)                                # [c, K, 1, L]
        ok = check_3d(row3, col3, cfg3d)
        ngv_b = CameraViewsBatch(*(x[:, :, None, None] for x in ngv))
        ok &= check_2d(lg.project_segments(row3, ngv_b), ng2.expand(2),
                       cfg2d)
        own = views.select(torch.arange(sl.start, sl.stop,
                                        device=mask.device))
        own_b = CameraViewsBatch(*(x[:, None, None, None] for x in own))
        ok &= check_2d(lg.project_segments(col3, own_b),
                       a2.expand(1).expand(3), cfg2d)
        ok &= m[:, None, :, None] & ng_mask[:, :, None, :]
        parts_c.append(pack_bits(ok))
    W = n_words(L)
    if not parts_s:
        return (torch.zeros((0, L, W), dtype=torch.int32, device=mask.device),
                torch.zeros((0, K, L, W), dtype=torch.int32,
                            device=mask.device))
    return torch.cat(parts_s), torch.cat(parts_c)


# the per-linker parameters the kernel takes, in the order of its Cfg
# struct (csrc/linker_edges.cu); flags as 0.0 / 1.0
def config_params(cfg, dim3: bool) -> list:
    if dim3 and cfg.use_scaleinv:
        raise ValueError("the kernel has no scale-invariant 3D test (it "
                         "needs depths); to_spatial_merging turns it off")
    mult = cfg.multiplier
    return [cfg.score_th, cfg.th_angle, cfg.th_overlap, cfg.th_smartoverlap,
            cfg.th_smartangle, cfg.th_perp, cfg.th_innerseg, mult,
            cfg.th_smartoverlap - cfg.th_overlap,
            cfg.th_angle - cfg.th_smartangle, cfg.th_perp * mult,
            cfg.th_innerseg * mult, float(cfg.use_angle),
            float(cfg.use_overlap), float(cfg.use_smartangle),
            float(cfg.use_perp), float(cfg.use_innerseg)]



def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.linker_edges_launch.argtypes = [ptr] * 10 + [i64] * 3 + [ptr] * 3
    lib.linker_edges_launch.restype = ctypes.c_int
    return lib


def linker_edges(l2d: Segments, l3d: Segments, mask: torch.Tensor,
                 views: CameraViewsBatch, nbrs: torch.Tensor,
                 nmask: torch.Tensor, cfg2d: LineLinker2dConfig,
                 cfg3d: LineLinker3dConfig):
    """Self [I, L, W] and cross [I, K, L, W] int32 bit masks of the
    pairs the linker connects (``linker_edges.launches`` counts the
    kernel's launches).  ``l3d.uncertainty`` [I, L], where given, scales
    the 3D perpendicular and inner-segment thresholds by the pair's
    minimum."""
    I, L = mask.shape
    K = nbrs.shape[1]
    device = mask.device
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("l2d.start", l2d.start, f32, (I, L, 2)),
            ("l2d.end", l2d.end, f32, (I, L, 2)),
            ("l3d.start", l3d.start, f32, (I, L, 3)),
            ("l3d.end", l3d.end, f32, (I, L, 3)),
            ("mask", mask, torch.bool, (I, L)),
            ("views.kvec", views.kvec, f32, (I, 4)),
            ("views.qvec", views.qvec, f32, (I, 4)),
            ("views.tvec", views.tvec, f32, (I, 3)),
            ("nbrs", nbrs, torch.int32, (I, K)),
            ("nmask", nmask, torch.bool, (I, K))):
        check_tensor(name, t, dtype, shape, device)
    if l3d.uncertainty is not None:
        check_tensor("l3d.uncertainty", l3d.uncertainty, f32, (I, L), device)
    if device.type == "cpu":
        return linker_edges_plain(l2d, l3d, mask, views, nbrs, nmask, cfg2d,
                                  cfg3d)
    W = n_words(L)
    self_bits = torch.zeros((I, L, W), dtype=torch.int32, device=device)
    cross_bits = torch.zeros((I, K, L, W), dtype=torch.int32, device=device)
    if I == 0 or L == 0:
        return self_bits, cross_bits
    if I > 65535 or K + 1 > 65535:
        raise ValueError(f"the kernel takes at most 65535 images and "
                         f"neighbour slots, got I={I}, K={K}")
    params = np.asarray(config_params(cfg2d, False)
                        + config_params(cfg3d, True), np.float32)
    seg2 = torch.cat([l2d.start, l2d.end], -1).contiguous()
    seg3 = torch.cat([l3d.start, l3d.end], -1).contiguous()
    unc = l3d.uncertainty.contiguous() if l3d.uncertainty is not None \
        else None
    args = [seg2, seg3, unc, mask.contiguous(), views.kvec.contiguous(),
            views.qvec.contiguous(), views.tvec.contiguous(),
            nbrs.contiguous(), nmask.contiguous()]
    with torch.cuda.device(device):
        err = build().linker_edges_launch(
            *(None if t is None else t.data_ptr() for t in args),
            params.ctypes.data, I, L, K, self_bits.data_ptr(),
            cross_bits.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"linker_edges launch failed: CUDA error {err}")
    linker_edges.launches += 1
    return self_bits, cross_bits


linker_edges.launches = 0


def n_valid_pairs(mask: torch.Tensor, nbrs: torch.Tensor,
                  nmask: torch.Tensor) -> int:
    """Pairs whose two lines are both valid: the self pairs a < b and the
    cross pairs of the live neighbour slots (the pairs the test has to
    evaluate)."""
    cnt = mask.sum(1).long()
    self_pairs = (cnt * (cnt - 1) // 2).sum()
    cross = (cnt[:, None] * cnt[nbrs.long()] * nmask.long()).sum()
    return int(self_pairs + cross)

