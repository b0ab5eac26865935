"""Kernel X: TP-LSD's decoding of its centre and displacement maps.

``tplsd_decode(center, disp, max_segs, score_thresh, nms_radius)`` takes
the centre map [H, W] f32 and the displacements [H, W, 4] f32 and
returns (segs [max_segs, 5] f32, count): the top ``max_segs`` pixels of
the score map (the centre where it equals the maximum of its
(2r+1)^2 window, padded with -inf, and exceeds the threshold; 0
elsewhere), ordered by score with the lower index first among equal
scores, as ``lax.top_k`` orders them; each row (x + dx1, y + dy1, x +
dx2, y + dy2, score).  CUDA tensors launch ``csrc/tplsd_decode.cu``;
CPU tensors take :func:`tplsd_decode_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from limap_tpu_torch.ops.cuda_build import check_tensor, load_library

SOURCE = "tplsd_decode.cu"
THREADS = 256


def peak_scores(center: torch.Tensor, score_thresh: float,
                nms_radius: int) -> torch.Tensor:
    """The score map [H * W]: the centre at a peak, 0 elsewhere."""
    k = 2 * nms_radius + 1
    pooled = F.max_pool2d(center[None, None], k, 1, nms_radius)[0, 0]
    peak = (center == pooled) & (center > score_thresh)
    return torch.where(peak, center, torch.zeros_like(center)).reshape(-1)


def tplsd_decode_plain(center: torch.Tensor, disp: torch.Tensor,
                       max_segs: int, score_thresh: float = 0.25,
                       nms_radius: int = 4):
    """The reference's decoding in torch ops; a stable descending sort
    keeps lax.top_k's order among equal scores."""
    H, W = center.shape
    score = peak_scores(center, score_thresh, nms_radius)
    order = torch.sort(score, descending=True, stable=True).indices[
        :max_segs]
    top_s = score[order]
    ys = torch.div(order, W, rounding_mode="floor").to(torch.float32)
    xs = (order % W).to(torch.float32)
    d = disp.reshape(-1, 4)[order]
    segs = torch.stack([xs + d[:, 0], ys + d[:, 1], xs + d[:, 2],
                        ys + d[:, 3], top_s], dim=1)
    return segs, (top_s > 0).sum()


def work(H: int, W: int, max_segs: int, nms_radius: int, n_peaks: int):
    """(operations, bytes) of the function on these inputs, not of the
    kernel's algorithm: the window maximum taken separably (2r compares
    along a row, 2r along a column) and the peak test (2 compares) a
    pixel, a top-K selection of the peaks (one compare a peak) and the
    K rows put in order (K log2 K compares); the centre read once, the
    rows' displacements read and the rows and the count written."""
    N = H * W
    k = min(max_segs, N)
    ops = (N * (4 * nms_radius + 2) + n_peaks
           + k * max((k - 1).bit_length(), 1))
    return ops, N * 4 + k * 16 + k * 20 + 4


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tplsd_decode_launch.argtypes = [ptr, ptr, i32, i32, i32,
                                        ctypes.c_float, i32, ptr, ptr, ptr,
                                        ptr, ptr, ptr, ptr, ptr]
    lib.tplsd_decode_launch.restype = ctypes.c_int
    return lib


def tplsd_decode(center: torch.Tensor, disp: torch.Tensor, max_segs: int,
                 score_thresh: float = 0.25, nms_radius: int = 4):
    """(segs [max_segs, 5], count) of the centre map [H, W] f32 and the
    displacements [H, W, 4] f32 (max_segs <= H * W).  CPU tensors take the
    plain version; CUDA tensors launch the kernel
    (``tplsd_decode.launches`` counts its launches)."""
    if center.dim() != 2:
        raise ValueError(f"center must be [H, W], got {tuple(center.shape)}")
    H, W = center.shape
    dev = center.device
    check_tensor("center", center, torch.float32, (H, W), dev)
    check_tensor("disp", disp, torch.float32, (H, W, 4), dev)
    if not 0 < max_segs <= H * W:
        raise ValueError(f"max_segs must be in [1, {H * W}], got {max_segs}")
    if dev.type == "cpu":
        return tplsd_decode_plain(center, disp, max_segs, score_thresh,
                                  nms_radius)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    center, disp = center.contiguous(), disp.contiguous()
    N = H * W
    B = (N + THREADS - 1) // THREADS
    i32 = dict(dtype=torch.int32, device=dev)
    flag = torch.empty(N, dtype=torch.uint8, device=dev)
    block_count = torch.empty(B, **i32)
    offset = torch.empty(B + 1, **i32)
    peak_idx = torch.empty(N, **i32)
    rest_idx = torch.empty(max_segs, **i32)
    segs = torch.empty(max_segs, 5, dtype=torch.float32, device=dev)
    count = torch.empty((), **i32)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.tplsd_decode_launch(
            center.data_ptr(), disp.data_ptr(), H, W, int(max_segs),
            float(score_thresh), int(nms_radius), flag.data_ptr(),
            block_count.data_ptr(), offset.data_ptr(), peak_idx.data_ptr(),
            rest_idx.data_ptr(), segs.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tplsd_decode launch failed: CUDA error {err}")
    _X.launches += 1
    return segs, count.to(torch.int64)


tplsd_decode.launches = 0
# the count is kept on the function through this alias, so a wrapper set
# in the function's place (chip_smoke's recorders) does not hide it
_X = tplsd_decode
