"""Kernel Y: L2D2's line-aligned 48 x 32 patches, cut from an image.

The reference warps the whole image once a line (``cv2.warpAffine``:
rotate the line vertical about the image centre), crops a box of
``new_h`` x ``new_w`` about the centre and resizes it to 48 x 32
(``cv2.resize``, INTER_LINEAR).  ``l2d2_patches(img, minv, boxes)``
computes only the texels that resize reads: for each line, each output
texel is the half-pixel bilinear of four texels of the warped plane, and
each of those is ``util/cv2_ops``'s warp rule (float32 source
coordinates under the inverse map ``minv`` [N, 6] f32, a bilinear with
corners outside the image read as 0).  ``boxes`` [N, 4] int32 holds the
crop's first row and column in the warped plane and its height and
width.  CUDA tensors launch ``csrc/l2d2_patches.cu``; CPU tensors take
:func:`l2d2_patches_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor, load_library
from limap_tpu_torch.util import cv2_ops

SOURCE = "l2d2_patches.cu"
PATCH_H, PATCH_W = 48, 32


def line_box(line: np.ndarray, hw):
    """(inverse map [6] f32, box (row, col, height, width)) of one line
    [2, 2] (x, y) in an image of ``hw``: the reference's affine (in
    float64) and its crop, rows [h//2 - new_h//2, h//2 + new_h//2) and
    columns likewise, taken in the warped plane whatever its sign (the
    reference's numpy slice counts a negative start from the end of the
    warped image instead, ROADMAP.md section 3)."""
    h, w = hw
    line = np.asarray(line, np.float64)
    if line[1, 1] < line[0, 1]:
        line = line[[1, 0]]
    angle = np.arctan2(line[1, 0] - line[0, 0], line[1, 1] - line[0, 1])
    mid = line.mean(axis=0)
    T1 = np.array([[1.0, 0, -mid[0]], [0, 1, -mid[1]], [0, 0, 1]])
    TR = np.array([[np.cos(angle), -np.sin(angle), 0],
                   [np.sin(angle), np.cos(angle), 0], [0, 0, 1]])
    T2 = np.array([[1.0, 0, w // 2], [0, 1, h // 2], [0, 0, 1]])
    A = T2 @ TR @ T1
    minv = cv2_ops.invert_affine(A[:2]).reshape(-1).astype(np.float32)
    length = np.linalg.norm(line[0] - line[1])
    new_h = max(int(np.round(length)), 5)
    new_w = new_h * 32 // 48
    r0, c0 = h // 2 - new_h // 2, w // 2 - new_w // 2
    return minv, (r0, c0, 2 * (new_h // 2), 2 * (new_w // 2))


def line_boxes(lines: np.ndarray, hw):
    """(minv [N, 6] f32, boxes [N, 4] int32) of lines [N, 2, 2]."""
    out = [line_box(ln, hw) for ln in np.asarray(lines).reshape(-1, 2, 2)]
    minv = np.stack([m for m, _ in out]) if out else np.zeros((0, 6))
    boxes = np.array([b for _, b in out], np.int32).reshape(-1, 4)
    return minv.astype(np.float32), boxes


def _taps(n_in: torch.Tensor, n_out: int):
    """cv2_ops' INTER_LINEAR taps for each line's own input size n_in [N]:
    (first [N, n_out], second, float32 fraction)."""
    scale = 1.0 / (n_out / n_in.to(torch.float64))
    i = torch.arange(n_out, dtype=torch.float64, device=n_in.device)
    f = (i[None] + 0.5) * scale[:, None] - 0.5
    s = torch.floor(f)
    frac = f - s
    s = s.to(torch.int64)
    last = (n_in - 1)[:, None].to(torch.int64)
    low = s < 0
    frac = torch.where(low, torch.zeros_like(frac), frac)
    s = torch.where(low, torch.zeros_like(s), s)
    high = s >= last
    frac = torch.where(high, torch.zeros_like(frac), frac)
    s = torch.where(high, last.expand_as(s), s)
    return s, torch.minimum(s + 1, last), frac.to(torch.float32)


def _source_coords(minv: torch.Tensor, boxes: torch.Tensor):
    """The image coordinates (sx, sy) [N, 96, 64] f32 of the warped texels
    at the taps' rows (first taps, then second) and columns, and the
    taps' fractions fy [N, 48], fx [N, 32]."""
    N = minv.shape[0]
    b = boxes.to(torch.int64)
    y0, y1, fy = _taps(b[:, 2], PATCH_H)
    x0, x1, fx = _taps(b[:, 3], PATCH_W)
    rows = torch.cat([y0, y1], 1) + b[:, 0:1]            # [N, 96]
    cols = torch.cat([x0, x1], 1) + b[:, 1:2]            # [N, 64]
    Y = rows.to(torch.float32)[:, :, None].expand(N, 2 * PATCH_H,
                                                  2 * PATCH_W)
    X = cols.to(torch.float32)[:, None, :].expand(N, 2 * PATCH_H,
                                                  2 * PATCH_W)
    m = [minv[:, k, None, None] for k in range(6)]
    sx = m[0] * X + (m[1] * Y + m[2])
    sy = m[3] * X + (m[4] * Y + m[5])
    return sx, sy, fy, fx


def l2d2_patches_plain(img: torch.Tensor, minv: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """[N, 48, 32] patches in torch ops: the warped texels at the taps'
    rows and columns, then cv2_ops.resize's float32 lerps."""
    sx, sy, fy, fx = _source_coords(minv, boxes)
    warped = cv2_ops.bilinear_zero(img, sx, sy)         # [N, 96, 64]
    top, bot = warped[:, :PATCH_H], warped[:, PATCH_H:]
    ax1 = fx[:, None, :]

    def horiz(t):
        return t[:, :, :PATCH_W] * (1.0 - ax1) + t[:, :, PATCH_W:] * ax1

    ay1 = fy[:, :, None]
    return horiz(top) * (1.0 - ay1) + horiz(bot) * ay1


def image_texels(hw, minv: torch.Tensor, boxes: torch.Tensor
                 ) -> torch.Tensor:
    """Flat indices (y * W + x) of the distinct image texels a call
    reads: the four corners of each warped texel's bilinear that lie
    inside the image (those outside read as 0)."""
    H, W = hw
    sx, sy, _, _ = _source_coords(minv, boxes)
    x0 = torch.floor(sx).to(torch.int64).reshape(-1)
    y0 = torch.floor(sy).to(torch.int64).reshape(-1)
    ys = torch.cat([y0, y0, y0 + 1, y0 + 1])
    xs = torch.cat([x0, x0 + 1, x0, x0 + 1])
    ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    return torch.unique(ys[ok] * W + xs[ok])


def work(hw, minv: torch.Tensor, boxes: torch.Tensor):
    """(operations, bytes) of one call on these inputs: each output
    texel's four warped texels (two coordinates, 7 operations each, and a
    three-lerp bilinear, 9) and its own three lerps (9); each distinct
    image texel read once (:func:`image_texels`), the maps and boxes
    read, the patches written."""
    n_lines = minv.shape[0]
    texels = n_lines * PATCH_H * PATCH_W
    ops = texels * (4 * (14 + 9) + 9)
    read = image_texels(hw, minv, boxes).numel()
    return ops, read * 4 + n_lines * (24 + 16) + texels * 4


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.l2d2_patches_launch.argtypes = [ptr, i32, i32, ptr, ptr, i32, ptr,
                                        ptr]
    lib.l2d2_patches_launch.restype = ctypes.c_int
    return lib


def l2d2_patches(img: torch.Tensor, minv: torch.Tensor,
                 boxes: torch.Tensor) -> torch.Tensor:
    """[N, 48, 32] f32 patches of ``img`` [H, W] f32 for the inverse maps
    ``minv`` [N, 6] f32 and crops ``boxes`` [N, 4] int32 (line_box gives
    a height of >= 4 and a width of >= 2; any box reads only texels of
    the image, those outside it as 0).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (``l2d2_patches.launches``
    counts its launches)."""
    if img.dim() != 2:
        raise ValueError(f"img must be [H, W], got {tuple(img.shape)}")
    H, W = img.shape
    N = minv.shape[0]
    dev = img.device
    check_tensor("img", img, torch.float32, (H, W), dev)
    check_tensor("minv", minv, torch.float32, (N, 6), dev)
    check_tensor("boxes", boxes, torch.int32, (N, 4), dev)
    if dev.type == "cpu":
        return l2d2_patches_plain(img, minv, boxes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(N, PATCH_H, PATCH_W, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    img, minv, boxes = img.contiguous(), minv.contiguous(), boxes.contiguous()
    lib = build()
    with torch.cuda.device(dev):
        err = lib.l2d2_patches_launch(
            img.data_ptr(), H, W, minv.data_ptr(), boxes.data_ptr(), N,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"l2d2_patches launch failed: CUDA error {err}")
    _Y.launches += 1
    return out


l2d2_patches.launches = 0
# the count is kept on the function through this alias, so a wrapper set
# in the function's place (chip_smoke's recorders) does not hide it
_Y = l2d2_patches
