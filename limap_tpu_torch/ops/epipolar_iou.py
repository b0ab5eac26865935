"""All-pairs epipolar IoU of a reference image's 2D segments against a
target image's: ``epipolar_iou_grid`` [Nr, Nt], the IoU of every target
segment with the band between the epipolar lines of a reference
segment's two endpoints.  The caller gives those lines per row
(normalized, in the target image; :func:`row_epipolar_lines`).

CUDA tensors launch ``csrc/epipolar_iou.cu``; CPU tensors take
:func:`epipolar_iou_grid_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import EPS, Segments
from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.triangulation.functions import _norm, epipolar_line

SOURCE = "epipolar_iou.cu"


def row_epipolar_lines(ref: torch.Tensor, ref_view: CameraViewsBatch,
                       tgt_view: CameraViewsBatch):
    """Normalized epipolar lines [Nr, 3] of the reference segments'
    starts and ends in the target image; the views hold one camera
    each ([4], [4], [3])."""
    def line(p):
        return _norm(epipolar_line(ref_view, tgt_view, p))
    return line(ref[:, :2]).contiguous(), line(ref[:, 2:4]).contiguous()


def epipolar_iou_grid_plain(tgt: torch.Tensor, ep_s: torch.Tensor,
                            ep_e: torch.Tensor) -> torch.Tensor:
    """IoU [Nr, Nt] in plain torch, as compute_epipolar_iou computes it
    per pair."""
    l2 = Segments(tgt[None, :, :2], tgt[None, :, 2:4])
    coor_l2 = l2.coords()

    def intersect_at(epline):
        c_homo = cross(coor_l2, epline[:, None])
        return c_homo[..., :2] / (c_homo[..., 2:3] + EPS)

    dir2 = l2.direction()
    len2 = l2.length()
    c1 = torch.sum((intersect_at(ep_s) - l2.start) * dir2, -1) / (len2 + EPS)
    c2 = torch.sum((intersect_at(ep_e) - l2.start) * dir2, -1) / (len2 + EPS)
    lo = torch.minimum(c1, c2)
    hi = torch.maximum(c1, c2)
    return (torch.clamp(hi, max=1.0) - torch.clamp(lo, min=0.0)) / (
        torch.clamp(hi, min=1.0) - torch.clamp(lo, max=0.0) + EPS)


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.epipolar_iou_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr, ptr]
    lib.epipolar_iou_launch.restype = ctypes.c_int
    return lib


def epipolar_iou_grid(tgt: torch.Tensor, ep_s: torch.Tensor,
                      ep_e: torch.Tensor) -> torch.Tensor:
    """tgt [Nt, 4] segments, ep_s / ep_e [Nr, 3] -> IoU [Nr, Nt]
    (``epipolar_iou_grid.launches`` counts the kernel's launches)."""
    Nr, Nt = ep_s.shape[0], tgt.shape[0]
    for name, t, shape in (("tgt", tgt, (Nt, 4)), ("ep_s", ep_s, (Nr, 3)),
                           ("ep_e", ep_e, (Nr, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != tgt.device:
            raise ValueError(f"{name}: fp32 {shape} on {tgt.device} "
                             f"expected, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if tgt.device.type == "cpu":
        return epipolar_iou_grid_plain(tgt, ep_s, ep_e)
    if Nr > 65535:
        raise ValueError(f"the kernel takes at most 65535 rows, got {Nr}")
    iou = torch.empty((Nr, Nt), dtype=torch.float32, device=tgt.device)
    if Nr == 0 or Nt == 0:
        return iou
    tgt, ep_s, ep_e = tgt.contiguous(), ep_s.contiguous(), ep_e.contiguous()
    with torch.cuda.device(tgt.device):
        err = build().epipolar_iou_launch(
            tgt.data_ptr(), ep_s.data_ptr(), ep_e.data_ptr(), Nr, Nt,
            iou.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"epipolar_iou launch failed: CUDA error {err}")
    epipolar_iou_grid.launches += 1
    return iou


epipolar_iou_grid.launches = 0
