"""Kernel W: each row's best correlation, without the correlation matrix.

``ncc_argmax(f1, f2)`` takes f1 [N1, D] and f2 [N2, D] f32 (unit rows)
and returns (index [N1] int64, score [N1] f32): argmax and max over j of
f1[i] . f2[j], the first index among equal maxima.  CUDA tensors launch
``csrc/ncc_argmax.cu`` (fp32 multiply-adds on the CUDA cores, never
TF32, which would move the argmax); CPU tensors take
:func:`ncc_argmax_plain`, the reference's ``f1 @ f2.T`` and its row max.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import check_tensor, load_library

SOURCE = "ncc_argmax.cu"
MAX_DIM = 64


def ncc_argmax_plain(f1: torch.Tensor, f2: torch.Tensor):
    score, idx = torch.max(f1 @ f2.T, dim=1)
    return idx, score


def work(N1: int, N2: int, D: int):
    """(operations, bytes): a multiply-add (two operations) a term of
    every dot; both inputs read once, index and score written."""
    return 2 * N1 * N2 * D, 4 * D * (N1 + N2) + 12 * N1


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ncc_argmax_launch.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr,
                                      ptr]
    lib.ncc_argmax_launch.restype = ctypes.c_int
    return lib


def ncc_argmax(f1: torch.Tensor, f2: torch.Tensor):
    """(argmax [N1] int64, max [N1] f32) of f1 @ f2.T by rows (N2 >= 1,
    D <= 64 on the card).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``ncc_argmax.launches`` counts its
    launches)."""
    if f1.dim() != 2 or f2.dim() != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError(f"f1 [N1, D] and f2 [N2, D] expected, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    N1, D = f1.shape
    N2 = f2.shape[0]
    dev = f1.device
    check_tensor("f1", f1, torch.float32, (N1, D), dev)
    check_tensor("f2", f2, torch.float32, (N2, D), dev)
    if N2 == 0:
        raise ValueError("ncc_argmax needs N2 >= 1")
    if dev.type == "cpu":
        return ncc_argmax_plain(f1, f2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if D > MAX_DIM:
        raise ValueError(f"at most {MAX_DIM} channels, got {D}")
    idx = torch.empty(N1, dtype=torch.int64, device=dev)
    score = torch.empty(N1, dtype=torch.float32, device=dev)
    if N1 == 0:
        return idx, score
    f1, f2 = f1.contiguous(), f2.contiguous()
    lib = build()
    with torch.cuda.device(dev):
        err = lib.ncc_argmax_launch(f1.data_ptr(), N1, f2.data_ptr(), N2, D,
                                    idx.data_ptr(), score.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ncc_argmax launch failed: CUDA error {err}")
    _W.launches += 1
    return idx, score


ncc_argmax.launches = 0
# the count is kept on the function through this alias, so a wrapper set
# in the function's place (chip_smoke's recorders) does not hide it
_W = ncc_argmax
