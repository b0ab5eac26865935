"""Kernel W: each row's and each column's best correlation, without the
correlation matrix.

``ncc_argmax_both(f1, f2)`` takes f1 [N1, D] and f2 [N2, D] f32 (unit
rows) and returns (idx12 [N1] int64, s12 [N1] f32, idx21 [N2] int64,
s21 [N2] f32): argmax and max over j of f1[i] . f2[j], and over i for
each j, the first index among equal maxima.  CUDA tensors launch
``csrc/ncc_argmax.cu`` (one pass over f1 @ f2.T for both directions,
fp32 multiply-adds on the CUDA cores, never TF32, which would move the
argmax); CPU tensors take :func:`ncc_argmax_both_plain`, one
``f1 @ f2.T`` and both of its max reductions.

The kernel publishes a best score and its index as one 64-bit key;
:func:`pack_keys` and :func:`unpack_keys` are that key's map in torch,
shifted into int64 so that signed order is the kernel's unsigned order.
:func:`ncc_argmax_rowscan` is the first kernel, one direction a launch,
kept as the yardstick of the time.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import check_tensor, load_library

SOURCE = "ncc_argmax.cu"
MAX_DIM = 64


def ncc_argmax_both_plain(f1: torch.Tensor, f2: torch.Tensor):
    """(idx12, s12, idx21, s21): the max of c = f1 @ f2.T over each row
    and over each column, with their first indices."""
    c = f1 @ f2.T
    s12, idx12 = c.max(1)
    s21, idx21 = c.max(0)
    return idx12, s12, idx21, s21


def pack_keys(score: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The kernel's key of (score f32, index) as int64: the score mapped
    to an order-preserving 32-bit word (-0.0 as +0.0) above
    0xFFFFFFFF - index; the kernel's key less 2**63, so the larger int64
    is the larger score and, among equal scores, the smaller index."""
    s = torch.where(score == 0, torch.zeros_like(score), score)
    bits = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    ordered = torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return (ordered - 0x80000000) * (1 << 32) + (0xFFFFFFFF - index)


def unpack_keys(keys: torch.Tensor):
    """(index int64, score f32) of :func:`pack_keys`' keys."""
    index = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    ordered = (keys >> 32) + 0x80000000
    bits = torch.where(ordered >= 0x80000000, ordered & 0x7FFFFFFF,
                       ordered ^ 0xFFFFFFFF)
    score = (bits - ((bits >= 0x80000000).to(torch.int64) << 32)) \
        .to(torch.int32).view(torch.float32)
    return index, score


def work(N1: int, N2: int, D: int):
    """(operations, bytes) of both directions: a multiply-add (two
    operations) a term of every dot, computed once; both inputs read
    once, an index and a score written a row and a column."""
    return 2 * N1 * N2 * D, 4 * D * (N1 + N2) + 12 * (N1 + N2)


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ncc_argmax_both_launch.argtypes = [ptr, i32, ptr, i32, i32, ptr,
                                           ptr, ptr, ptr, ptr, ptr]
    lib.ncc_argmax_both_launch.restype = ctypes.c_int
    lib.ncc_argmax_rowscan_launch.argtypes = [ptr, i32, ptr, i32, i32, ptr,
                                              ptr, ptr]
    lib.ncc_argmax_rowscan_launch.restype = ctypes.c_int
    return lib


def _check(f1: torch.Tensor, f2: torch.Tensor):
    if f1.dim() != 2 or f2.dim() != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError(f"f1 [N1, D] and f2 [N2, D] expected, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    N1, D = f1.shape
    N2 = f2.shape[0]
    dev = f1.device
    check_tensor("f1", f1, torch.float32, (N1, D), dev)
    check_tensor("f2", f2, torch.float32, (N2, D), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and D > MAX_DIM:
        raise ValueError(f"at most {MAX_DIM} channels, got {D}")
    return N1, N2, D, dev


def ncc_argmax_both(f1: torch.Tensor, f2: torch.Tensor):
    """(idx12 [N1] int64, s12 [N1] f32, idx21 [N2] int64, s21 [N2] f32):
    the row and column argmax and max of f1 @ f2.T (N1, N2 >= 1, D <= 64
    on the card).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (``ncc_argmax_both.launches`` counts its
    launches)."""
    N1, N2, D, dev = _check(f1, f2)
    if N1 == 0 or N2 == 0:
        raise ValueError("ncc_argmax_both needs N1, N2 >= 1")
    if dev.type == "cpu":
        return ncc_argmax_both_plain(f1, f2)
    f1, f2 = f1.contiguous(), f2.contiguous()
    keys = torch.empty(N1 + N2, dtype=torch.int64, device=dev)
    idx12 = torch.empty(N1, dtype=torch.int64, device=dev)
    s12 = torch.empty(N1, dtype=torch.float32, device=dev)
    idx21 = torch.empty(N2, dtype=torch.int64, device=dev)
    s21 = torch.empty(N2, dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.ncc_argmax_both_launch(
            f1.data_ptr(), N1, f2.data_ptr(), N2, D, keys.data_ptr(),
            idx12.data_ptr(), s12.data_ptr(), idx21.data_ptr(),
            s21.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ncc_argmax_both launch failed: CUDA error {err}")
    _W.launches += 1
    return idx12, s12, idx21, s21


ncc_argmax_both.launches = 0
# the count is kept on the function through this alias, so a wrapper set
# in the function's place (chip_smoke's recorders) does not hide it
_W = ncc_argmax_both


def ncc_argmax_rowscan(f1: torch.Tensor, f2: torch.Tensor):
    """(argmax [N1] int64, max [N1] f32) of f1 @ f2.T by rows, by the
    first kernel (a block 32 rows of f1, one dot a thread at a time): the
    yardstick of :func:`ncc_argmax_both`'s time.  CUDA tensors only;
    ``ncc_argmax_rowscan.launches`` counts its launches."""
    N1, N2, D, dev = _check(f1, f2)
    if dev.type != "cuda":
        raise ValueError("ncc_argmax_rowscan runs on CUDA tensors only")
    if N1 == 0 or N2 == 0:
        raise ValueError("ncc_argmax_rowscan needs N1, N2 >= 1")
    f1, f2 = f1.contiguous(), f2.contiguous()
    idx = torch.empty(N1, dtype=torch.int64, device=dev)
    score = torch.empty(N1, dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.ncc_argmax_rowscan_launch(
            f1.data_ptr(), N1, f2.data_ptr(), N2, D, idx.data_ptr(),
            score.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ncc_argmax_rowscan launch failed: CUDA error "
                           f"{err}")
    ncc_argmax_rowscan.launches += 1
    return idx, score


ncc_argmax_rowscan.launches = 0
