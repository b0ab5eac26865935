"""Kernel R: the log-domain Sinkhorn solver with dustbins.

``log_sinkhorn(scores, bin_score, iters)`` takes scores [M, N] f32 and
returns the log assignment Z [M+1, N+1] f32: the coupling (the scores
with a dustbin row and column of ``bin_score``) plus the potentials u and
v after ``iters`` alternating row and column updates, minus the norm
-log(M + N).  CUDA tensors launch ``csrc/log_sinkhorn.cu`` (the whole
solve in one cooperative launch); CPU tensors take
:func:`log_sinkhorn_plain`.  The marginal constants are computed here in
float32, as the reference does, and handed to both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "log_sinkhorn.cu"
# fp32 operations an element and pass (add, max, subtract, exp, add)
OPS_ELEMENT_PASS = 5


def constants(M: int, N: int):
    """(norm, log_mu of the row dustbin, log_nu of the column dustbin),
    each float32 as the reference's weakly typed scalars."""
    ms = torch.tensor(float(M), dtype=torch.float32)
    ns = torch.tensor(float(N), dtype=torch.float32)
    norm = -torch.log(ms + ns)
    return norm, torch.log(ns) + norm, torch.log(ms) + norm


def log_sinkhorn_plain(scores: torch.Tensor, bin_score: float,
                       iters: int) -> torch.Tensor:
    """The reference's loop in torch ops."""
    M, N = scores.shape
    dev = scores.device
    norm, mu_bin, nu_bin = (c.to(dev) for c in constants(M, N))
    b = torch.tensor(float(bin_score), dtype=torch.float32, device=dev)
    couplings = torch.cat([
        torch.cat([scores, b.expand(M, 1)], 1),
        torch.cat([b.expand(1, N), b.expand(1, 1)], 1)], 0)
    log_mu = torch.cat([norm.expand(M), mu_bin[None]])
    log_nu = torch.cat([norm.expand(N), nu_bin[None]])
    u = torch.zeros(M + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], dim=0)
    return couplings + u[:, None] + v[None, :] - norm


def work(M: int, N: int, iters: int):
    """(fp32 operations, bytes) of one solve: every element twice an
    iteration, the scores read and Z written once (the transposed copy
    is the kernel's scratch, not the function's traffic)."""
    cells = (M + 1) * (N + 1)
    return (2 * iters * cells * OPS_ELEMENT_PASS,
            4 * (M * N + cells))


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.log_sinkhorn_launch.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr,
                                        ptr, ptr, ptr]
    lib.log_sinkhorn_launch.restype = ctypes.c_int
    return lib


def log_sinkhorn(scores: torch.Tensor, bin_score: float,
                 iters: int = 50) -> torch.Tensor:
    """Z [M+1, N+1] of scores [M, N] f32 (M + N > 0).  CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``log_sinkhorn.launches`` counts its launches)."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"scores must be [M, N] float32, got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    M, N = scores.shape
    if M + N == 0:
        raise ValueError("log_sinkhorn needs M + N > 0")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    bin_score = float(bin_score)
    if scores.device.type == "cpu":
        return log_sinkhorn_plain(scores, bin_score, iters)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    scores = scores.contiguous()
    dev = scores.device
    Z = torch.empty(M + 1, N + 1, dtype=torch.float32, device=dev)
    Zt = torch.empty(N + 1, M + 1, dtype=torch.float32, device=dev)
    u = torch.empty(M + 1, dtype=torch.float32, device=dev)
    v = torch.empty(N + 1, dtype=torch.float32, device=dev)
    f = np.array([bin_score, *(float(c) for c in constants(M, N))],
                 np.float32)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.log_sinkhorn_launch(
            scores.data_ptr(), M, N, int(iters),
            f.ctypes.data_as(ctypes.c_void_p), Z.data_ptr(), Zt.data_ptr(),
            u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"log_sinkhorn launch failed: CUDA error {err}")
    log_sinkhorn.launches += 1
    return Z


log_sinkhorn.launches = 0
