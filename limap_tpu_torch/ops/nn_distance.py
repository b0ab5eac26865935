"""Nearest-neighbour distance of query points to a point cloud.

:func:`nn_min_dist` launches the CUDA kernel ``csrc/nn_min_dist.cu`` for
tensors on a GPU and runs :func:`nn_min_dist_plain`, the same function in
plain torch, for tensors on the CPU.  There is no fallback between the
two: a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "nn_min_dist.cu"


def nn_min_dist_plain(queries: torch.Tensor, points: torch.Tensor,
                      chunk_elems: int = 1 << 24) -> torch.Tensor:
    """min_j ||q_i - p_j|| in the difference form, in query chunks of at
    most ``chunk_elems`` (query, point) pairs."""
    S, M = queries.shape[0], points.shape[0]
    if M == 0:
        return torch.full((S,), float("inf"), dtype=queries.dtype,
                          device=queries.device)
    step = max(1, chunk_elems // M)
    out = [((queries[i:i + step, None] - points[None]) ** 2).sum(-1).amin(1)
           for i in range(0, S, step)]
    best = torch.cat(out) if out else queries.new_zeros((0,))
    return torch.sqrt(torch.clamp(best, min=0.0))


def build() -> ctypes.CDLL:
    """Build (or find) and load the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.nn_min_dist_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def nn_min_dist(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Distance [S] of each query [S, 3] to its nearest point [M, 3].

    fp32, contiguous, both on one device.  CPU tensors take the plain
    version; CUDA tensors take the kernel (``nn_min_dist.launches``
    counts its launches).
    """
    for name, t in (("queries", queries), ("points", points)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be [*, 3], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.device != points.device:
        raise ValueError(f"queries on {queries.device}, points on "
                         f"{points.device}")
    if queries.device.type == "cpu":
        return nn_min_dist_plain(queries, points)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    out = torch.empty(queries.shape[0], dtype=torch.float32,
                      device=queries.device)
    if queries.shape[0] == 0:
        return out
    fn = build().nn_min_dist_launch
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), queries.shape[0], points.data_ptr(),
                 points.shape[0], out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"nn_min_dist launch failed: CUDA error {err}")
    nn_min_dist.launches += 1
    return out


nn_min_dist.launches = 0
