"""Kernel R: the log-domain Sinkhorn solver with dustbins.

``log_sinkhorn(scores, bin_score, iters)`` takes scores [M, N] f32 and
returns the log assignment Z [M+1, N+1] f32: the coupling (the scores
with a dustbin row and column of ``bin_score``) plus the potentials u and
v after ``iters`` alternating row and column updates, minus the norm
-log(M + N).  CUDA tensors launch ``csrc/log_sinkhorn.cu`` (the whole
solve in one cooperative launch, the coupling held in shared memory in
row bands, a CTA an SM; see :func:`plan`); CPU tensors take
:func:`log_sinkhorn_plain`.  The
marginal constants are computed here in float32, as the reference does,
and handed to both.

:func:`bands_replay` repeats the kernel's band partials and their merge
in torch, for tests of its order on the CPU.  ``log_sinkhorn_scan`` is
the first design (a warp a row of the coupling and of its transposed
copy, both in global memory), kept as a yardstick for timing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "log_sinkhorn.cu"
# fp32 operations an element and pass (add, max, subtract, exp, add)
OPS_ELEMENT_PASS = 5
# exps the special function units retire a clock on one SM (one MUFU ex2
# an expf)
EXPS_PER_CLOCK_SM = 16


@functools.lru_cache(maxsize=1024)
def constants(M: int, N: int):
    """(norm, log_mu of the row dustbin, log_nu of the column dustbin),
    each float32 as the reference's weakly typed scalars (floats, computed
    once a shape)."""
    ms = torch.tensor(float(M), dtype=torch.float32)
    ns = torch.tensor(float(N), dtype=torch.float32)
    norm = -torch.log(ms + ns)
    return (float(norm), float(torch.log(ns) + norm),
            float(torch.log(ms) + norm))


def coupling(scores: torch.Tensor, bin_score: float) -> torch.Tensor:
    """The scores with a dustbin column and row of ``bin_score``."""
    M, N = scores.shape
    b = torch.tensor(float(bin_score), dtype=torch.float32,
                     device=scores.device)
    return torch.cat([torch.cat([scores, b.expand(M, 1)], 1),
                      torch.cat([b.expand(1, N), b.expand(1, 1)], 1)], 0)


def marginals(M: int, N: int, device):
    """(log_mu [M+1], log_nu [N+1], norm) as float32 tensors."""
    norm, mu_bin, nu_bin = (torch.tensor(c, dtype=torch.float32,
                                         device=device)
                            for c in constants(M, N))
    return (torch.cat([norm.expand(M), mu_bin[None]]),
            torch.cat([norm.expand(N), nu_bin[None]]), norm)


def log_sinkhorn_plain(scores: torch.Tensor, bin_score: float,
                       iters: int) -> torch.Tensor:
    """The reference's loop in torch ops."""
    M, N = scores.shape
    dev = scores.device
    couplings = coupling(scores, bin_score)
    log_mu, log_nu, norm = marginals(M, N, dev)
    u = torch.zeros(M + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(N + 1, dtype=torch.float32, device=dev)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], dim=0)
    return couplings + u[:, None] + v[None, :] - norm


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def merge_bands(pm: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """A column's logsumexp from its bands' partials [bands, C] (raw max,
    sum of exps from the max or 0): the kernel's merge, bands in order,
    a band with s_b = 0 skipped."""
    m = _finite_or_zero(pm.max(0).values)
    s = torch.zeros_like(m)
    for pb, sb in zip(pm, ps):
        term = sb * torch.exp(_finite_or_zero(pb) - m)
        s = s + torch.where(sb > 0, term, torch.zeros_like(term))
    return torch.log(s) + m


def band_firsts(rows: int, bands: int):
    """Each band's first row when the kernel cuts ``rows`` into ``bands``
    (band b holds rows [b rows // bands, (b + 1) rows // bands))."""
    return [b * rows // bands for b in range(bands)]


def bands_replay(scores: torch.Tensor, bin_score: float, iters: int,
                 firsts) -> torch.Tensor:
    """The kernel's arithmetic in torch with the coupling's rows cut into
    bands (``firsts``: each band's first row, ascending from 0; a band may
    be empty): the u-pass a row at a time, the v-pass as each band's
    partial of every column, then the merge in band order
    (:func:`merge_bands`)."""
    M, N = scores.shape
    z = coupling(scores, bin_score)
    log_mu, log_nu, norm = marginals(M, N, scores.device)
    bounds = list(firsts) + [M + 1]
    u = torch.zeros(M + 1, dtype=torch.float32, device=scores.device)
    v = torch.zeros(N + 1, dtype=torch.float32, device=scores.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[None, :], dim=1)
        x = z + u[:, None]
        pm, ps = [], []
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            band = x[r0:r1]
            mx = (band.max(0).values if r1 > r0
                  else torch.full_like(v, float("-inf")))
            ps.append(torch.exp(band - _finite_or_zero(mx)[None]).sum(0))
            pm.append(mx)
        v = log_nu - merge_bands(torch.stack(pm), torch.stack(ps))
    return z + u[:, None] + v[None, :] - norm


def work(M: int, N: int, iters: int):
    """(fp32 operations, bytes, exps) of one solve: every element twice an
    iteration, the scores read and Z written once (scratch is the
    kernel's, not the function's traffic); an exp an element and pass."""
    cells = (M + 1) * (N + 1)
    return (2 * iters * cells * OPS_ELEMENT_PASS,
            4 * (M * N + cells), 2 * iters * cells)


def exp_ms(exps: float, sms: int, clock_hz: float) -> float:
    """The least time ``exps`` take on ``sms`` SMs at ``clock_hz``."""
    return 1e3 * exps / (EXPS_PER_CLOCK_SM * sms * clock_hz)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.log_sinkhorn_plan.argtypes = [i32, i32, i32, ptr]
    lib.log_sinkhorn_plan.restype = ctypes.c_int
    lib.log_sinkhorn_launch.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr,
                                        i32, ptr]
    lib.log_sinkhorn_launch.restype = ctypes.c_int
    lib.log_sinkhorn_parts_launch.argtypes = [ptr, i32, i32, i32, ptr, ptr,
                                              ptr, i32, ptr]
    lib.log_sinkhorn_parts_launch.restype = ctypes.c_int
    lib.log_sinkhorn_scan_launch.argtypes = [ptr, i32, i32, i32, ptr, ptr,
                                             ptr, ptr, ptr, ptr]
    lib.log_sinkhorn_scan_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def _plan(device_index: int, M: int, N: int, rows_cap: int):
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device_index):
        err = build().log_sinkhorn_plan(M, N, rows_cap, out)
    if err:
        raise RuntimeError(f"log_sinkhorn_plan failed: CUDA error {err}")
    return {"ctas": int(out[0]), "rows_in_shared_memory": int(out[1]),
            "shared_memory_bytes": int(out[2]), "rows_a_band": int(out[3]),
            "threads": int(out[4]), "v_in_shared_memory": bool(out[5])}


def plan(M: int, N: int, device=None, rows_cap: int = -1):
    """How the kernel runs an (M+1) x (N+1) coupling on ``device`` (the
    current CUDA device by default): {"ctas", "threads" (a CTA),
    "rows_a_band", "rows_in_shared_memory" (the rest of a band is read
    from global memory), "shared_memory_bytes", "v_in_shared_memory"
    (else v is read from global memory: couplings too wide for a CTA's
    shared memory)}.  ``rows_cap`` caps a band's rows in shared memory,
    for tests."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_plan(index, M, N, rows_cap))


def _check(scores, iters):
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"scores must be [M, N] float32, got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    M, N = scores.shape
    if M + N == 0:
        raise ValueError("log_sinkhorn needs M + N > 0")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def _floats(bin_score, M, N):
    return (ctypes.c_float * 4)(float(bin_score), *constants(M, N))


# the kernel's parts, to time them (:func:`launch_parts`): the barriers,
# the u-pass, the v-partials; the merge comes with all of them
PART_SYNC, PART_U, PART_V = 1, 2, 4
TIMED_PARTS = (PART_SYNC, PART_SYNC | PART_U, PART_SYNC | PART_U | PART_V)


def _launch(scores, bin_score, iters, rows_cap=-1, parts=None):
    _check(scores, iters)
    if scores.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {scores.device}")
    M, N = scores.shape
    scores = scores.contiguous()
    dev = scores.device
    p = plan(M, N, dev, rows_cap)
    Z = torch.empty(M + 1, N + 1, dtype=torch.float32, device=dev)
    scratch = torch.empty((2 * p["ctas"] + 1) * (N + 1),
                          dtype=torch.float32, device=dev)
    args = (scores.data_ptr(), M, N, int(iters), _floats(bin_score, M, N),
            Z.data_ptr(), scratch.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if parts is None:
            err = build().log_sinkhorn_launch(*args, rows_cap, stream)
        else:
            err = build().log_sinkhorn_parts_launch(*args, parts, stream)
    if err:
        raise RuntimeError(f"log_sinkhorn launch failed: CUDA error {err}")
    return Z


def launch(scores: torch.Tensor, bin_score: float, iters: int,
           rows_cap: int = -1) -> torch.Tensor:
    """One launch of the kernel on CUDA scores, uncounted; ``rows_cap`` as
    :func:`plan`'s (the tests' way to drive the rows read from global
    memory)."""
    return _launch(scores, bin_score, iters, rows_cap)


def launch_parts(scores: torch.Tensor, bin_score: float, iters: int,
                 parts: int) -> torch.Tensor:
    """The kernel with only ``parts`` (one of :data:`TIMED_PARTS`) in its
    iterations, uncounted, to time them; couplings whose v lives in
    shared memory."""
    if parts not in TIMED_PARTS:
        raise ValueError(f"parts must be one of {TIMED_PARTS}, got {parts}")
    return _launch(scores, bin_score, iters, parts=parts)


def log_sinkhorn(scores: torch.Tensor, bin_score: float,
                 iters: int = 50) -> torch.Tensor:
    """Z [M+1, N+1] of scores [M, N] f32 (M + N > 0).  CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``log_sinkhorn.launches`` counts its launches)."""
    _check(scores, iters)
    if scores.device.type == "cpu":
        return log_sinkhorn_plain(scores, float(bin_score), iters)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    Z = launch(scores, bin_score, iters)
    log_sinkhorn.launches += 1
    return Z


log_sinkhorn.launches = 0


def log_sinkhorn_scan(scores: torch.Tensor, bin_score: float,
                      iters: int = 50) -> torch.Tensor:
    """The first design of kernel R (the coupling and its transpose in
    global memory, a warp a row of each), the yardstick; CUDA tensors
    only.  ``log_sinkhorn_scan.launches`` counts its launches."""
    _check(scores, iters)
    if scores.device.type != "cuda":
        raise ValueError("log_sinkhorn_scan is a kernel of the card")
    M, N = scores.shape
    scores = scores.contiguous()
    dev = scores.device
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    Z, Zt, u, v = e(M + 1, N + 1), e(N + 1, M + 1), e(M + 1), e(N + 1)
    with torch.cuda.device(dev):
        err = build().log_sinkhorn_scan_launch(
            scores.data_ptr(), M, N, int(iters), _floats(bin_score, M, N),
            Z.data_ptr(), Zt.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"log_sinkhorn_scan launch failed: CUDA error "
                           f"{err}")
    log_sinkhorn_scan.launches += 1
    return Z


log_sinkhorn_scan.launches = 0
