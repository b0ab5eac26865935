"""Nearest-neighbour distance of query points to a point cloud.

:func:`nn_min_dist` launches the tensor-core kernel of
``csrc/nn_min_dist.cu`` for tensors on a GPU and runs
:func:`nn_min_dist_plain`, the same function in plain torch, for tensors
on the CPU.  There is no fallback between the two: a CUDA tensor takes
the kernel or raises.  :func:`nn_min_dist_scalar` launches the CUDA-core
kernel of the same source; it is the yardstick the tensor-core kernel is
timed against, and nothing on the main path calls it.

The tensor-core kernel filters, it does not measure.  Queries and cloud
are centred (s', p'), every cloud point is rounded to TF32 (p~) and
every query coordinate split into two TF32 pieces.  One ``mma`` per tile
computes e ~ ||p~||^2 - 2 s'.p~ = ||s' - p~||^2 - ||s'||^2 and compares
it with ``thr = (sqrt(best) + delta)^2 + E - ||s'||^2``
(:func:`filter_threshold`), where ``best`` is the smallest exact squared
distance (difference form, fp32, on the raw coordinates) the row has
confirmed so far, ``delta = max ||p' - p~||`` is how far the rounding
moved a point (||s' - p'|| >= ||s' - p~|| - delta) and ``E`` bounds the
arithmetic error of e.  Only a pair with e < thr is confirmed exactly,
so the result is the exact minimum.  The operands of the filter are laid
out here, by torch ops that run on either device:
:func:`prepare_cloud_operand`, :func:`prepare_query_operand`;
:func:`filter_values_plain` is what the kernel's ``mma`` computes.

Bound of the arithmetic error.  With hi = the nearest TF32 value of x
and lo = the nearest TF32 value of x - hi (|x - hi - lo| <= 2^-22 |x|),
all products of TF32 pieces are exact in fp32.  With R = (||s'|| +
||p'||)^2, in units of 2^-21 R: the dropped rest of s' in 2 s'.p~
<= 0.25; ||p~||^2 in two TF32 pieces <= 0.5; ||s'||^2 rounded to fp32
<= 0.125; the tensor cores' sum of 8 products and -thr, each addend
truncated at the largest one's last place <= 2.25; the centring (the
confirm sees the raw coordinates, the filter the centred ones, each
rounded once) <= 0.45; the fp32 rounding of the exact distance and of
thr <= 0.75.  That sums to 4.4 in the worst case; with fp32
round-to-nearest accumulation in place of the tensor cores' the CPU
tests (tests/test_torch_nn_filter.py) measure 0.40 at scales from 1 m
to 1 km and off centre.  ``E_row = ERROR_FACTOR * 2^-21 * (||s'|| + max
||p'||)^2`` with ERROR_FACTOR = 8.  A generous E only costs a few more
confirms; too small an E is a wrong answer.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "nn_min_dist.cu"

# rows of the query operand are padded to the queries one block owns,
# rows of the cloud operand to the points of one shared-memory stage;
# the kernel's launcher refuses other paddings
QUERY_PAD = 256
CLOUD_PAD = 1024
PAD_NORM = 1e30     # ||p'||^2 of a pad row of the cloud: never passes
ERROR_FACTOR = 8.0


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """The nearest fp32 value whose low 13 mantissa bits are zero (ties
    away from zero): a TF32 operand the tensor cores take unchanged."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo), both TF32 values, with x = hi + lo up to 2^-22 |x|;
    ``x - hi`` is exact in fp32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _pad_rows(n: int, pad: int) -> int:
    return max(1, -(-n // pad)) * pad


def prepare_cloud_operand(points: torch.Tensor):
    """The filter's cloud operand of ``points`` [M, 3] (M > 0).

    Returns ``(B, centre, p_max, delta)``: ``B`` [M_pad, 8] fp32 with
    rows (p~ xyz, p~ xyz, pp_hi, pp_lo), p~ = the TF32 rounding of
    p' = p - centre, pp = ||p~||^2 (taken in fp64, then split), pad rows
    all zero but pp_hi = PAD_NORM; ``centre`` [3] fp32, the midpoint of
    the bounding box; ``p_max``, a 0-dim fp64 tensor, max ||p'||;
    ``delta`` [1] fp32 > 0, max ||p' - p~|| rounded up.
    """
    M = points.shape[0]
    low, high = points.amin(0), points.amax(0)
    centre = low + 0.5 * (high - low)
    pc = points - centre
    pt = tf32_round(pc)
    pp = pt.double().square().sum(1)
    B = torch.zeros((_pad_rows(M, CLOUD_PAD), 8), dtype=torch.float32,
                    device=points.device)
    B[:M, 0:3] = B[:M, 3:6] = pt
    pp_hi = tf32_round(pp.float())
    B[:M, 6] = pp_hi
    B[:M, 7] = tf32_round((pp - pp_hi.double()).float())
    B[M:, 6] = tf32_round(torch.tensor(PAD_NORM))
    moved = (pc.double() - pt.double()).square().sum(1).max().sqrt()
    # rounded up, and positive so that the threshold of a row that has
    # confirmed nothing (best = inf) is inf and not inf * 0
    delta = (moved * (1.0 + 2.0 ** -20)).float().clamp(min=1e-30)
    p_max = pc.double().square().sum(1).max().sqrt()
    return B, centre, p_max, delta.reshape(1)


def prepare_query_operand(queries: torch.Tensor, centre: torch.Tensor,
                          p_max: torch.Tensor):
    """The filter's query operand of ``queries`` [S, 3].

    Returns ``(A, ss, err)``: ``A`` [S_pad, 8] fp32 with rows
    (-2 s'_hi xyz, -2 s'_lo xyz, 1, 1), s' = s - centre, pad rows zero;
    ``ss`` [S_pad] = ||s'||^2 and ``err`` [S_pad] = E_row (module
    docstring), both fp32 from fp64.
    """
    S = queries.shape[0]
    sc = queries - centre
    s_hi, s_lo = tf32_split(sc)
    S_pad = _pad_rows(S, QUERY_PAD)
    A = torch.zeros((S_pad, 8), dtype=torch.float32, device=queries.device)
    A[:S, 0:3] = -2.0 * s_hi
    A[:S, 3:6] = -2.0 * s_lo
    A[:S, 6:8] = 1.0
    ss64 = sc.double().square().sum(1)
    ss = torch.zeros(S_pad, dtype=torch.float32, device=queries.device)
    err = torch.zeros_like(ss)
    ss[:S] = ss64.float()
    err[:S] = (ERROR_FACTOR * 2.0 ** -21
               * (ss64.sqrt() + p_max).square()).float()
    return A, ss, err


def fragment_order(B: torch.Tensor) -> torch.Tensor:
    """The cloud operand [M_pad, 8] as the kernel reads it: for every two
    tiles of 8 points, the four words each of the 32 lanes feeds to its
    two ``mma`` (words t and t + 4 of point g of either tile, with
    lane = 4 g + t) stand together, so a stage is copied as it is and a
    lane's fragments are one 16-byte load."""
    return B.view(-1, 2, 8, 2, 4).permute(0, 2, 4, 1, 3).reshape(-1, 8)


def filter_values_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[S_pad, M_pad] fp32: the k=8 product the kernel's tensor-core
    instruction computes for every (query, point) pair."""
    return A @ B.T


def filter_threshold(best: torch.Tensor, ss: torch.Tensor, err: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """The kernel's threshold of a query row whose smallest confirmed
    squared distance is ``best``: a pair whose filter value is not below
    it cannot be nearer than sqrt(best)."""
    return best + 2.0 * delta * torch.sqrt(best) + (delta * delta + err - ss)


def build() -> ctypes.CDLL:
    """Build (or find) and load the kernels' library."""
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.nn_min_dist_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr,
                                       ptr, i64, i64, ptr, ptr, ptr, ptr]
    lib.nn_min_dist_scalar_launch.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
    lib.nn_filter_tile_launch.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
    for fn in (lib.nn_min_dist_launch, lib.nn_min_dist_scalar_launch,
               lib.nn_filter_tile_launch):
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(queries: torch.Tensor, points: torch.Tensor) -> None:
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
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def nn_min_dist(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Distance [S] of each query [S, 3] to its nearest point [M, 3].

    fp32, contiguous, both on one device.  CPU tensors take the plain
    version; CUDA tensors take the tensor-core kernel
    (``nn_min_dist.launches`` counts its launches, and
    ``nn_min_dist.confirms`` is the last launch's count, a device tensor,
    of the pairs it confirmed exactly).
    """
    _check_inputs(queries, points)
    if queries.device.type == "cpu":
        return nn_min_dist_plain(queries, points)
    S, M = queries.shape[0], points.shape[0]
    out = torch.empty(S, dtype=torch.float32, device=queries.device)
    if S == 0:
        return out
    if M == 0:
        return out.fill_(float("inf"))
    B, centre, p_max, delta = prepare_cloud_operand(points)
    A, ss, err = prepare_query_operand(queries, centre, p_max)
    B = fragment_order(B)
    confirms = torch.zeros(1, dtype=torch.int64, device=queries.device)
    _launch("nn_min_dist", build().nn_min_dist_launch, queries.device,
            A.data_ptr(), ss.data_ptr(), err.data_ptr(), delta.data_ptr(),
            A.shape[0], S, queries.data_ptr(), B.data_ptr(), B.shape[0], M,
            points.data_ptr(), out.data_ptr(), confirms.data_ptr())
    nn_min_dist.launches += 1
    nn_min_dist.confirms = confirms
    return out


nn_min_dist.launches = 0
nn_min_dist.confirms = None


def nn_min_dist_scalar(queries: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """:func:`nn_min_dist` by the CUDA-core kernel (one thread a query,
    every pair in the difference form): the yardstick of the tensor-core
    kernel's time.  CUDA tensors only; ``nn_min_dist_scalar.launches``
    counts its launches."""
    _check_inputs(queries, points)
    if queries.device.type != "cuda":
        raise ValueError("nn_min_dist_scalar runs on CUDA tensors only")
    out = torch.empty(queries.shape[0], dtype=torch.float32,
                      device=queries.device)
    if queries.shape[0] == 0:
        return out
    _launch("nn_min_dist_scalar", build().nn_min_dist_scalar_launch,
            queries.device, queries.data_ptr(), queries.shape[0],
            points.data_ptr(), points.shape[0], out.data_ptr())
    nn_min_dist_scalar.launches += 1
    return out


nn_min_dist_scalar.launches = 0


def filter_tile_values(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[S_pad, CLOUD_PAD] fp32: the filter values of every query row
    against the first stage of the cloud operand, written out by the
    kernel's own staging, fragment loads and ``mma`` (a debug entry of
    the library).  Equals ``filter_values_plain(A, B[:CLOUD_PAD])`` up to
    the tensor cores' accumulation order.  CUDA tensors only."""
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError("filter_tile_values runs on CUDA tensors only")
    for t, pad in ((A, QUERY_PAD), (B, CLOUD_PAD)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 8
                or t.shape[0] % pad or not t.is_contiguous()):
            raise ValueError("operands as prepare_*_operand lays them out")
    D = torch.empty((A.shape[0], CLOUD_PAD), dtype=torch.float32,
                    device=A.device)
    B = fragment_order(B)
    _launch("nn_filter_tile", build().nn_filter_tile_launch, A.device,
            A.data_ptr(), A.shape[0], B.data_ptr(), B.shape[0],
            D.data_ptr())
    return D
