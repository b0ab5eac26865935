"""Hypothesis scoring of the batched line RANSAC: for every segment's
sample points and every hypothesis (a pair of its samples), the inliers
of the line through the pair, then the first best hypothesis.

``line_ransac`` takes points [N, S, 3] f32, valid [N, S] bool, inlier_th
[N] f32 and the hypotheses idx_a / idx_b [N, H] int32, and returns the
best hypothesis's inlier mask [N, S] bool, n_inl [N] int32, n_valid [N]
int32 and best [N] int32.  A hypothesis with an invalid sample counts -1
inliers; ``best`` is the first maximum, as an argmax picks it.

CUDA tensors launch ``csrc/line_ransac.cu``; CPU tensors take
:func:`line_ransac_plain`.  Both compute the distance in the same order
of correctly rounded fp32 operations, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import check_tensor

SOURCE = "line_ransac.cu"
EPS = 1e-12
MAX_SAMPLES = 256     # samples a segment the kernel holds in shared memory
PLAIN_CHUNK = 4096    # segments a step of the plain version


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2, each operation rounded (no reduction
    kernel, whose order differs between devices)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def point_line_dist(points: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Distance of points [..., S, 3] to the infinite line through a, b
    [..., 3]: unit direction with ``+EPS``, then |disp|^2 - along^2
    clamped at 0 (NaN kept), then the root."""
    d = b - a
    d = d / (torch.sqrt(dot3(d, d)) + EPS)[..., None]
    disp = points - a[..., None, :]
    along = dot3(disp, d[..., None, :])
    d2 = dot3(disp, disp) - along * along
    return torch.sqrt(torch.clamp(d2, min=0.0))


def line_ransac_plain(points, valid, inlier_th, idx_a, idx_b):
    """The scoring in plain torch, in chunks of segments."""
    outs = [_plain_chunk(points[i:i + PLAIN_CHUNK], valid[i:i + PLAIN_CHUNK],
                         inlier_th[i:i + PLAIN_CHUNK],
                         idx_a[i:i + PLAIN_CHUNK], idx_b[i:i + PLAIN_CHUNK])
            for i in range(0, max(points.shape[0], 1), PLAIN_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _plain_chunk(points, valid, inlier_th, idx_a, idx_b):
    N = points.shape[0]
    rows = torch.arange(N, device=points.device)[:, None]
    ia, ib = idx_a.long(), idx_b.long()
    hyp_ok = valid[rows, ia] & valid[rows, ib]
    dist = point_line_dist(points[:, None], points[rows, ia],
                           points[rows, ib])                   # [N, H, S]
    is_inlier = (dist <= inlier_th[:, None, None]) & valid[:, None, :]
    counts = is_inlier.sum(-1, dtype=torch.int32)
    counts = torch.where(hyp_ok, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts, dim=-1) if counts.shape[-1] else \
        torch.zeros(N, dtype=torch.long, device=points.device)
    inliers = is_inlier[torch.arange(N, device=points.device), best] \
        if counts.shape[-1] else torch.zeros_like(valid)
    return (inliers, inliers.sum(-1, dtype=torch.int32),
            valid.sum(-1, dtype=torch.int32), best.to(torch.int32))


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.line_ransac_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                       i64, ptr, ptr, ptr, ptr, ptr]
    lib.line_ransac_launch.restype = ctypes.c_int
    return lib


def line_ransac(points, valid, inlier_th, idx_a, idx_b):
    """Score every hypothesis of every segment and keep the best
    (``line_ransac.launches`` counts the kernel's launches)."""
    N, S = valid.shape
    H = idx_a.shape[1] if idx_a.dim() == 2 else 0
    device = points.device
    for name, t, dtype, shape in (
            ("points", points, torch.float32, (N, S, 3)),
            ("valid", valid, torch.bool, (N, S)),
            ("inlier_th", inlier_th, torch.float32, (N,)),
            ("idx_a", idx_a, torch.int32, (N, H)),
            ("idx_b", idx_b, torch.int32, (N, H))):
        check_tensor(name, t, dtype, shape, device)
    if device.type == "cpu":
        return line_ransac_plain(points, valid, inlier_th, idx_a, idx_b)
    if S > MAX_SAMPLES or H < 1:
        raise ValueError(f"the kernel takes 1..{MAX_SAMPLES} samples and at "
                         f"least one hypothesis, got S={S}, H={H}")
    inliers = torch.empty((N, S), dtype=torch.bool, device=device)
    n_inl, n_valid, best = (torch.empty(N, dtype=torch.int32, device=device)
                            for _ in range(3))
    if N == 0:
        return inliers, n_inl, n_valid, best
    args = [t.contiguous() for t in (points, valid, inlier_th, idx_a, idx_b)]
    with torch.cuda.device(device):
        err = build().line_ransac_launch(
            *(t.data_ptr() for t in args), N, S, H, inliers.data_ptr(),
            n_inl.data_ptr(), n_valid.data_ptr(), best.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"line_ransac launch failed: CUDA error {err}")
    line_ransac.launches += 1
    return inliers, n_inl, n_valid, best


line_ransac.launches = 0
