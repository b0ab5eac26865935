"""Kernel N: the distance of query points to the nearest triangle of a
mesh.

``mesh_min_dist`` takes points [P, 3] f32 and triangles [M, 3, 3] f32
(vertices a, b, c) and returns [P] f32, +inf where M = 0.  CUDA tensors
launch ``csrc/mesh_min_dist.cu`` (one thread a point, triangles staged
through shared memory in tiles); CPU tensors take
:func:`mesh_min_dist_plain`, the reference's chunked scan in plain
torch, chunked over the points too.  Both compute each pair by the
reference's formula in the same order of correctly rounded fp32
operations (no multiply-add contraction in the kernel), so they agree bit
for bit on finite inputs; the kernel decides the region first and
computes only its projection.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import load_library
from limap_tpu_torch.ops.line_ransac import dot3

SOURCE = "mesh_min_dist.cu"
GUARD = 1e-12
TRI_CHUNK = 2048        # triangles a step of the scan, as the reference
PAIR_BUDGET = 1 << 23   # (point, triangle) pairs a step of the plain scan

# fp32 operations of csrc/mesh_min_dist.cu a (point, triangle) pair,
# counted from its source (an add, sub, mul, divide, compare or select
# counts one; the tile's per-triangle differences are left out)
OPS_PAIR_PARTS = {
    "differences p - a, p - b, p - c": 9,
    "dot products d1..d6": 30,
    "va, vb, vc": 9,
    "d4 - d3, d5 - d6": 2,
    "region compares": 15,
    "the region's numerators and denominators (selects, denom)": 14,
    "guards": 6,
    "divisions": 2,
    "clip": 4,
    "origin and direction selects": 9,
    "closest point and difference": 15,
    "squared norm": 5,
    "running min": 2,
}
OPS_PAIR = sum(OPS_PAIR_PARTS.values())


def _guard(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < GUARD, GUARD, x)


def point_triangle_distance(p: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Distance from points [..., 3] to triangles [..., 3] (broadcast):
    the branch-free barycentric clamp of the reference, formula for
    formula (every projection, then the regions' where chain: vertex a
    over b over c over edge ab over ac over bc over the face)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3(ab, ap)
    d2 = dot3(ac, ap)
    bp = p - b
    d3 = dot3(ab, bp)
    d4 = dot3(ac, bp)
    cp = p - c
    d5 = dot3(ab, cp)
    d6 = dot3(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = _guard(va + vb + vc)

    v = vb / denom
    w = vc / denom
    p_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = torch.clamp(d1 / _guard(d1 - d3), 0, 1)
    p_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / _guard(d2 - d6), 0, 1)
    p_ac = a + t_ac[..., None] * ac
    t_bc = torch.clamp((d4 - d3) / _guard((d4 - d3) + (d5 - d6)), 0, 1)
    p_bc = b + t_bc[..., None] * (c - b)

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    closest = p_face
    for mask, proj in ((on_bc, p_bc), (on_ac, p_ac), (on_ab, p_ab),
                       (in_vert_c, c), (in_vert_b, b), (in_vert_a, a)):
        closest = torch.where(mask[..., None], proj, closest)
    diff = p - closest
    return torch.sqrt(dot3(diff, diff))


def mesh_min_dist_plain(points: torch.Tensor, tris: torch.Tensor,
                        chunk: int = TRI_CHUNK,
                        pair_budget: int = PAIR_BUDGET) -> torch.Tensor:
    """min over triangles of :func:`point_triangle_distance`: the
    reference's scan over chunks of ``chunk`` triangles with a running
    min, for ``pair_budget // chunk`` points at a time (no [P, chunk]
    intermediate of the whole point set)."""
    P, M = points.shape[0], tris.shape[0]
    out = torch.full((P,), float("inf"), dtype=points.dtype,
                     device=points.device)
    step = max(1, pair_budget // chunk)
    for i in range(0, P, step):
        p = points[i:i + step, None]
        best = out[i:i + step]
        for j in range(0, M, chunk):
            t = tris[j:j + chunk]
            d = point_triangle_distance(p, t[None, :, 0], t[None, :, 1],
                                        t[None, :, 2])
            best = torch.minimum(best, d.amin(1))
        out[i:i + step] = best
    return out


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.mesh_min_dist_launch.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
    lib.mesh_min_dist_launch.restype = ctypes.c_int
    return lib


def _check_inputs(points: torch.Tensor, tris: torch.Tensor) -> None:
    for name, t, shape in (("points", points, (3,)),
                           ("triangles", tris, (3, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{name} must be [*, "
                             f"{', '.join(map(str, shape))}], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if points.device != tris.device:
        raise ValueError(f"points on {points.device}, triangles on "
                         f"{tris.device}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")


def mesh_min_dist(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Distance [P] of each point [P, 3] to its nearest triangle
    [M, 3, 3].  CPU tensors take the plain version; CUDA tensors launch
    the kernel (``mesh_min_dist.launches`` counts its launches).  P = 0
    gives an empty tensor and M = 0 +inf, neither with a launch."""
    _check_inputs(points, tris)
    if points.device.type == "cpu":
        return mesh_min_dist_plain(points, tris)
    P, M = points.shape[0], tris.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=points.device)
    if P == 0:
        return out
    if M == 0:
        return out.fill_(float("inf"))
    lib = build()
    with torch.cuda.device(points.device):
        err = lib.mesh_min_dist_launch(
            points.data_ptr(), P, tris.data_ptr(), M, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mesh_min_dist launch failed: CUDA error {err}")
    mesh_min_dist.launches += 1
    return out


mesh_min_dist.launches = 0
