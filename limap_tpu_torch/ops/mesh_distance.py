"""Kernel N: the distance of query points to the nearest triangle of a
mesh.

``mesh_min_dist`` takes points [P, 3] f32 and triangles [M, 3, 3] f32
(vertices a, b, c), or the mesh as :func:`prepare_mesh` lays it out, and
returns [P] f32, +inf where M = 0.  CUDA tensors launch
``csrc/mesh_min_dist.cu`` (a warp 32 points; triangles sorted along a
Morton curve in clusters of 32 with their boxes, a cluster skipped where
its box proves that none of its pairs can hold a point's minimum; the
ill-conditioned triangles scanned for every point); CPU tensors take
:func:`mesh_min_dist_plain`, the reference's chunked scan in plain
torch, chunked over the points too.  Both compute each pair by the
reference's formula in the same order of correctly rounded fp32
operations (no multiply-add contraction in the kernel), and the kernel
skips only pairs whose squared distance exceeds the point's best, so
they agree bit for bit on finite inputs.  :func:`mesh_min_dist_culled`
replays the kernel's cull decisions in torch (same arrays, seed and
margin) for the tests; :func:`mesh_min_dist_scan` is the first kernel,
every pair, kept as the yardstick of the time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


def point_triangle_sq(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """Squared distance from points [..., 3] to triangles [..., 3]
    (broadcast): the branch-free barycentric clamp of the reference,
    formula for formula (every projection, then the regions' where chain:
    vertex a over b over c over edge ab over ac over bc over the face)."""
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
    return dot3(diff, diff)


def point_triangle_distance(p: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Distance from points [..., 3] to triangles [..., 3] (broadcast):
    the root of :func:`point_triangle_sq`, as the reference takes it."""
    return torch.sqrt(point_triangle_sq(p, a, b, c))


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


# The cull (csrc/mesh_min_dist.cu's header derives each number): clusters
# of CLUSTER triangles; a triangle is well-conditioned where it is finite,
# its shortest edge at least SHAPE_MIN L and |ab x ac| at least SHAPE_MIN
# L^2 (L its longest edge); the margin's constants.
CLUSTER = 32            # triangles a cluster, at most
GROUP = 32              # clusters a group (the seed's coarse level), at most
MORTON_BITS = 16
SHAPE_MIN = 1e-2
C_FACE = 256
UNIT = 2.0 ** -24
REL = 1.0 + 2.0 ** -18
# the kernel's Margin: C_FACE u, 8 u, 1 + 2^-18 (exact in fp32)
MARGIN = (C_FACE * UNIT, 8 * UNIT, REL)
# fp32 operations of the cull's box test (csrc/mesh_min_dist.cu's skip)
# and of the seed's box distance (box_lb2 and the running argmin)
OPS_BOX_PARTS = {
    "gaps": 12,
    "lb2": 5,
    "far corner": 15,
    "R and R^2": 8,
    "delta": 4,
    "threshold and compare": 6,
}
OPS_BOX = sum(OPS_BOX_PARTS.values())
OPS_SEED = 19


COUNTS = ("pairs", "scanned", "tests", "sweep_tests", "seed_tests")


def cull_work(counts: dict) -> int:
    """fp32 operations of kernel N's cull from its counts: every pair it
    evaluated, the sweep's tests (each against two boxes), the lane tests
    and the seed's box distances."""
    return (counts["pairs"] * OPS_PAIR + counts["seed_tests"] * OPS_SEED
            + (2 * counts["sweep_tests"] + counts["tests"]) * OPS_BOX)


class PreparedMesh(NamedTuple):
    """The mesh as kernel N reads it (:func:`prepare_mesh`)."""
    tris: torch.Tensor          # [M, 3, 3] f32, as given
    records: torch.Tensor       # [n, 20] f32: a, b, c, b-a, c-a, c-b, 0, 0
    order: torch.Tensor         # [n] int64: each record's triangle
    clusters: torch.Tensor      # [C, 12] f32: lo, kappa, hi, lam, m, 0s
    starts: torch.Tensor        # [C + 1] int32: the clusters' records
    groups: torch.Tensor        # [G, 12] f32: as clusters, of theirs
    gstarts: torch.Tensor       # [G + 1] int32: the groups' clusters
    always: torch.Tensor        # [A, 20] f32: the other triangles' records
    always_index: torch.Tensor  # [A] int64


def _records(t: torch.Tensor) -> torch.Tensor:
    """[n, 20] f32 records of triangles [n, 3, 3] f32: the vertices and
    the differences b - a, c - a, c - b the kernel reads (fp32, each
    correctly rounded), and two zeros."""
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    z = torch.zeros(len(t), 2, dtype=t.dtype, device=t.device)
    return torch.cat([a, b, c, b - a, c - a, c - b, z], 1).contiguous()


def _round_up(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the smallest float32 at or above it."""
    y = x.float()
    return torch.where(y.double() < x, torch.nextafter(
        y, torch.full_like(y, float("inf"))), y)


def morton_codes(points: torch.Tensor, bits: int = MORTON_BITS
                 ) -> torch.Tensor:
    """int64 Morton codes of points [n, 3] (float64): the points' bounding
    cube (its longest side on every axis) cut into 2**bits cells a side,
    the cell's bits interleaved x, y, z from the lowest, so that the codes
    ``>> 3 (bits - k)`` name the cells of an octree's level k."""
    lo = points.amin(0)
    ext = (points.amax(0) - lo).amax()
    ext = torch.where(ext > 0, ext, torch.ones_like(ext))
    q = torch.clamp(((points - lo) / ext * (1 << bits)).floor(),
                    max=(1 << bits) - 1).to(torch.int64)
    code = torch.zeros(len(points), dtype=torch.int64, device=points.device)
    for k in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> k) & 1) << (3 * k + axis)
    return code


def chunk_runs(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """Chunk ids [n] of sorted keys [n]: each run of equal keys cut into
    ceil(len / cap) chunks of even size (at most cap), numbered in
    order."""
    n = len(keys)
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    start = torch.nonzero(new).flatten()
    length = torch.diff(torch.cat([start, start.new_tensor([n])]))
    m = (length + cap - 1) // cap
    size = (length + m - 1) // m
    first = torch.cumsum(m, 0) - m
    pos = torch.arange(n, device=keys.device) - start[run]
    return first[run] + pos // size[run]


def octree_level(code: torch.Tensor, cap: int,
                 bits: int = MORTON_BITS) -> int:
    """The finest octree level whose occupied cells hold cap / 2 of the
    codes on average (0 where none does)."""
    for k in range(bits, 0, -1):
        cells = torch.unique(code >> (3 * (bits - k))).numel()
        if len(code) >= cells * cap / 2:
            return k
    return 0


def _starts(ids: torch.Tensor, n_ids: int) -> torch.Tensor:
    counts = torch.bincount(ids, minlength=n_ids)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]) \
        .to(torch.int32)


def _scatter(ids, values, n_ids, reduce, fill):
    """[n_ids, ...] the ``reduce`` ("amin" / "amax") of values [n, ...]
    by id."""
    out = values.new_full((n_ids,) + values.shape[1:], fill)
    idx = ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce)


def prepare_mesh(tris: torch.Tensor, cluster: int = CLUSTER) -> PreparedMesh:
    """Kernel N's layout of triangles [M, 3, 3] f32, on their device: the
    well-conditioned triangles sorted by the Morton code of their
    centroids; the clusters, each run of triangles in one cell of the
    octree level where cells hold ``cluster`` / 2 of them on average, cut
    evenly into pieces of at most ``cluster``, each with its box (exact
    fp32 bounds), kappa = L^2 / (|N| l) (largest over the cluster, rounded
    up to fp32), its longest edge (rounded up) and its largest coordinate
    magnitude; the groups, the clusters' runs two levels coarser cut into
    pieces of at most ``GROUP``, with their boxes and the largest kappa,
    edge and magnitude of their clusters; every other triangle in the
    always list, in the given order."""
    if tris.dtype != torch.float32 or tris.dim() != 3 \
            or tuple(tris.shape[1:]) != (3, 3):
        raise ValueError(f"triangles must be float32 [M, 3, 3], got "
                         f"{tris.dtype} {tuple(tris.shape)}")
    dev = tris.device
    t64 = tris.double()
    a, b, c = t64[:, 0], t64[:, 1], t64[:, 2]
    e2 = torch.stack([((b - a) ** 2).sum(1), ((c - a) ** 2).sum(1),
                      ((c - b) ** 2).sum(1)], 1)
    L2, l2 = e2.amax(1), e2.amin(1)
    area2 = torch.linalg.vector_norm(torch.linalg.cross(b - a, c - a),
                                     dim=1)
    well = (torch.isfinite(t64).flatten(1).all(1) & (L2 > 0)
            & (l2 >= SHAPE_MIN ** 2 * L2) & (area2 >= SHAPE_MIN * L2))
    idx = torch.nonzero(well).flatten()
    always_index = torch.nonzero(~well).flatten()
    code = morton_codes(((a + b + c) / 3)[idx]) if len(idx) else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    code, perm = torch.sort(code, stable=True)
    order = idx[perm]
    n = len(order)
    t = tris[order]
    inf = float("inf")
    if n:
        k = octree_level(code, cluster)
        cid = chunk_runs(code >> (3 * (MORTON_BITS - k)), cluster)
        C = int(cid[-1]) + 1
    else:
        k, cid, C = 0, code, 0
    starts = _starts(cid, C)
    clusters = torch.zeros(C, 12, dtype=torch.float32, device=dev)
    clusters[:, 0:3] = _scatter(cid, t.amin(1), C, "amin", inf)
    clusters[:, 4:7] = _scatter(cid, t.amax(1), C, "amax", -inf)
    kappa_t = L2[order] / (area2[order] * l2[order].sqrt())
    clusters[:, 3] = _round_up(_scatter(cid, kappa_t, C, "amax", 0.0))
    clusters[:, 7] = _round_up(_scatter(cid, L2[order].sqrt(), C, "amax",
                                        0.0))
    clusters[:, 8] = _scatter(cid, t.abs().flatten(1).amax(1), C, "amax",
                              0.0)
    if C:
        ckey = code[starts[:-1].long()] >> (3 * (MORTON_BITS
                                                 - max(k - 2, 0)))
        gid = chunk_runs(ckey, GROUP)
        G = int(gid[-1]) + 1
    else:
        gid, G = cid, 0
    groups = torch.zeros(G, 12, dtype=torch.float32, device=dev)
    groups[:, 0:3] = _scatter(gid, clusters[:, 0:3], G, "amin", inf)
    groups[:, 4:7] = _scatter(gid, clusters[:, 4:7], G, "amax", -inf)
    for col in (3, 7, 8):
        groups[:, col] = _scatter(gid, clusters[:, col], G, "amax", 0.0)
    return PreparedMesh(tris, _records(t), order, clusters, starts, groups,
                        _starts(gid, G), _records(tris[always_index]),
                        always_index)


def _margin(device) -> tuple:
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in MARGIN)


def _box_lb2(cl: torch.Tensor, blo: torch.Tensor,
             bhi: torch.Tensor) -> torch.Tensor:
    """The kernel's box_lb2: the squared distance of the box [blo, bhi]
    to each cluster's box, fp32 in the kernel's order."""
    g = torch.clamp(torch.maximum(cl[..., 0:3] - bhi, blo - cl[..., 4:7]),
                    min=0)
    return dot3(g, g)


def _skip(cl: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
          best: torch.Tensor, margin: tuple) -> torch.Tensor:
    """The kernel's skip: no pair of the cluster can compute a squared
    distance at or below ``best`` for a point of the box [blo, bhi]."""
    face_k, abs_k, rel = margin
    lb2 = _box_lb2(cl, blo, bhi)
    f = torch.maximum((cl[..., 4:7] - blo).abs(), (bhi - cl[..., 0:3]).abs())
    r = torch.sqrt(dot3(f, f)) + cl[..., 7]
    r2 = r * r
    delta = (face_k * r2) * cl[..., 3] + abs_k * cl[..., 8]
    t = torch.sqrt(best) * rel + delta
    return lb2 > (t * t) * rel


def _scan(p: torch.Tensor, rec: torch.Tensor,
          best: torch.Tensor) -> torch.Tensor:
    if len(rec) == 0:
        return best
    sq = point_triangle_sq(p[:, None], rec[None, :, 0:3], rec[None, :, 3:6],
                           rec[None, :, 6:9])
    return torch.minimum(best, sq.amin(1))


def _seeds(p: torch.Tensor, mesh: PreparedMesh):
    """(seeds, box distances computed): each lane's seed, the first
    nearest cluster (box distance) within its first nearest group (C
    where none), and how many box distances that took."""
    C, G = mesh.clusters.shape[0], mesh.groups.shape[0]
    if C == 0:
        return [C] * len(p), [G] * len(p)
    gs = mesh.gstarts.tolist()
    g = torch.argmin(_box_lb2(mesh.groups[None], p[:, None], p[:, None]), 1)
    seeds, tests = [], []
    for k, gk in enumerate(g.tolist()):
        cl = mesh.clusters[gs[gk]:gs[gk + 1]]
        seeds.append(gs[gk] + int(torch.argmin(_box_lb2(cl, p[k], p[k]))))
        tests.append(G + len(cl))
    return seeds, tests


class _Warp:
    """A warp's points [32, 3] in the kernel's two boxes: lanes up to the
    largest squared step to the next lane (the first of equal steps) and
    the rest."""

    def __init__(self, p: torch.Tensor):
        step = p[1:] - p[:-1]
        self.split = int(torch.argmax(dot3(step, step))) + 1
        a, b = p[:self.split], p[self.split:]
        self.boxes = ((a.amin(0), a.amax(0)), (b.amin(0), b.amax(0)))

    def keep(self, cl: torch.Tensor, best: torch.Tensor,
             margin: tuple) -> torch.Tensor:
        """Step 2: the entries of ``cl`` some point of either box may
        need, each box against the largest best of its lanes."""
        (a0, a1), (b0, b1) = self.boxes
        return (~_skip(cl, a0, a1, best[:self.split].max(), margin)
                | ~_skip(cl, b0, b1, best[self.split:].max(), margin))


def mesh_min_dist_culled(points: torch.Tensor, mesh: PreparedMesh):
    """(distances [P], counts {pairs, scanned, tests, sweep_tests,
    seed_tests}): kernel N's cull replayed in torch on the same prepared
    arrays, seeds, boxes and margin, warp by warp (32 consecutive points,
    the last warp's missing lanes a copy of its first point), each
    decision in the kernel's fp32 order; the minimum is taken over the
    pairs it keeps only."""
    margin = _margin(points.device)
    P = points.shape[0]
    C, G = mesh.clusters.shape[0], mesh.groups.shape[0]
    starts, gstarts = mesh.starts.tolist(), mesh.gstarts.tolist()
    out = torch.empty(P, dtype=torch.float32, device=points.device)
    counts = dict.fromkeys(COUNTS, 0)
    for i0 in range(0, P, 32):
        n = min(32, P - i0)
        p = points[i0:i0 + 32]
        p = torch.cat([p, p[:1].expand(32 - n, 3)])
        w = _Warp(p)
        best = _scan(p, mesh.always, torch.full((32,), float("inf"),
                                                device=p.device))
        counts["pairs"] += len(mesh.always) * n
        lane_seeds, seed_tests = _seeds(p, mesh)
        counts["seed_tests"] += sum(seed_tests[:n])
        seeds = sorted(set(lane_seeds) - {C})
        for sc in seeds:
            best = _scan(p, mesh.records[starts[sc]:starts[sc + 1]], best)
            counts["pairs"] += (starts[sc + 1] - starts[sc]) * n
            counts["scanned"] += 1
        # a group skipped under the first chunk's bests is skipped under
        # every later one (the threshold grows with best)
        cand = w.keep(mesh.groups, best, margin)
        counts["sweep_tests"] += G
        for ch in torch.unique(torch.nonzero(cand).flatten() // 32).tolist():
            g0 = 32 * ch
            for j in torch.nonzero(w.keep(mesh.groups[g0:g0 + 32], best,
                                          margin)).flatten().tolist():
                cb, ce = gstarts[g0 + j], gstarts[g0 + j + 1]
                keep = w.keep(mesh.clusters[cb:ce], best, margin)
                keep[[sc - cb for sc in seeds if cb <= sc < ce]] = False
                counts["sweep_tests"] += ce - cb
                for k in torch.nonzero(keep).flatten().tolist():
                    counts["tests"] += n
                    cl = mesh.clusters[cb + k]
                    if bool((~_skip(cl, p, p, best, margin)).any()):
                        b, e = starts[cb + k], starts[cb + k + 1]
                        best = _scan(p, mesh.records[b:e], best)
                        counts["pairs"] += (e - b) * n
                        counts["scanned"] += 1
        out[i0:i0 + n] = torch.sqrt(best[:n])
    return out, counts


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mesh_min_dist_launch.argtypes = [
        ptr, i64, ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, i32,
        ctypes.POINTER(ctypes.c_float), ptr, ptr, ptr]
    lib.mesh_min_dist_launch.restype = ctypes.c_int
    lib.mesh_min_dist_scan_launch.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
    lib.mesh_min_dist_scan_launch.restype = ctypes.c_int
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


def mesh_min_dist(points: torch.Tensor, tris) -> torch.Tensor:
    """Distance [P] of each point [P, 3] to its nearest triangle: ``tris``
    [M, 3, 3] or a :class:`PreparedMesh` (prepared here when not).  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``mesh_min_dist.launches`` counts its launches;
    ``mesh_min_dist.counts`` is the last launch's int64 counts on the
    device, in the order of ``COUNTS``).  P = 0 gives an empty
    tensor and M = 0 +inf, neither with a launch."""
    mesh = tris if isinstance(tris, PreparedMesh) else None
    tris = mesh.tris if mesh is not None else tris
    _check_inputs(points, tris)
    if points.device.type == "cpu":
        return mesh_min_dist_plain(points, tris)
    P, M = points.shape[0], tris.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=points.device)
    if P == 0:
        return out
    if M == 0:
        return out.fill_(float("inf"))
    if mesh is None:
        mesh = prepare_mesh(tris)
    counts = torch.zeros(len(COUNTS), dtype=torch.int64,
                         device=points.device)
    lib = build()
    with torch.cuda.device(points.device):
        err = lib.mesh_min_dist_launch(
            points.data_ptr(), P, mesh.records.data_ptr(),
            mesh.clusters.data_ptr(), mesh.starts.data_ptr(),
            mesh.clusters.shape[0], mesh.groups.data_ptr(),
            mesh.gstarts.data_ptr(), mesh.groups.shape[0],
            mesh.always.data_ptr(),
            mesh.always.shape[0], (ctypes.c_float * 3)(*MARGIN),
            out.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mesh_min_dist launch failed: CUDA error {err}")
    mesh_min_dist.launches += 1
    mesh_min_dist.counts = counts
    return out


mesh_min_dist.launches = 0
mesh_min_dist.counts = None


def mesh_min_dist_scan(points: torch.Tensor, tris) -> torch.Tensor:
    """:func:`mesh_min_dist` by the first kernel (one thread a point over
    every triangle): the yardstick of the cull's time.  CUDA tensors
    only; ``mesh_min_dist_scan.launches`` counts its launches."""
    tris = tris.tris if isinstance(tris, PreparedMesh) else tris
    _check_inputs(points, tris)
    if points.device.type != "cuda":
        raise ValueError("mesh_min_dist_scan runs on CUDA tensors only")
    P, M = points.shape[0], tris.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=points.device)
    if P == 0 or M == 0:
        return out.fill_(float("inf"))
    lib = build()
    with torch.cuda.device(points.device):
        err = lib.mesh_min_dist_scan_launch(
            points.data_ptr(), P, tris.data_ptr(), M, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mesh_min_dist_scan launch failed: CUDA error "
                           f"{err}")
    mesh_min_dist_scan.launches += 1
    return out


mesh_min_dist_scan.launches = 0
