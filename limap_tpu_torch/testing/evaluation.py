"""The GT evaluation of chip_smoke.py's phase 13: a triangle mesh of the
rendered scene's wall and float64 references of what the evaluators
compute on it.

The GT lines of ``pipeline.build_scene`` have their midpoints drawn from
``x in [-6, 6], y in [-4.5, 4.5]`` on the plane ``z = WALL_Z``
(``pipeline.py``); :func:`wall_mesh` tessellates that rectangle on a
4 cm grid (300 x 225 cells, 2 triangles a cell, 135,000 triangles) and
moves each inner vertex within the plane by up to 1 cm, so the triangles
are irregular and the surface stays exactly the rectangle.  The distance
of a point to it is then known in closed form (:func:`wall_distance`).
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch.testing.pipeline import WALL_Z

WALL_X = (-6.0, 6.0)
WALL_Y = (-4.5, 4.5)
CELL = 0.04
JITTER = 0.01


def wall_mesh(cell=CELL, jitter=JITTER, seed=0, x=WALL_X, y=WALL_Y,
              z=WALL_Z):
    """(vertices [V, 3] f32, faces [M, 3] int64) of the rectangle ``x`` by
    ``y`` at height ``z``, two triangles a grid cell; the inner vertices
    moved by up to ``jitter`` within the plane (a seeded uniform draw in
    the disc)."""
    nx = int(round((x[1] - x[0]) / cell))
    ny = int(round((y[1] - y[0]) / cell))
    gx, gy = np.meshgrid(np.linspace(x[0], x[1], nx + 1),
                         np.linspace(y[0], y[1], ny + 1), indexing="ij")
    rng = np.random.default_rng(seed)
    r = jitter * np.sqrt(rng.uniform(size=gx.shape))
    phi = rng.uniform(0, 2 * np.pi, size=gx.shape)
    inner = np.zeros(gx.shape, bool)
    inner[1:-1, 1:-1] = True
    gx = np.where(inner, gx + r * np.cos(phi), gx)
    gy = np.where(inner, gy + r * np.sin(phi), gy)
    verts = np.stack([gx, gy, np.full_like(gx, z)], -1).reshape(-1, 3)
    idx = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    v00, v10 = idx[:-1, :-1], idx[1:, :-1]
    v01, v11 = idx[:-1, 1:], idx[1:, 1:]
    faces = np.concatenate([np.stack([v00, v10, v11], -1).reshape(-1, 3),
                            np.stack([v00, v11, v01], -1).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int64)


def wall_distance(points, x=WALL_X, y=WALL_Y, z=WALL_Z):
    """(inside [P] bool, distance [P] f64): whether each point's foot on
    the wall's plane lies in the rectangle, and the point's distance to
    the plane, |z_p - z| (the distance to the wall where ``inside``, a
    lower bound of it elsewhere)."""
    p = np.asarray(points, np.float64)
    inside = ((p[:, 0] >= x[0]) & (p[:, 0] <= x[1]) & (p[:, 1] >= y[0])
              & (p[:, 1] <= y[1]))
    return inside, np.abs(p[:, 2] - z)


def on_wall(points, x=WALL_X, y=WALL_Y, z=WALL_Z):
    """The points [P, 3] that lie on the wall rectangle."""
    p = np.asarray(points)
    inside, dz = wall_distance(p, x, y, z)
    return p[inside & (dz == 0)]


def wall_samples(what, seed=0):
    """[P, 3] f32 samples (64 a segment, consecutive, as the evaluator's)
    of random segments over the wall (``"over"``), beside it
    (``"beside"``) or 5 m in front of it (``"far"``)."""
    rng = np.random.default_rng(seed)
    n, z, xr, yr = {"over": (4, WALL_Z, WALL_X, WALL_Y),
                    "beside": (2, WALL_Z, (6.1, 8.0), WALL_Y),
                    "far": (2, WALL_Z + 5, (-3.0, 3.0), (-3.0, 3.0))}[what]
    s = np.stack([rng.uniform(*xr, n), rng.uniform(*yr, n),
                  z + rng.normal(0, 0.02, n)], 1)
    e = s + rng.normal(0, 0.5, (n, 3)) * [1, 1, 0.05]
    t = np.linspace(0, 1, 64)[None, :, None]
    return torch.as_tensor((s[:, None] + t * (e - s)[:, None])
                           .reshape(-1, 3).astype(np.float32))


def refline_f64(ref_lines, lines, taus, n_samples=1000, chunk=1 << 22):
    """Float64 numpy counterparts of ``RefLineEvaluator``: (the reference
    lines' summed length, {tau: the reference length within tau of the
    predicted lines}), each reference line sampled at ``n_samples``
    points and each sample's distance to the nearest predicted segment
    (the foot clamped to it; a squared length below 1e-12 taken as
    1e-12)."""
    ref = np.asarray(ref_lines, np.float64).reshape(-1, 2, 3)
    pred = np.asarray(lines, np.float64).reshape(-1, 2, 3)
    lengths = np.linalg.norm(ref[:, 1] - ref[:, 0], axis=1)
    if len(pred) == 0 or len(ref) == 0:
        return float(lengths.sum()), {tau: 0.0 for tau in taus}
    t = np.linspace(0.0, 1.0, n_samples)
    samples = (ref[:, None, 0] + t[None, :, None]
               * (ref[:, None, 1] - ref[:, None, 0])).reshape(-1, 3)
    a, d = pred[:, 0], pred[:, 1] - pred[:, 0]
    L2 = np.maximum((d * d).sum(1), 1e-12)
    step = max(1, chunk // len(pred))
    best = np.empty(len(samples))
    for i in range(0, len(samples), step):
        disp = samples[i:i + step, None] - a[None]
        s = np.clip((disp * d[None]).sum(-1) / L2[None], 0.0, 1.0)
        off = disp - s[..., None] * d[None]
        best[i:i + step] = np.sqrt((off * off).sum(-1)).min(1)
    best = best.reshape(len(ref), n_samples)
    return float(lengths.sum()), {
        tau: float(((best <= tau).mean(1) * lengths).sum()) for tau in taus}


def region_points(a, b, c, lift=0.3):
    """Points [14, 3] whose nearest feature of the triangle (a, b, c) is
    each of its seven regions in turn: off each vertex, edge and the face
    (outward in the plane and lifted by ``lift``), and right above or
    below each."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    g = (a + b + c) / 3
    n = np.cross(b - a, c - a)
    n = n / max(np.linalg.norm(n), 1e-12)
    pts = []
    for base in (a, b, c, (a + b) / 2, (a + c) / 2, (b + c) / 2, g):
        pts.append(base + 0.7 * (base - g) + lift * n)
        pts.append(base - 0.5 * lift * n)
    return np.asarray(pts)


def mesh_cases(seed=0):
    """Seeded inputs of the mesh distance, as (name, points [P, 3] f32,
    triangles [M, 3, 3] f32): random triangles among which two or three
    vertices are repeated (the products of a zero edge are exact zeros);
    random triangles among which degenerate ones whose float32 value
    hangs on the last bits of the arithmetic (three vertices on a line,
    exactly in dyadic coordinates or up to rounding, and slivers of 1e-7
    m: the region's tests compare rounding noise with 0); points in each of the
    seven regions of a triangle at three scales and offsets (one as the
    wall's 4 cm cells at 10 m); ragged sizes around the kernel's tile of
    256 and the scan's chunk of 2048."""
    rng = np.random.default_rng(seed)
    exact = rng.normal(size=(500, 3, 3))
    exact[::5, 1] = exact[::5, 0]
    exact[1::5, 1:] = exact[1::5, :1]
    exact[2::5, 2] = exact[2::5, 1]
    near = np.round(rng.normal(size=(500, 3, 3)) * 64) / 64
    near[::4, 2] = 3 * near[::4, 1] - 2 * near[::4, 0]
    near[2::4, 2] = near[2::4, 0] + 0.5 * (near[2::4, 1] - near[2::4, 0])
    near[1::4, 2] = near[1::4, 0] + 1e-7 * rng.normal(size=(len(near[1::4]),
                                                            3))
    out = [("random with repeated vertices",
            rng.normal(size=(700, 3)) * 1.5, exact),
           ("random with collinear vertices and slivers",
            rng.normal(size=(700, 3)) * 1.5, near)]
    a, b, c = np.zeros(3), np.eye(3)[0], np.eye(3)[1]
    for scale, offset in ((1.0, 0.0), (0.04, 10.0), (3.0, -5.0)):
        t = np.stack([a, b, c])[None] * scale + offset
        out.append((f"seven regions, scale {scale}, offset {offset}",
                    region_points(*t[0]), t))
    for P, M in ((1, 1), (300, 255), (257, 256), (513, 257), (1000, 2049)):
        out.append((f"ragged {P} x {M}", rng.normal(size=(P, 3)),
                    rng.normal(size=(M, 3, 3))))
    return [(n, np.asarray(p, np.float32), np.asarray(t, np.float32))
            for n, p, t in out]
