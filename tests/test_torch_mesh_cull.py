"""Kernel N's cull on the CPU (``ops/mesh_distance.py``): the prepared
mesh (every triangle in exactly one cluster or in the always list, each
cluster's box holding its triangles, the ill-conditioned triangles in the
always list), the margin's bound on the computed distance on points at
the regions' boundaries, and the cull replayed in torch
(``mesh_min_dist_culled``: the kernel's arrays, seed, margin and fp32
order) bit-equal to the plain scan on every seeded case and on the wall
mesh with points over it, beside it and far off."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.evaluation import MeshEvaluator
from limap_tpu_torch.ops import mesh_distance as md
from limap_tpu_torch.testing import evaluation as ev
from torch_threads import two_torch_threads  # noqa: F401

CASES = ev.mesh_cases()


@pytest.fixture(scope="module")
def wall():
    verts, faces = ev.wall_mesh()
    tris = torch.as_tensor(verts[faces])
    return tris, md.prepare_mesh(tris)


def check_prepared(tris, mesh):
    M = len(tris)
    every = torch.cat([mesh.order, mesh.always_index])
    assert torch.equal(torch.sort(every).values, torch.arange(M))
    assert torch.equal(mesh.records, md._records(tris[mesh.order]))
    assert torch.equal(mesh.always, md._records(tris[mesh.always_index]))
    C = len(mesh.clusters)
    starts = mesh.starts.tolist()
    assert starts[0] == 0 and starts[-1] == len(mesh.order)
    assert all(0 < e - b <= md.CLUSTER for b, e in zip(starts, starts[1:]))
    assert len(starts) == C + 1
    t64 = tris.double()
    for c in range(C):
        v = tris[mesh.order[starts[c]:starts[c + 1]]].reshape(-1, 3)
        lo, hi = mesh.clusters[c, 0:3], mesh.clusters[c, 4:7]
        assert bool((v >= lo).all() and (v <= hi).all()), c
        assert torch.equal(lo, v.amin(0)) and torch.equal(hi, v.amax(0))
        t = t64[mesh.order[starts[c]:starts[c + 1]]]
        e = torch.stack([t[:, 1] - t[:, 0], t[:, 2] - t[:, 0],
                         t[:, 2] - t[:, 1]], 1).norm(dim=2)
        area2 = torch.linalg.cross(t[:, 1] - t[:, 0],
                                   t[:, 2] - t[:, 0]).norm(dim=1)
        kappa = e.amax(1) ** 2 / (area2 * e.amin(1))
        # rounded up to fp32 (the float64 recomputation here may differ
        # in its last place)
        assert float(mesh.clusters[c, 3]) >= float(kappa.max()) * (1 - 1e-12)
        assert float(mesh.clusters[c, 7]) >= float(e.max()) * (1 - 1e-12)
        assert float(mesh.clusters[c, 8]) == float(v.abs().max())
    # the clusters follow the Morton curve of the centroids
    t = t64[mesh.order]
    code = md.morton_codes((t[:, 0] + t[:, 1] + t[:, 2]) / 3)
    assert bool((code[1:] >= code[:-1]).all())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_prepared_mesh_partitions_the_triangles(case):
    _, _, t = CASES[case]
    tris = torch.as_tensor(t)
    check_prepared(tris, md.prepare_mesh(tris))


def test_prepared_wall_has_no_always_list(wall):
    tris, mesh = wall
    check_prepared(tris, mesh)
    assert len(mesh.always) == 0
    assert 135_000 / 32 <= len(mesh.clusters) <= 135_000 / 16
    # a group's clusters lie in its box
    gs = mesh.gstarts.tolist()
    for g in range(len(mesh.groups)):
        cl = mesh.clusters[gs[g]:gs[g + 1]]
        assert 0 < len(cl) <= md.GROUP
        assert bool((cl[:, 0:3] >= mesh.groups[g, 0:3]).all()
                    and (cl[:, 4:7] <= mesh.groups[g, 4:7]).all())


def test_ill_conditioned_triangles_are_always_scanned():
    """The seeded cases' repeated vertices (every fifth triangle and its
    two neighbours in the pattern), collinear triangles and 1e-7 slivers
    are all in the always list."""
    for k in (0, 1):
        _, _, t = CASES[k]
        mesh = md.prepare_mesh(torch.as_tensor(t))
        always = set(mesh.always_index.tolist())
        if k == 0:
            bad = [i for i in range(len(t)) if i % 5 in (0, 1, 2)]
        else:
            bad = [i for i in range(len(t)) if i % 4 in (0, 1, 2)]
        assert set(bad) <= always, sorted(set(bad) - always)[:5]


def _margin64(p, lo, hi, kappa, lam, m):
    """delta of the header in float64 for points p [..., 3] and boxes."""
    f = np.maximum(np.abs(hi - p), np.abs(p - lo))
    r = np.linalg.norm(f, axis=-1) + lam
    return md.C_FACE * md.UNIT * r * r * kappa + 8 * md.UNIT * m


@pytest.mark.parametrize("kind", ["random", "flat", "axis-aligned"])
def test_margin_bounds_the_computed_distance(kind):
    """On points at the regions' boundaries (above vertices and edge
    midpoints, nudged across the edges' normal planes by 1e-7..1e-3 of
    their height, at heights over six decades): the plain fp32 distance
    of each well-conditioned triangle is at least its box's float64
    distance less the header's delta."""
    rng = np.random.default_rng({"random": 0, "flat": 1,
                                 "axis-aligned": 2}[kind])
    worst = -np.inf
    for trial in range(6):
        scale = 10.0 ** rng.uniform(-2, 1)
        off = rng.normal(size=3) * 10.0 ** rng.uniform(-1, 1.3)
        t = rng.normal(size=(150, 3, 3)) * scale + off
        if kind != "random":
            t[:, :, 2] = off[2]
        if kind == "axis-aligned":
            t[:, 1] = t[:, 2] = t[:, 0]
            t[:, 1, 0] += rng.uniform(0.5, 1, len(t)) * scale
            t[:, 2, 1] += rng.uniform(0.5, 1, len(t)) * scale
        t32 = torch.as_tensor(t.astype(np.float32))
        mesh = md.prepare_mesh(t32, cluster=1)
        t = t32[mesh.order].double().numpy()
        cl = mesh.clusters.double().numpy()
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        n = np.cross(b - a, c - a)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        L = np.linalg.norm(b - a, axis=1)[:, None]
        pts = []
        for base, d in ((a, b - a), (b, c - b), (c, a - c),
                        ((a + b) / 2, b - a), ((b + c) / 2, c - b)):
            dn = np.cross(n, d)
            dn /= np.linalg.norm(dn, axis=1, keepdims=True)
            for h in 10.0 ** np.arange(-3, 3.5, 1.0):
                for eps in (0, 1e-7, -1e-7, 1e-5, -1e-5, 1e-3, -1e-3):
                    for sgn in (1, -1):
                        pts.append(base + (sgn * h * n + eps * h * dn) * L)
        P = np.stack(pts, 1).astype(np.float32)          # [n, K, 3]
        tt = torch.as_tensor(t.astype(np.float32))
        d = md.point_triangle_distance(torch.as_tensor(P), tt[:, None, 0],
                                       tt[:, None, 1], tt[:, None, 2])
        P64 = P.astype(np.float64)
        lo, hi = cl[:, None, 0:3], cl[:, None, 4:7]
        dbox = np.linalg.norm(np.maximum(0, np.maximum(lo - P64, P64 - hi)),
                              axis=2)
        delta = _margin64(P64, lo, hi, cl[:, None, 3], cl[:, None, 7],
                          cl[:, None, 8])
        worst = max(worst, float(((dbox - d.double().numpy()) / delta)
                                 .max()))
    assert worst <= 1.0, worst


@pytest.mark.parametrize("case", range(len(CASES)))
def test_cull_replay_is_bit_equal_to_the_plain_scan(case):
    _, p, t = CASES[case]
    pt, tt = torch.as_tensor(p), torch.as_tensor(t)
    got, counts = md.mesh_min_dist_culled(pt, md.prepare_mesh(tt))
    assert torch.equal(got, md.mesh_min_dist_plain(pt, tt))
    assert 0 < counts["pairs"] <= len(p) * len(t)


@pytest.mark.parametrize("what", ["over", "beside", "far"])
def test_cull_replay_on_the_wall(wall, what):
    """Bit-equal to the plain scan, and the share of pairs evaluated:
    under 1 % over and beside the wall, under 5 % at 5 m."""
    tris, mesh = wall
    q = ev.wall_samples(what)
    got, counts = md.mesh_min_dist_culled(q, mesh)
    assert torch.equal(got, md.mesh_min_dist_plain(q, tris))
    share = counts["pairs"] / (len(q) * len(tris))
    assert share < (0.05 if what == "far" else 0.01), (share, counts)
    assert counts["scanned"] >= (len(q) + 31) // 32
    assert counts["seed_tests"] >= len(q) * len(mesh.groups)


def test_mesh_evaluator_prepares_the_mesh_once():
    verts, faces = ev.wall_mesh(cell=0.5, jitter=0.1, seed=1)
    mesh = MeshEvaluator(verts, faces, device="cpu")
    assert isinstance(mesh.mesh, md.PreparedMesh)
    assert mesh.mesh.tris is mesh.tris
    q = ev.wall_samples("over")
    assert torch.equal(md.mesh_min_dist(q, mesh.mesh),
                       md.mesh_min_dist_plain(q, mesh.tris))


def test_box_operation_count_is_its_parts():
    assert md.OPS_BOX == sum(md.OPS_BOX_PARTS.values()) == 50
    counts = {"pairs": 1000, "scanned": 3, "tests": 64, "sweep_tests": 40,
              "seed_tests": 7}
    assert md.cull_work(counts) == (1000 * md.OPS_PAIR + 7 * md.OPS_SEED
                                    + (2 * 40 + 64) * md.OPS_BOX)
