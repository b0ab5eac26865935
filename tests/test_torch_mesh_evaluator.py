"""The port's mesh distance against the JAX package's on the same numpy
inputs, on the CPU: ``point_triangle_distance`` (points in all seven
regions, degenerate triangles), the plain scan ``mesh_min_dist_plain``
against ``_min_dist_to_mesh`` (M not a multiple of the 2048-triangle
chunk, M = 0, P = 1), ``MeshEvaluator``'s three methods, the wall mesh of
chip_smoke's phase 13 against its analytic distance, and the wrapper's
rules.  Distances within 1e-5 m: both sides compute the same fp32
formulas; rounding order, and the CPU's float32 square root (torch's
is not always correctly rounded there), differ by an ulp or so.  Kernel
N itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.evaluation import mesh_evaluator as jme
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.evaluation import MeshEvaluator, point_triangle_distance
from limap_tpu_torch.ops import cuda_build
from limap_tpu_torch.ops import mesh_distance as md
from limap_tpu_torch.testing import evaluation as ev

TOL = 1e-5
CASES = ev.mesh_cases()


@pytest.fixture(scope="module", autouse=True)
def warm_torch():
    """One pass of the formula before any comparison: on this CPU the
    first elementwise passes of a fresh process were seen to round
    otherwise than the later ones (one call in five to eight, amplified
    on degenerate triangles), and the comparisons here are of the
    formula."""
    _, p, t = CASES[0]
    point_triangle_distance(*map(torch.as_tensor, [p[:, None]] + [
        t[None, :, k] for k in range(3)]))


@pytest.mark.parametrize("case", [0, 2, 3, 4])
def test_point_triangle_distance_against_jax(case):
    """Every point against every triangle, against JAX's formula run op
    by op: random triangles with two or three vertices repeated (each
    guard sees an exact 0) and the seven regions at three scales and
    offsets.  (Collinear triangles and slivers: below.)"""
    _, p, t = CASES[case]
    args = [p[:, None]] + [t[None, :, k] for k in range(3)]
    got = point_triangle_distance(*map(torch.as_tensor, args)).numpy()
    ref = np.asarray(jme.point_triangle_distance(*map(jnp.asarray, args)))
    assert got.shape == (len(p), len(t)) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_seven_regions_have_their_closed_form_distances():
    """The region points of a unit right triangle at the origin: the
    distance to its vertex, edge or face, in float64 (1e-6 m)."""
    _, p, t = CASES[2]
    a, b, c = t[0].astype(np.float64)
    got = point_triangle_distance(*map(torch.as_tensor, (
        p, t[0, 0], t[0, 1], t[0, 2]))).numpy()

    def to_segment(x, u, v):
        s = np.clip((x - u) @ (v - u) / ((v - u) @ (v - u)), 0, 1)
        return np.linalg.norm(x - (u + s * (v - u)))

    p = p.astype(np.float64)
    want = [np.linalg.norm(p[0] - a), np.linalg.norm(p[1] - a),
            np.linalg.norm(p[2] - b), np.linalg.norm(p[3] - b),
            np.linalg.norm(p[4] - c), np.linalg.norm(p[5] - c),
            to_segment(p[6], a, b), to_segment(p[7], a, b),
            to_segment(p[8], a, c), to_segment(p[9], a, c),
            to_segment(p[10], b, c), to_segment(p[11], b, c),
            abs(p[12, 2]), abs(p[13, 2])]
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("case", range(2, len(CASES)))
def test_plain_scan_against_jax(case):
    """The plain scan (small chunks, so it runs many steps) against the
    JAX program's chunked scan (degenerate triangles: below)."""
    _, p, t = CASES[case]
    got = md.mesh_min_dist_plain(torch.as_tensor(p), torch.as_tensor(t),
                                 chunk=64, pair_budget=64 * 37).numpy()
    ref = np.asarray(jme._min_dist_to_mesh(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_repeated_vertices_follow_float64_where_jax_jit_errs():
    """With a repeated vertex an edge is exactly 0 and so are its
    products: the plain scan gives the formula's float64 answer (1e-5 m)
    and so does JAX's formula run op by op, while the jitted JAX program,
    whose fused multiply-adds leave the rounding error of a product where
    the difference of two equal products is 0, misses it by more than
    5 cm on some points: the port does not follow JAX there."""
    _, p, t = CASES[0]
    got = md.mesh_min_dist_plain(torch.as_tensor(p), torch.as_tensor(t))
    f64 = md.mesh_min_dist_plain(torch.as_tensor(p).double(),
                                 torch.as_tensor(t).double()).numpy()
    np.testing.assert_allclose(got.numpy(), f64, atol=TOL)
    eager = np.asarray(jme.point_triangle_distance(
        jnp.asarray(p)[:, None], *[jnp.asarray(t)[None, :, k]
                                   for k in range(3)]).min(1))
    np.testing.assert_allclose(eager, f64, atol=TOL)
    jit = np.asarray(jme._min_dist_to_mesh(jnp.asarray(p), jnp.asarray(t)))
    assert np.abs(jit - f64).max() > 0.05


def test_collinear_triangles_and_slivers_are_ill_conditioned():
    """On three vertices on a line (exactly, or up to rounding) and on
    slivers, the region's tests compare rounding noise with 0 and a
    guarded division may land far away, so the formula's float32 value
    hangs on the order of its operations: float64 moves it by more than
    1 cm, the jitted JAX program by more.  The plain scan stays finite;
    kernel N repeats it bit for bit on the card (same operations in the
    same order: tests/test_torch_cuda.py, chip_smoke.py phase 2)."""
    _, p, t = CASES[1]
    got = md.mesh_min_dist_plain(torch.as_tensor(p), torch.as_tensor(t))
    f64 = md.mesh_min_dist_plain(torch.as_tensor(p).double(),
                                 torch.as_tensor(t).double()).numpy()
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - f64).max() > 0.01


@pytest.mark.parametrize("P,M", [(1, 4100), (200, 2049), (37, 0), (0, 5)])
def test_plain_scan_sizes(P, M):
    """M not a multiple of 2048 (JAX pads with triangles at 1e9), M = 0
    (+inf, JAX's init), P = 1 and P = 0; the plain scan's own chunks
    change nothing."""
    rng = np.random.default_rng(P + M)
    p = rng.normal(size=(P, 3)).astype(np.float32) * 2
    t = rng.normal(size=(M, 3, 3)).astype(np.float32) * 2
    got = md.mesh_min_dist(torch.as_tensor(p), torch.as_tensor(t)).numpy()
    ref = np.asarray(jme._min_dist_to_mesh(jnp.asarray(p), jnp.asarray(t)))
    assert got.shape == (P,)
    if M == 0:
        assert np.isinf(got).all() and np.isinf(ref).all()
    else:
        np.testing.assert_allclose(got, ref, atol=TOL)
        small = md.mesh_min_dist_plain(torch.as_tensor(p), torch.as_tensor(t),
                                       chunk=100, pair_budget=700).numpy()
        np.testing.assert_array_equal(small, got)


def test_mesh_evaluator_against_jax():
    """ComputeDistPoint, ComputeDistsLine and ComputeInlierRatio on a
    small jittered wall mesh and lines around it."""
    verts, faces = ev.wall_mesh(cell=0.6, jitter=0.1, seed=3)
    rng = np.random.default_rng(3)
    s = np.stack([rng.uniform(-7, 7, 8), rng.uniform(-5, 5, 8),
                  10 + rng.normal(0, 0.5, 8)], 1)
    lines = np.stack([s, s + rng.normal(0, 0.8, (8, 3))], 1) \
        .astype(np.float32)
    mesh = MeshEvaluator(verts, faces, device="cpu")
    jmesh = jme.MeshEvaluator(verts, faces)
    for p in lines[:3, 0]:
        assert abs(mesh.ComputeDistPoint(p) - jmesh.ComputeDistPoint(p)) \
            < TOL
    seg = Segments(torch.as_tensor(lines[:, 0]), torch.as_tensor(lines[:, 1]))
    jseg = JSegments(jnp.asarray(lines[:, 0]), jnp.asarray(lines[:, 1]))
    d = mesh.ComputeDistsLine(seg, 100).numpy()
    np.testing.assert_allclose(
        d, np.asarray(jmesh.ComputeDistsLine(jseg, 100)), atol=TOL)
    for tau in (0.05, 0.3):
        got = mesh.ComputeInlierRatio(seg, tau, 100).numpy()
        ref = np.asarray(jmesh.ComputeInlierRatio(jseg, tau, 100))
        # the same samples within tau (ratios may round an ulp apart)
        np.testing.assert_array_equal(np.round(got * 100), np.round(ref * 100))


def test_wall_mesh_and_its_analytic_distance():
    """The wall of phase 13 on a coarse grid: it covers the rectangle
    (areas sum to 12 m x 9 m, every vertex at WALL_Z), the jitter stays
    within its bound, and the mesh distance of points over the wall is
    their height above it, beside it at least that (1e-5 m)."""
    verts, faces = ev.wall_mesh(cell=0.5, jitter=0.1, seed=1)
    tri = verts[faces].astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                         tri[:, 2] - tri[:, 0]), axis=1)
    assert faces.shape == (2 * 24 * 18, 3)
    assert abs(area.sum() - 108.0) < 1e-6 and (area > 0.05).all()
    assert (verts[:, 2] == ev.WALL_Z).all()
    full, _ = ev.wall_mesh()
    assert ev.wall_mesh()[1].shape == (135_000, 3)
    grid = np.stack(np.meshgrid(np.linspace(-6, 6, 301),
                                np.linspace(-4.5, 4.5, 226), indexing="ij"),
                    -1).reshape(-1, 2)
    assert np.abs(full[:, :2] - grid).max() <= ev.JITTER + 1e-6
    rng = np.random.default_rng(4)
    p = np.stack([rng.uniform(-7, 7, 500), rng.uniform(-5.5, 5.5, 500),
                  10 + rng.normal(0, 0.5, 500)], 1).astype(np.float32)
    d = md.mesh_min_dist(torch.as_tensor(p),
                         torch.as_tensor(verts[faces])).double().numpy()
    inside, dz = ev.wall_distance(p)
    assert inside.any() and (~inside).any()
    assert np.abs(d[inside] - dz[inside]).max() <= TOL
    assert (d[~inside] >= dz[~inside] - TOL).all()
    cloud = np.array([[0, 0, 10.0], [7, 0, 10.0], [0, 0, 10.5]], np.float32)
    np.testing.assert_array_equal(ev.on_wall(cloud), cloud[:1])


def test_cpu_tensors_take_the_plain_scan_without_a_launch():
    _, p, t = CASES[0]
    n0 = md.mesh_min_dist.launches
    got = md.mesh_min_dist(torch.as_tensor(p), torch.as_tensor(t))
    assert md.mesh_min_dist.launches == n0
    assert torch.equal(got, md.mesh_min_dist_plain(torch.as_tensor(p),
                                                   torch.as_tensor(t)))


@pytest.mark.parametrize("bad", ["dtype", "points", "tris", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    p = torch.zeros((4, 3))
    t = torch.zeros((5, 3, 3))
    if bad == "dtype":
        p = p.double()
    elif bad == "points":
        p = torch.zeros((4, 2))
    elif bad == "tris":
        t = torch.zeros((5, 9))
    else:
        p = torch.zeros((3, 4))[:, :3]
    with pytest.raises((TypeError, ValueError)):
        md.mesh_min_dist(p, t)


def test_no_fallback_when_build_fails(monkeypatch, tmp_path):
    """Without nvcc kernel N's build raises; nothing runs the plain
    version in its place."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    cuda_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            md.build()
    finally:
        cuda_build.load_library.cache_clear()


def test_operation_count_is_its_parts():
    assert md.OPS_PAIR == sum(md.OPS_PAIR_PARTS.values()) == 122


def test_mesh_evaluator_raises_without_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces = ev.wall_mesh(cell=3.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshEvaluator(verts, faces)
    assert MeshEvaluator(verts, faces, device="cpu").tris.shape == (
        len(faces), 3, 3)
