"""The rest of the port's line geometry against the JAX package on random
batches: every line distance through ``compute_distance`` and
``pairwise``, the infinite 2D and 3D line helpers, the essential and
fundamental matrices, known-line and one-point triangulation, the
triangulation covariance, and the segment helpers of ``base/lines.py``.
Tolerance 1e-5 relative (1e-5 absolute near zero) unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.base import infinite_line as jinf
from limap_tpu.base import line_dists as jld
from limap_tpu.base import lines as jlines
from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.lines import Segments as JSeg
from limap_tpu.triangulation import functions as jtri
from limap_tpu_torch.base import infinite_line as pinf
from limap_tpu_torch.base import line_dists as pld
from limap_tpu_torch.base import lines as plines
from limap_tpu_torch.base.camera import CameraViewsBatch as PViews
from limap_tpu_torch.base.lines import Segments as PSeg
from limap_tpu_torch.triangulation import functions as ptri

N = 97


def _close(want, got, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _segs(rng, n, d, depths=False):
    s = rng.normal(size=(n, d)) * 3
    e = s + rng.normal(size=(n, d)) * 2 + 0.3
    extra = {}
    if depths:
        extra["depths"] = (1.0 + rng.uniform(size=(n, 2)) * 4).astype(
            np.float32)
    s, e = s.astype(np.float32), e.astype(np.float32)
    return (JSeg(jnp.asarray(s), jnp.asarray(e),
                 **{k: jnp.asarray(v) for k, v in extra.items()}),
            PSeg(torch.as_tensor(s), torch.as_tensor(e),
                 **{k: torch.as_tensor(v) for k, v in extra.items()}))


def _views(rng, n):
    q = rng.normal(size=(n, 4)) * np.array([1, 0.05, 0.05, 0.05]) \
        + np.array([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(n, 3)) * 0.5
    k = np.tile([600.0, 610.0, 320.0, 240.0], (n, 1))
    arrs = [a.astype(np.float32) for a in (k, q, t)]
    return (JViews(*(jnp.asarray(a) for a in arrs)),
            PViews(*(torch.as_tensor(a) for a in arrs)))


def test_distance_types_agree():
    assert set(pld.DIST_TYPES) == set(jld.DIST_TYPES)


@pytest.mark.parametrize("dist_type", sorted(jld.DIST_TYPES))
@pytest.mark.parametrize("dim", [2, 3])
def test_compute_distance_matches_jax(rng, dist_type, dim):
    j1, p1 = _segs(rng, N, dim, depths=dim == 3)
    j2, p2 = _segs(rng, N, dim, depths=dim == 3)
    if dim == 2 and "scaleinv" in dist_type:
        with pytest.raises(ValueError):
            pld.compute_distance(p1, p2, dist_type)
        return
    want = jld.compute_distance(j1, j2, dist_type)
    got = pld.compute_distance(p1, p2, dist_type)
    # the scale-invariant ratios divide by depths interpolated along the
    # other line, which may pass near zero
    rtol = 1e-4 if "scaleinv" in dist_type else 1e-5
    _close(want, got, rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("dist_type", ["perpendicular", "innerseg",
                                       "endpoints_scaleinv", "overlap_dist"])
def test_pairwise_matches_jax(rng, dist_type):
    j1, p1 = _segs(rng, 11, 3, depths=True)
    j2, p2 = _segs(rng, 7, 3, depths=True)
    got = pld.pairwise(p1, p2, dist_type)
    assert tuple(got.shape) == (11, 7)
    _close(jld.pairwise(j1, j2, dist_type), got, atol=1e-4)


@pytest.mark.parametrize("name", [
    "infinite_dist_perpendicular", "infinite_perpendicular_scaleinv_line3dpp",
    "infinite_dist_perpendicular_scaleinv_line3dpp"])
def test_infinite_distances_match_jax(rng, name):
    j1, p1 = _segs(rng, N, 3, depths=True)
    j2, p2 = _segs(rng, N, 3, depths=True)
    _close(getattr(jld, name)(j1, j2), getattr(pld, name)(p1, p2),
           rtol=1e-4, atol=1e-4)


def test_unknown_distance_raises(rng):
    _, p = _segs(rng, 3, 2)
    with pytest.raises(ValueError):
        pld.compute_distance(p, p, "nope")


def test_infline2d_helpers_match_jax(rng):
    js, ps = _segs(rng, N, 2)
    q = rng.normal(size=(N, 2)).astype(np.float32) * 5
    jc = jinf.infline2d_from_segment(js)
    pc = pinf.infline2d_from_segment(ps)
    _close(jc, pc)
    d = ps.direction()
    _close(jinf.infline2d_from_point_direction(js.start, js.direction()),
           pinf.infline2d_from_point_direction(ps.start, d))
    _close(jinf.infline2d_direction(jc), pinf.infline2d_direction(pc))
    _close(jinf.infline2d_point_projection(jc, jnp.asarray(q)),
           pinf.infline2d_point_projection(pc, torch.as_tensor(q)),
           atol=1e-4)
    _close(jinf.infline2d_point_distance(jc, jnp.asarray(q)),
           pinf.infline2d_point_distance(pc, torch.as_tensor(q)), atol=1e-4)


def test_intersect_infinite_lines_2d_matches_jax(rng):
    j1, p1 = _segs(rng, N, 2)
    j2, p2 = _segs(rng, N, 2)
    jp, jv = jinf.intersect_infinite_lines_2d(j1.coords(), j2.coords())
    pp, pv = pinf.intersect_infinite_lines_2d(p1.coords(), p2.coords())
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    _close(jp, pp, rtol=1e-4, atol=1e-4)


def test_infinite_lines_3d_matches_jax(rng):
    js, ps = _segs(rng, N, 3)
    jo, po = _segs(rng, N, 3)
    q = rng.normal(size=(N, 3)).astype(np.float32) * 4
    jl = jinf.InfiniteLines3d.from_point_direction(js.start, js.end - js.start)
    pl = pinf.InfiniteLines3d.from_point_direction(ps.start, ps.end - ps.start)
    _close(jl.d, pl.d)
    _close(jl.m, pl.m, atol=1e-4)
    _close(jl.point_projection(jnp.asarray(q)),
           pl.point_projection(torch.as_tensor(q)), atol=1e-4)
    _close(jl.point_distance(jnp.asarray(q)),
           pl.point_distance(torch.as_tensor(q)), atol=1e-4)
    jother = jinf.InfiniteLines3d.from_segments(jo)
    pother = pinf.InfiniteLines3d.from_segments(po)
    _close(jl.project_from_infinite_line(jother),
           pl.project_from_infinite_line(pother), rtol=1e-4, atol=1e-3)
    _close(jl.project_to_infinite_line(jother),
           pl.project_to_infinite_line(pother), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_valid", [1, 2, 5, 8])
def test_segment_from_3d_supports_matches_jax(rng, n_valid):
    s = rng.normal(size=(8, 3)).astype(np.float32)
    d = np.array([0.3, 0.9, 0.1], np.float32)
    starts = (s * 0.01 + d * rng.uniform(-2, 0, (8, 1))).astype(np.float32)
    ends = (s * 0.01 + d * rng.uniform(0, 2, (8, 1))).astype(np.float32)
    mask = np.zeros(8, bool)
    mask[rng.permutation(8)[:n_valid]] = True
    jline = jinf.InfiniteLines3d.from_point_direction(
        jnp.zeros(3), jnp.asarray(d))
    pline = pinf.InfiniteLines3d.from_point_direction(
        torch.zeros(3), torch.as_tensor(d))
    want = jinf.segment_from_infinite_line_3d_supports(
        jline, JSeg(jnp.asarray(starts), jnp.asarray(ends)),
        jnp.asarray(mask))
    got = pinf.segment_from_infinite_line_3d_supports(
        pline, PSeg(torch.as_tensor(starts), torch.as_tensor(ends)),
        torch.as_tensor(mask))
    _close(want.start, got.start)
    _close(want.end, got.end)


def test_essential_and_fundamental_match_jax(rng):
    jv1, pv1 = _views(rng, N)
    jv2, pv2 = _views(rng, N)
    _close(jtri.compute_essential_matrix(jv1, jv2),
           ptri.compute_essential_matrix(pv1, pv2), atol=1e-5)
    # F's entries span five orders of magnitude, and t_rel is a small
    # difference of rotated translations: 1e-4 of each matrix's largest
    # entry (3.3e-5 seen)
    want = np.asarray(jtri.compute_fundamental_matrix(jv1, jv2))
    got = ptri.compute_fundamental_matrix(pv1, pv2).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * scale).all()


def _pair(rng, n):
    """Views and the projections of 3D segments 10 m away."""
    jv1, pv1 = _views(rng, n)
    jv2, pv2 = _views(rng, n)
    s = (rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 10.0])).astype(
        np.float32)
    e = (s + rng.normal(size=(n, 3))).astype(np.float32)
    j3, p3 = JSeg(jnp.asarray(s), jnp.asarray(e)), PSeg(torch.as_tensor(s),
                                                        torch.as_tensor(e))
    jl1 = JSeg(jv1.project(j3.start), jv1.project(j3.end))
    jl2 = JSeg(jv2.project(j3.start), jv2.project(j3.end))
    pl1 = PSeg(torch.as_tensor(np.asarray(jl1.start)),
               torch.as_tensor(np.asarray(jl1.end)))
    pl2 = PSeg(torch.as_tensor(np.asarray(jl2.start)),
               torch.as_tensor(np.asarray(jl2.end)))
    return (jv1, jv2, j3, jl1, jl2), (pv1, pv2, p3, pl1, pl2)


def _same_segments(want, got, atol):
    np.testing.assert_array_equal(got.score.numpy() > 0,
                                  np.asarray(want.score) > 0)
    ok = np.asarray(want.score) > 0
    for f in ("start", "end", "depths"):
        _close(np.asarray(getattr(want, f))[ok],
               getattr(got, f).numpy()[ok], rtol=1e-4, atol=atol)


def test_triangulate_with_infinite_line_matches_jax(rng):
    (jv1, _, j3, jl1, _), (pv1, _, p3, pl1, _) = _pair(rng, N)
    want = jtri.triangulate_line_with_infinite_line(
        jl1, jv1, jinf.InfiniteLines3d.from_segments(j3))
    got = ptri.triangulate_line_with_infinite_line(
        pl1, pv1, pinf.InfiniteLines3d.from_segments(p3))
    # rays meeting a line 10 m away: 1e-4 of the depth
    _same_segments(want, got, atol=1e-3)


def test_one_point_2d_matches_jax(rng):
    n = 33
    line = rng.normal(size=(n, 3)).astype(np.float32)
    line[:, 2] = np.abs(line[:, 2]) + 2.0
    p = (rng.normal(size=(n, 2)) + np.array([3.0, 1.0])).astype(np.float32)
    v1 = np.tile(np.array([1.0, 0.0], np.float32), (n, 1))
    v2 = rng.normal(size=(n, 2)).astype(np.float32)
    v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
    jl1, jl2 = jtri.triangulate_line_with_one_point_2d(
        *(jnp.asarray(a) for a in (line, p, v1, v2)))
    pl1, pl2 = ptri.triangulate_line_with_one_point_2d(
        *(torch.as_tensor(a) for a in (line, p, v1, v2)))
    np.testing.assert_array_equal(pl1.numpy() > 0, np.asarray(jl1) > 0)
    # the grid seeds and the Newton steps round differently: 1e-3 of the
    # depths
    _close(jl1, pl1, rtol=1e-3, atol=1e-3)
    _close(jl2, pl2, rtol=1e-3, atol=1e-3)


def test_one_point_triangulation_matches_jax(rng):
    (jv1, jv2, j3, jl1, jl2), (pv1, pv2, p3, pl1, pl2) = _pair(rng, 12)
    want = jtri.triangulate_line_with_one_point(jl1, jv1, jl2, jv2,
                                                j3.midpoint())
    got = ptri.triangulate_line_with_one_point(pl1, pv1, pl2, pv2,
                                               p3.midpoint())
    # the pencil search stops on a flat cost at ~1e-3 of the depth
    _same_segments(want, got, atol=1e-2)
    ok = got.score.numpy() > 0
    assert ok.mean() > 0.8
    assert np.median(np.abs(got.start.numpy() - p3.start.numpy())[ok]) < 0.1


def test_covariance_matches_jax(rng):
    (jv1, jv2, _, jl1, jl2), (pv1, pv2, _, pl1, pl2) = _pair(rng, 9)
    cov = np.eye(8, dtype=np.float32) * 0.25
    want = jtri.line_triangulation_covariance(jl1, jv1, jl2, jv2,
                                              jnp.asarray(cov))
    got = ptri.line_triangulation_covariance(pl1, pv1, pl2, pv2,
                                             torch.as_tensor(cov))
    assert tuple(got.shape) == (9, 6, 6)
    scale = np.abs(np.asarray(want)).max()
    _close(want, got, rtol=1e-3, atol=1e-4 * scale)


def test_segments2d_from_numpy_and_pad(rng):
    arr = rng.normal(size=(5, 5)).astype(np.float32)
    want = jlines.segments2d_from_numpy(arr)
    got = plines.segments2d_from_numpy(arr, device="cpu")
    for f in ("start", "end", "score"):
        _close(getattr(want, f), getattr(got, f), rtol=0, atol=0)
    assert got.dim == 2
    jp, jm = jlines.pad_segments(want, 8, fill=-1.0)
    pp, pm = plines.pad_segments(got, 8, fill=-1.0)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    for f in ("start", "end", "score"):
        _close(getattr(jp, f), getattr(pp, f), rtol=0, atol=0)
    with pytest.raises(ValueError):
        plines.pad_segments(got, 3)
    with pytest.raises(ValueError):
        plines.segments2d_from_numpy(arr[:, :3], device="cpu")
