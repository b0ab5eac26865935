"""The port's geometry layer against the JAX package on random batches:
projection, uncertainty, sensitivity, the linkers, the two-view
triangulators, minimal lines and the segment re-trim."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.base import line_geometry as jlg
from limap_tpu.base import line_linker as jll
from limap_tpu.base import pose as jpose
from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.infinite_line import (
    InfiniteLines3d as JInf, MinimalInfiniteLines3d as JMin,
    segment_from_infinite_line_2d_supports as jtrim)
from limap_tpu.base.lines import Segments as JSeg
from limap_tpu.triangulation import functions as jtri
from limap_tpu_torch.base import line_geometry as plg
from limap_tpu_torch.base import line_linker as pll
from limap_tpu_torch.base import pose as ppose
from limap_tpu_torch.base.camera import CameraViewsBatch as PViews
from limap_tpu_torch.base.infinite_line import (
    InfiniteLines3d as PInf, MinimalInfiniteLines3d as PMin,
    segment_from_infinite_line_2d_supports as ptrim)
from limap_tpu_torch.base.lines import Segments as PSeg
from limap_tpu_torch.triangulation import functions as ptri

N = 257


def _views(rng, n):
    q = rng.normal(size=(n, 4)) * np.array([1, 0.05, 0.05, 0.05]) \
        + np.array([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(n, 3)) * 0.5
    k = np.tile([600.0, 610.0, 320.0, 240.0], (n, 1))
    return [a.astype(np.float32) for a in (k, q, t)]


def _segs3d(rng, n, jitter=0.0, base=None):
    if base is None:
        s = rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 10.0])
        e = s + rng.normal(size=(n, 3))
    else:
        s, e = base
        s = s + rng.normal(size=s.shape) * jitter
        e = e + rng.normal(size=e.shape) * jitter
    return s.astype(np.float32), e.astype(np.float32)


def _both_views(arrs):
    return (JViews(*(jnp.asarray(a) for a in arrs)),
            PViews(*(torch.as_tensor(a) for a in arrs)))


def _both_segs(s, e, **extra):
    j = JSeg(jnp.asarray(s), jnp.asarray(e),
             **{k: jnp.asarray(v) for k, v in extra.items()})
    p = PSeg(torch.as_tensor(s), torch.as_tensor(e),
             **{k: torch.as_tensor(v) for k, v in extra.items()})
    return j, p


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(b.numpy() if hasattr(b, "numpy")
                                          else b), np.asarray(a),
                               rtol=rtol, atol=atol)


@pytest.fixture()
def scene(rng):
    jv, pv = _both_views(_views(rng, N))
    s, e = _segs3d(rng, N)
    return rng, jv, pv, (s, e)


def test_pose_helpers(rng):
    q = rng.normal(size=(N, 4)).astype(np.float32)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    jq, pq = jnp.asarray(q), torch.as_tensor(q)
    _close(jpose.quat_to_rotmat(jq), ppose.quat_to_rotmat(pq), atol=1e-6)
    R = np.array(jpose.quat_to_rotmat(jq))
    _close(jpose.rotmat_to_quat(jnp.asarray(R)),
           ppose.rotmat_to_quat(torch.as_tensor(R)), atol=1e-6)
    _close(jpose.quat_rotate(jq, jnp.asarray(v)),
           ppose.quat_rotate(pq, torch.as_tensor(v)), atol=1e-5)
    _close(jpose.quat_multiply(jq, jq[::-1]),
           ppose.quat_multiply(pq, pq.flip(0)), atol=1e-6)
    aa = (v * 0.1).astype(np.float32)
    aa[0] = 0.0  # the small-angle series branch
    _close(jpose.axis_angle_to_quat(jnp.asarray(aa)),
           ppose.axis_angle_to_quat(torch.as_tensor(aa)), atol=1e-7)


def test_project_uncertainty_sensitivity(scene):
    rng, jv, pv, (s, e) = scene
    js, ps = _both_segs(s, e)
    jp, pp = jlg.project_segments(js, jv), plg.project_segments(ps, pv)
    # pixels at f = 600: fp32 rounding of the division by depth
    _close(jp.start, pp.start, rtol=1e-5, atol=1e-3)
    _close(jp.end, pp.end, rtol=1e-5, atol=1e-3)
    _close(jlg.compute_uncertainty(js, jv, 2.0),
           plg.compute_uncertainty(ps, pv, 2.0), rtol=1e-5, atol=1e-7)
    # degrees via arccos: ill-conditioned near 90 deg, 1e-3 deg suffices
    _close(jlg.sensitivity(js, jv), plg.sensitivity(ps, pv), atol=1e-3)


@pytest.mark.parametrize("jitter", [0.01, 0.05, 0.2])
def test_score_3d_and_check_3d(scene, jitter):
    rng, _, _, (s, e) = scene
    s2, e2 = _segs3d(rng, N, jitter, (s, e))
    u1 = rng.uniform(0.01, 0.1, N).astype(np.float32)
    u2 = rng.uniform(0.01, 0.1, N).astype(np.float32)
    dep1 = rng.uniform(5, 15, (N, 2)).astype(np.float32)
    dep2 = rng.uniform(5, 15, (N, 2)).astype(np.float32)
    j1, p1 = _both_segs(s, e, uncertainty=u1, depths=dep1)
    j2, p2 = _both_segs(s2, e2, uncertainty=u2, depths=dep2)
    base = jll.LineLinker3dConfig(th_angle=10.0, th_overlap=0.05,
                                  th_smartoverlap=0.1, th_smartangle=2.0,
                                  th_perp=1.0, th_innerseg=1.0,
                                  th_scaleinv=0.015)
    pbase = pll.LineLinker3dConfig(**vars(base))
    for jc, pc in ((base, pbase),
                   (base.to_shared_parent_scoring(),
                    pbase.to_shared_parent_scoring()),
                   (base.to_spatial_merging(), pbase.to_spatial_merging())):
        # exp of squared distances: 1e-5 absolute on scores in [0, 1]
        _close(jll.score_3d(j1, j2, jc), pll.score_3d(p1, p2, pc), atol=1e-5)
        np.testing.assert_array_equal(pll.check_3d(p1, p2, pc).numpy(),
                                      np.asarray(jll.check_3d(j1, j2, jc)))


@pytest.mark.parametrize("jitter", [0.5, 2.0, 8.0])
def test_score_2d(rng, jitter):
    s = rng.uniform(0, 600, (N, 2)).astype(np.float32)
    e = (s + rng.normal(size=(N, 2)) * 80).astype(np.float32)
    s2 = (s + rng.normal(size=(N, 2)) * jitter).astype(np.float32)
    e2 = (e + rng.normal(size=(N, 2)) * jitter).astype(np.float32)
    j1, p1 = _both_segs(s, e)
    j2, p2 = _both_segs(s2, e2)
    for kw in ({}, dict(th_angle=5.0, th_perp=2.0, th_overlap=0.05),
               dict(use_innerseg=True)):
        jc, pc = jll.LineLinker2dConfig(**kw), pll.LineLinker2dConfig(**kw)
        _close(jll.score_2d(j1, j2, jc), pll.score_2d(p1, p2, pc), atol=1e-5)


def test_pairwise_broadcasting(scene):
    rng, _, _, (s, e) = scene
    n = 16
    j1, p1 = _both_segs(s[:n], e[:n], depths=np.ones((n, 2), np.float32) * 9)
    ex = lambda seg, ax: type(seg)(*(None if x is None else
                                     (jnp.expand_dims(x, ax)
                                      if isinstance(seg, JSeg)
                                      else x.unsqueeze(ax)) for x in seg))
    cfg = jll.LineLinker3dConfig().to_shared_parent_scoring()
    pcfg = pll.LineLinker3dConfig().to_shared_parent_scoring()
    a = jll.score_3d(ex(j1, 1), ex(j1, 0), cfg)
    b = pll.score_3d(p1.expand(1), p1.expand(0), pcfg)
    assert b.shape == (n, n)
    _close(a, b, atol=1e-5)


def _two_view_problem(rng):
    """l1, l2: projections of the same 3D segments in two views, with
    pixel noise."""
    k1, q1, t1 = _views(rng, N)
    k2, q2, t2 = _views(rng, N)
    t2 = t2 + np.array([0.5, 0.0, 0.0], np.float32)
    s, e = _segs3d(rng, N)
    jv1, pv1 = _both_views((k1, q1, t1))
    jv2, pv2 = _both_views((k2, q2, t2))
    js, _ = _both_segs(s, e)
    noise = lambda x: (np.asarray(x) + rng.normal(size=x.shape) * 0.3
                       ).astype(np.float32)
    l1 = jlg.project_segments(js, jv1)
    l2 = jlg.project_segments(js, jv2)
    l1 = (noise(l1.start), noise(l1.end))
    l2 = (noise(l2.start), noise(l2.end))
    return (_both_segs(*l1), jv1, pv1, _both_segs(*l2), jv2, pv2)


@pytest.mark.parametrize("name", ["triangulate_line_algebraic",
                                  "triangulate_line_by_endpoints"])
def test_two_view_triangulation(rng, name):
    (jl1, pl1), jv1, pv1, (jl2, pl2), jv2, pv2 = _two_view_problem(rng)
    jf, pf = getattr(jtri, name), getattr(ptri, name)
    jt, pt = jf(jl1, jv1, jl2, jv2), pf(pl1, pv1, pl2, pv2)
    np.testing.assert_array_equal(pt.score.numpy(), np.asarray(jt.score))
    ok = np.asarray(jt.score) > 0
    assert ok.mean() > 0.5
    # 3D points ~10 m away from a 0.5 m baseline: fp32 ray rounding is
    # amplified ~depth/baseline; 1e-3 relative
    _close(np.asarray(jt.start)[ok], pt.start.numpy()[ok], rtol=1e-3,
           atol=1e-3)
    _close(np.asarray(jt.end)[ok], pt.end.numpy()[ok], rtol=1e-3, atol=1e-3)
    _close(np.asarray(jt.depths)[ok], pt.depths.numpy()[ok], rtol=1e-3,
           atol=1e-3)


def test_epipolar_iou_and_normal(rng):
    (jl1, pl1), jv1, pv1, (jl2, pl2), jv2, pv2 = _two_view_problem(rng)
    _close(jtri.compute_epipolar_iou(jl1, jv1, jl2, jv2),
           ptri.compute_epipolar_iou(pl1, pv1, pl2, pv2), atol=1e-4)
    _close(jtri.get_normal_direction(jl2, jv2),
           ptri.get_normal_direction(pl2, pv2), atol=1e-5)
    lo = np.array([-3, -3, 5], np.float32)
    hi = np.array([3, 3, 14], np.float32)
    jt = jtri.triangulate_line_algebraic(jl1, jv1, jl2, jv2)
    pt = ptri.triangulate_line_algebraic(pl1, pv1, pl2, pv2)
    np.testing.assert_array_equal(
        ptri.test_line_inside_ranges(pt, (torch.as_tensor(lo),
                                          torch.as_tensor(hi))).numpy(),
        np.asarray(jtri.test_line_inside_ranges(jt, (jnp.asarray(lo),
                                                     jnp.asarray(hi)))))


def test_minimal_lines_and_projection(scene):
    rng, jv, pv, (s, e) = scene
    js, ps = _both_segs(s, e)
    jm, pm = JMin.from_segments(js), PMin.from_segments(ps)
    # the quaternion's sign is fixed (w >= 0) so the fields compare
    _close(jm.uvec, pm.uvec, atol=1e-5)
    _close(jm.wvec, pm.wvec, atol=1e-5)
    ji, pi = jm.to_plucker(), pm.to_plucker()
    _close(ji.d, pi.d, atol=1e-5)
    _close(ji.m, pi.m, rtol=1e-4, atol=1e-4)
    _close(ji.projection(jv), pi.projection(pv), atol=1e-5)


def test_segment_from_infinite_line_2d_supports(rng):
    T, S = 6, 9
    views = _views(rng, T * S)
    jv, pv = _both_views([a.reshape(T, S, -1) for a in views])
    s, e = _segs3d(rng, T)
    js, ps = _both_segs(s, e)
    l2 = jlg.project_segments(
        JSeg(js.start[:, None], js.end[:, None]), jv)
    st = (np.asarray(l2.start) + rng.normal(size=(T, S, 2)) * 0.5
          ).astype(np.float32)
    en = (np.asarray(l2.end) + rng.normal(size=(T, S, 2)) * 0.5
          ).astype(np.float32)
    mask = rng.uniform(size=(T, S)) < 0.7
    mask[0, 1:] = False          # one support: the trim is clamped
    jl2, pl2 = _both_segs(st, en)
    jinf, pinf = JInf.from_segments(js), PInf.from_segments(ps)
    out = ptrim(pinf, pv, pl2, torch.as_tensor(mask), 2)
    for t in range(T):
        ref = jtrim(JInf(jinf.d[t], jinf.m[t]),
                    JViews(jv.kvec[t], jv.qvec[t], jv.tvec[t]),
                    JSeg(jl2.start[t], jl2.end[t]), jnp.asarray(mask[t]), 2)
        # unprojected endpoints ~10 m away: 1e-4 relative
        _close(ref.start, out.start[t], rtol=1e-4, atol=1e-4)
        _close(ref.end, out.end[t], rtol=1e-4, atol=1e-4)
