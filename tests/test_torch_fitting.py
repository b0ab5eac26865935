"""The port's depth fitting against the JAX package's on the same numpy
inputs: the sample grid and depths, the lifted points, the median
threshold, and the RANSAC with the hypotheses JAX draws (recomputed here
from its key as fit_lines_ransac draws them).  A fitted segment's TLS
axis has no fixed sign, so endpoints are compared up to order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from limap_tpu.base.camera import Camera as JCamera
from limap_tpu.base.camera import CameraPose as JPose
from limap_tpu.base.camera import CameraView as JView
from limap_tpu.base.camera import CameraViewsBatch as JViews
from limap_tpu.base.lines import Segments as JSegments
from limap_tpu.fitting import fitting as jfit
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.fitting import fitting
from limap_tpu_torch.ops.line_ransac import line_ransac
from torch_threads import two_torch_threads  # noqa: F401

t = lambda x, dtype=None: torch.as_tensor(np.array(x), dtype=dtype)


def jax_hypotheses(key, N, S, H):
    """idx_a, idx_b as limap_tpu.fitting.fit_lines_ransac draws them."""
    k1, k2 = jax.random.split(key)
    idx_a = jax.random.randint(k1, (N, H), 0, S)
    idx_b = jax.random.randint(k2, (N, H), 0, S)
    idx_b = jnp.where(idx_b == idx_a, (idx_b + 1) % S, idx_b)
    return np.asarray(idx_a, np.int32), np.asarray(idx_b, np.int32)


def jax_best(points, valid, th, idx_a, idx_b):
    """The JAX program's best hypothesis and inlier mask
    (fitting.py:100-110), recomputed with its own distance."""
    rows = np.arange(len(points))[:, None]
    p = jnp.asarray(points)
    dist = jfit._point_line_dist(p[:, None], p[rows, idx_a], p[rows, idx_b])
    is_in = (dist <= jnp.asarray(th)[:, None, None]) & valid[:, None, :]
    counts = jnp.where(valid[rows, idx_a] & valid[rows, idx_b],
                       jnp.sum(is_in, -1), -1)
    best = np.asarray(jnp.argmax(counts, -1))
    return best, np.asarray(is_in)[np.arange(len(points)), best]


def assert_segments_close(a_start, a_end, b_start, b_end, atol):
    a = np.stack([a_start, a_end], 1)
    b = np.stack([b_start, b_end], 1)
    err = np.minimum(np.abs(a - b).max((1, 2)),
                     np.abs(a[:, ::-1] - b).max((1, 2)))
    assert err.max(initial=0.0) <= atol, err.max()


def assert_matches_jax_fit(out, ref):
    """The same accepted rows and scores, endpoints within 0.1 mm (8 m
    away).  Rows that sample the depth map's NaN band come out NaN from
    JAX (a masking product carries the invalid sample's NaN point) and
    finite from the port; they are compared on their scores only."""
    score = np.asarray(ref.score)
    np.testing.assert_allclose(out.score.numpy(), score, rtol=1e-6)
    assert (score > 0).sum() > 30
    poisoned = np.isnan(np.asarray(ref.start)).any(1)
    assert poisoned.sum() > 3
    assert np.isfinite(out.start.numpy()).all()
    keep = ~poisoned
    assert_segments_close(out.start.numpy()[keep], out.end.numpy()[keep],
                          np.asarray(ref.start)[keep],
                          np.asarray(ref.end)[keep], 1e-4)


def test_sample_grid_is_jax_linspace_bit_for_bit():
    for n in (1, 2, 3, 7, 63, 64, 65, 100, 1000):
        ours = fitting.sample_grid(n, "cpu").numpy()
        assert np.array_equal(ours, np.asarray(jnp.linspace(0.0, 1.0, n))), n
    # torch.linspace rounds otherwise, which is why the port does not use it
    assert not np.array_equal(torch.linspace(0, 1, 64).numpy(),
                              np.asarray(jnp.linspace(0.0, 1.0, 64)))


def camera_view(rng, hw=(120, 160), f=150.0):
    K = np.array([[f, 0, hw[1] / 2], [0, f * 1.01, hw[0] / 2], [0, 0, 1]])
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
    tvec = rng.normal(size=3) * 0.3
    jv = JViews.from_views([JView(JCamera(K=K, hw=hw), JPose(R=R, tvec=tvec))])
    view = CameraViewsBatch(*(t(np.asarray(x)[0]) for x in jv))
    return JViews(*(x[0] for x in jv)), view, K, R, tvec


def plane_depth(K, R, tvec, hw, rng, noise=1e-3, z=8.0):
    """Depth of the plane z = ``z`` with noise; a corner reads 0 and a
    band NaN (invalid samples)."""
    H, W = hw
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    rays = np.linalg.inv(K) @ np.stack([us.ravel(), vs.ravel(),
                                        np.ones(H * W)])
    rays_w = R.T @ rays
    C = -R.T @ tvec
    pts = C[:, None] + rays_w * ((z - C[2]) / rays_w[2])
    depth = (R @ pts + tvec[:, None])[2].reshape(H, W)
    depth = depth + rng.normal(size=depth.shape) * noise
    depth[:10, :10] = 0.0
    depth[40:43] = np.nan
    return depth.astype(np.float32)


def random_segments(rng, n, hw):
    H, W = hw
    s = rng.uniform([-5, -5], [W + 5, H + 5], (n, 2))
    e = s + rng.normal(size=(n, 2)) * 40
    return np.concatenate([s, e], 1).astype(np.float32)


def test_samples_depths_and_points_match_jax():
    rng = np.random.default_rng(3)
    jview, view, K, R, tvec = camera_view(rng)
    depth = plane_depth(K, R, tvec, (120, 160), rng)
    segs = random_segments(rng, 200, (120, 160))
    jseg = JSegments(jnp.asarray(segs[:, :2]), jnp.asarray(segs[:, 2:]))
    jp, jd, jv = jfit.sample_segment_depths(jseg, jnp.asarray(depth), 64)
    seg = Segments(t(segs[:, :2]), t(segs[:, 2:]))
    p, d, v = fitting.sample_segment_depths(seg, t(depth), 64)
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert 0 < v.float().mean() < 1
    assert np.array_equal(np.nan_to_num(d.numpy(), nan=-1),
                          np.nan_to_num(np.asarray(jd), nan=-1))
    jpts = np.asarray(jfit.unproject_points(jp, jd, jview))
    pts = fitting.unproject_points(p, d, view).numpy()
    ok = v.numpy()
    np.testing.assert_allclose(pts[ok], jpts[ok], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 4, 5, 64])
def test_median_threshold_matches_jax_nanmedian(n_valid):
    """An even count takes the mean of the two middle values (JAX), not
    the lower one (torch.nanmedian); no valid sample gives 1.0."""
    rng = np.random.default_rng(n_valid)
    x = rng.uniform(1, 20, (50, 64)).astype(np.float32)
    valid = np.zeros((50, 64), bool)
    for r in range(50):
        valid[r, rng.permutation(64)[:n_valid]] = True
    ref = np.asarray(jnp.nan_to_num(jnp.nanmedian(
        jnp.where(valid, x, jnp.nan), axis=-1), nan=1.0))
    ours = fitting.nanmedian_valid(t(x), t(valid)).numpy()
    assert np.array_equal(ours, ref)
    if n_valid == 4:
        lower = torch.nanmedian(torch.where(t(valid), t(x), float("nan")),
                                -1).values.numpy()
        assert not np.array_equal(lower, ref)


def ransac_data(rng):
    """JAX's test_fit_lines_ransac rows (a clean line, one with 25 %
    outliers, pure noise) and 60 more noisy lines with outliers and
    invalid samples."""
    S = 64
    tt = np.linspace(0, 1, S)[:, None]
    line_pts = np.array([0.0, 0, 5]) + tt * np.array([2.0, 1.0, 0.0])
    noisy = line_pts.copy()
    noisy[::4] += rng.normal(size=(S // 4, 3)) * 2.0
    junk = rng.normal(size=(S, 3)) * 3.0
    rows = [line_pts, noisy, junk]
    for _ in range(60):
        a = rng.normal(size=3) * 3 + [0, 0, 8]
        d = rng.normal(size=3)
        pts = a + tt * d + rng.normal(size=(S, 3)) * 0.01
        out = rng.random(S) < rng.uniform(0, 0.5)
        pts[out] += rng.normal(size=(out.sum(), 3))
        rows.append(pts)
    points = np.stack(rows).astype(np.float32)
    valid = np.ones(points.shape[:2], bool)
    valid[3:] = rng.random((60, S)) > 0.15
    th = np.full(len(points), 0.05, np.float32)
    th[3:] = rng.uniform(0.01, 0.05, 60)
    return points, valid, th


def test_ransac_core_with_jax_hypotheses_matches_jax():
    rng = np.random.default_rng(0)
    points, valid, th = ransac_data(rng)
    key = jax.random.PRNGKey(0)
    ref = jfit.fit_lines_ransac(jnp.asarray(points), jnp.asarray(valid),
                                jnp.asarray(th), key, n_hypotheses=64,
                                min_inlier_ratio=0.6)
    idx_a, idx_b = jax_hypotheses(key, len(points), 64, 64)
    best_j, inl_j = jax_best(points, valid, th, idx_a, idx_b)
    inl, n_inl, n_valid, best = line_ransac(t(points), t(valid), t(th),
                                            t(idx_a), t(idx_b))
    assert np.array_equal(best.numpy(), best_j)
    assert np.array_equal(inl.numpy(), inl_j)
    assert np.array_equal(n_valid.numpy(), valid.sum(1))
    out = fitting.fit_lines_from_hypotheses(
        t(points), t(valid), t(th), t(idx_a), t(idx_b), min_inlier_ratio=0.6)
    score = np.asarray(ref.score)
    assert np.array_equal(out.score.numpy(), score)
    assert score[0] > 0.95 and score[1] > 0.6 and score[2] <= 0
    assert (score[3:] > 0).sum() > 10
    assert_segments_close(out.start.numpy(), out.end.numpy(),
                          np.asarray(ref.start), np.asarray(ref.end), 1e-5)


def test_ransac_kernel_boundary_and_degenerate_hypotheses():
    """A point exactly at the threshold is an inlier (<=); a hypothesis of
    two coincident points measures distance to the point; a hypothesis
    with an invalid sample counts -1, and all-invalid rows take the first
    hypothesis with no inliers."""
    rng = np.random.default_rng(1)
    points = rng.normal(size=(4, 8, 3)).astype(np.float32)
    points[1, 1] = points[1, 0]
    valid = np.ones((4, 8), bool)
    valid[3] = False
    idx_a = np.zeros((4, 2), np.int32)
    idx_b = np.ones((4, 2), np.int32)
    idx_b[:, 1] = 2
    from limap_tpu_torch.ops.line_ransac import point_line_dist
    d = point_line_dist(t(points[0:1]), t(points[0:1, 0]),
                        t(points[0:1, 1]))[0]
    th = np.full(4, float(d[5]), np.float32)
    inl, n_inl, n_valid, best = line_ransac(t(points), t(valid), t(th),
                                            t(idx_a), t(idx_b))
    assert bool(inl[0, 5]) and bool(inl[0, 0]) and bool(inl[0, 1])
    d1 = np.linalg.norm(points[1] - points[1, 0], axis=1)
    assert int(best[1]) in (0, 1)
    if int(best[1]) == 0:
        assert np.array_equal(inl[1].numpy(), d1 <= th[1])
    assert int(best[3]) == 0 and int(n_inl[3]) == 0 and int(n_valid[3]) == 0


def test_draw_hypotheses_never_pairs_a_sample_with_itself():
    gen = torch.Generator().manual_seed(0)
    for S in (2, 3, 64):
        a, b = fitting.draw_hypotheses(5000, S, 32, gen)
        assert a.dtype == b.dtype == torch.int32
        assert not bool((a == b).any())
        assert int(a.min()) >= 0 and int(b.max()) < S
    again = fitting.draw_hypotheses(10, 64, 32, torch.Generator().manual_seed(7))
    same = fitting.draw_hypotheses(10, 64, 32, torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(again, same))


def test_estimate_from_depth_matches_jax_on_a_noisy_plane():
    rng = np.random.default_rng(5)
    jview, view, K, R, tvec = camera_view(rng)
    hw = (120, 160)
    depth = plane_depth(K, R, tvec, hw, rng, noise=2e-3)
    segs = random_segments(rng, 150, hw)
    key = jax.random.PRNGKey(3)
    jseg = JSegments(jnp.asarray(segs[:, :2]), jnp.asarray(segs[:, 2:]))
    ref = jfit.estimate_segs3d_from_depth(jseg, jnp.asarray(depth), jview,
                                          key, ransac_th=0.75,
                                          min_percentage_inliers=0.6,
                                          var2d=2.0)
    seg = Segments(t(segs[:, :2]), t(segs[:, 2:]))
    points, valid, th = fitting.depth_fit_inputs(seg, t(depth), view, 0.75,
                                                 2.0)
    # the JAX threshold, from its own median
    jp, jd, jv = jfit.sample_segment_depths(jseg, jnp.asarray(depth), 64)
    jmed = jnp.nan_to_num(jnp.nanmedian(jnp.where(jv, jd, jnp.nan), -1),
                          nan=1.0)
    jth = 0.75 * (2.0 * jmed / (0.5 * (jview.kvec[0] + jview.kvec[1])))
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-6)
    idx_a, idx_b = jax_hypotheses(key, len(segs), 64, 32)
    out = fitting.fit_lines_from_hypotheses(points, valid, th, t(idx_a),
                                            t(idx_b), min_inlier_ratio=0.6)
    assert_matches_jax_fit(out, ref)


def test_nonfinite_invalid_samples_do_not_poison_the_fit():
    """The port fits a row whose invalid samples lift to NaN or inf as
    JAX fits it once those points are zero: only inliers enter the TLS
    refit.  JAX's own result on such a row is NaN."""
    rng = np.random.default_rng(8)
    points, valid, th = ransac_data(rng)
    points[0, 5], points[1, 7], points[4, 9] = np.nan, np.inf, np.nan
    valid[0, 5] = valid[1, 7] = valid[4, 9] = False
    key = jax.random.PRNGKey(1)
    idx_a, idx_b = jax_hypotheses(key, len(points), 64, 64)
    out = fitting.fit_lines_from_hypotheses(
        t(points), t(valid), t(th), t(idx_a), t(idx_b), min_inlier_ratio=0.6)
    clean = np.where(valid[..., None], points, 0.0).astype(np.float32)
    ref = jfit.fit_lines_ransac(jnp.asarray(clean), jnp.asarray(valid),
                                jnp.asarray(th), key, n_hypotheses=64,
                                min_inlier_ratio=0.6)
    assert np.array_equal(out.score.numpy(), np.asarray(ref.score))
    assert_segments_close(out.start.numpy(), out.end.numpy(),
                          np.asarray(ref.start), np.asarray(ref.end), 1e-5)
    poisoned = jfit.fit_lines_ransac(jnp.asarray(points), jnp.asarray(valid),
                                     jnp.asarray(th), key, n_hypotheses=64,
                                     min_inlier_ratio=0.6)
    assert np.isnan(np.asarray(poisoned.start)[[0, 1]]).all()
    assert np.isfinite(out.start.numpy()).all()


def test_estimate_from_points3d_matches_jax_on_a_noisy_plane():
    rng = np.random.default_rng(6)
    jview, view, K, R, tvec = camera_view(rng)
    hw = (120, 160)
    depth = plane_depth(K, R, tvec, hw, rng, noise=2e-3)
    H, W = hw
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    cam = np.stack([(us - K[0, 2]) / K[0, 0] * depth,
                    (vs - K[1, 2]) / K[1, 1] * depth, depth], -1)
    p3d = ((cam.reshape(-1, 3) - tvec) @ R).reshape(H, W, 3)
    p3d[depth == 0] = 0.0
    p3d = p3d.astype(np.float32)
    segs = random_segments(rng, 150, hw)
    key = jax.random.PRNGKey(4)
    jseg = JSegments(jnp.asarray(segs[:, :2]), jnp.asarray(segs[:, 2:]))
    ref = jfit.estimate_segs3d_from_points3d(
        jseg, jnp.asarray(p3d), jview, key, hw, ransac_th=0.75,
        min_percentage_inliers=0.6, var2d=2.0)
    seg = Segments(t(segs[:, :2]), t(segs[:, 2:]))
    points, valid, th = fitting.points3d_fit_inputs(seg, t(p3d), view, hw,
                                                    0.75, 2.0)
    idx_a, idx_b = jax_hypotheses(key, len(segs), 64, 32)
    out = fitting.fit_lines_from_hypotheses(points, valid, th, t(idx_a),
                                            t(idx_b), min_inlier_ratio=0.6)
    assert_matches_jax_fit(out, ref)


def test_fit_lines_ransac_repeats_from_the_same_generator_seed():
    rng = np.random.default_rng(2)
    points, valid, th = ransac_data(rng)
    a, b = (fitting.fit_lines_ransac(t(points), t(valid), t(th),
                                     torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a.score, b.score) and torch.equal(a.start, b.start)
    assert float(a.score[0]) > 0.95
