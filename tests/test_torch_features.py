"""Dense features: the port (``limap_tpu_torch.features``) against the
JAX package on the same inputs: bilinear and bicubic values (1e-6) and
their forward derivatives away from the clamp bounds, the one difference
at a bound (JAX's ``jnp.clip`` passes half the tangent there, torch's
clamp all of it), line patches, the gradient extractor and the track
patch extractor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limap_tpu.features as J
from limap_tpu.features.featuremap import LinePatchExtractor as JLPE
from limap_tpu.features.featuremap import \
    LinePatchExtractorOptions as JLPEO
import limap_tpu_torch.features as T
from limap_tpu_torch.features.featuremap import LinePatchExtractor as TLPE
from limap_tpu_torch.features.featuremap import \
    LinePatchExtractorOptions as TLPEO
from torch_threads import two_torch_threads  # noqa: F401


def _pts(rng, n, H, W, margin=0.0):
    """Fractional points away from integers (offsets in [0.05, 0.95])."""
    base = np.stack([rng.integers(0, W - 1, n), rng.integers(0, H - 1, n)],
                    -1)
    return (base + rng.uniform(0.05, 0.95, (n, 2))).astype(np.float32)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("C", [None, 3])
def test_values_match_jax(interp, C):
    rng = np.random.default_rng(0)
    shape = (20, 30) if C is None else (20, 30, C)
    fmap = rng.normal(size=shape).astype(np.float32)
    pts = _pts(rng, 50, 20, 30)
    pts = np.concatenate([pts, [[-3.0, 4.2], [40.0, 25.0], [3.0, 4.0]]]
                         ).astype(np.float32)
    fj = getattr(J, f"interpolate_{interp}")
    ft = getattr(T, f"interpolate_{interp}")
    np.testing.assert_allclose(
        ft(torch.as_tensor(fmap), torch.as_tensor(pts)).numpy(),
        np.asarray(fj(jnp.asarray(fmap), jnp.asarray(pts))), atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_jvp_matches_jax_away_from_bounds(interp):
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(16, 24, 2)).astype(np.float32)
    pts = _pts(rng, 40, 14, 22) + 1.0
    tang = rng.normal(size=pts.shape).astype(np.float32)
    fj = getattr(J, f"interpolate_{interp}")
    ft = getattr(T, f"interpolate_{interp}")
    _, dj = jax.jvp(lambda p: fj(jnp.asarray(fmap), p), (jnp.asarray(pts),),
                    (jnp.asarray(tang),))
    _, dt = torch.func.jvp(lambda p: ft(torch.as_tensor(fmap), p),
                           (torch.as_tensor(pts),), (torch.as_tensor(tang),))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_jvp_at_a_clamp_bound_halves_in_jax():
    """At an integer x the offset fx = x - x0 sits on jnp.clip's bound 0:
    JAX passes 0.5 of the tangent, torch.clamp (and the kernels) 1.0."""
    fmap = np.arange(20.0, dtype=np.float32).reshape(4, 5)   # d/dx = 1
    pt = np.array([[2.0, 1.5]], np.float32)
    tang = np.array([[1.0, 0.0]], np.float32)
    _, dj = jax.jvp(lambda p: J.interpolate_bilinear(jnp.asarray(fmap), p),
                    (jnp.asarray(pt),), (jnp.asarray(tang),))
    _, dt = torch.func.jvp(
        lambda p: T.interpolate_bilinear(torch.as_tensor(fmap), p),
        (torch.as_tensor(pt),), (torch.as_tensor(tang),))
    assert float(np.asarray(dj)[0]) == pytest.approx(0.5)
    assert float(dt[0]) == pytest.approx(1.0)


def test_line_patches_match_jax():
    rng = np.random.default_rng(2)
    fmap = rng.normal(size=(40, 60, 3)).astype(np.float32)
    s = np.array([[5.3, 5.1], [10.2, 30.7]], np.float32)
    e = np.array([[50.6, 8.2], [40.1, 35.4]], np.float32)
    pj = J.extract_line_patches(jnp.asarray(fmap), jnp.asarray(s),
                                jnp.asarray(e), n_along=16, n_perp=5)
    pt = T.extract_line_patches(torch.as_tensor(fmap), torch.as_tensor(s),
                                torch.as_tensor(e), n_along=16, n_perp=5)
    assert pt.shape == (2, 16, 5, 3)
    # the sample positions come from each framework's linspace, which
    # may differ in the last place: 5e-5 on a map of unit noise
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-5)


def test_gradient_extractor_and_featuremap_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.uniform(size=(32, 48)) * 255).astype(np.uint8)
    fj = J.GradientFeatureExtractor().extract(img)
    ft = T.get_extractor("gradient", device="cpu").extract(img)
    assert ft.shape == (32, 48, 6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-6)
    pts = np.array([[10.5, 10.5], [3.25, 20.75]])
    np.testing.assert_allclose(
        T.FeatureMap(ft.numpy(), device="cpu").interpolate(pts).numpy(),
        np.asarray(J.FeatureMap(fj).interpolate(pts)), atol=1e-5)
    # the learned S2DNet extractor, JAX's Flax weights carried across by
    # convert.s2dnet_state_dict through a checkpoint file
    from limap_tpu_torch import convert
    sj = J.get_extractor("s2dnet")
    ckpt = tmp_path / "s2dnet.pth"
    torch.save(convert.s2dnet_state_dict(jax.device_get(sj.params)), ckpt)
    st = T.get_extractor("s2dnet", weight_path=str(ckpt), device="cpu")
    # fp32 convolutions in another order: 1e-5 of unit hypercolumns
    np.testing.assert_allclose(st.extract(img).numpy(),
                               np.asarray(sj.extract(img)), atol=1e-5)


def test_line_patch_extractor_matches_jax():
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(60, 80, 2)).astype(np.float32)
    lines = np.array([[[10.0, 12.0], [50.0, 20.0]],
                      [[30.0, 40.0], [35.0, 10.0]]])
    opts = {"k_stretch": 1.2, "t_stretch": 6, "range_perp": 7}
    ej = JLPE(JLPEO(opts), n_along=12)
    et = TLPE(TLPEO(opts), n_along=12, device="cpu")
    np.testing.assert_allclose(et.extract_line_patches(lines, feat),
                               ej.extract_line_patches(lines, feat),
                               atol=5e-5)
    pj, sj, ej_ = ej.extract_line_patch(lines[0], feat)
    pt, st, et_ = et.extract_line_patch(lines[0], feat)
    np.testing.assert_allclose(pt, pj, atol=5e-5)
    np.testing.assert_allclose(st, sj)

    class Track:
        image_id_list = [3, 4, 3]
        line2d_list = list(lines) + [lines[1]]

    a = et.extract_one_image(Track(), 3, None, feat)
    b = ej.extract_one_image(Track(), 3, None, feat)
    assert a.shape == (2, 12, 7, 2)
    np.testing.assert_allclose(a, b, atol=5e-5)
    assert et.extract_one_image(Track(), 9, None, feat).shape == (0, 12, 7, 2)
