"""Dense feature maps and differentiable interpolation.

Bilinear and bicubic (Catmull-Rom) sampling of [H, W, C] maps at
fractional pixel coordinates, differentiable under ``torch.func.jvp``
(the integer cell carries no tangent, the fractional offset does), line-
aligned patch extraction, and the track-level patch extractor.

At a clamp bound (an integer coordinate, where the offset is 0) the
offset's tangent passes whole, as ``torch.clamp``'s does; JAX's
``jnp.clip`` passes half of it there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cell(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """floor(x) clamped to [lo, hi], an index without tangent."""
    return torch.clamp(torch.floor(x.detach()), lo, hi).long()


def interpolate_bilinear(fmap: torch.Tensor, points: torch.Tensor):
    """fmap [H, W, C] (or [H, W]), points [..., 2] xy -> [..., C]."""
    squeeze = fmap.dim() == 2
    if squeeze:
        fmap = fmap[..., None]
    H, W, _ = fmap.shape
    x, y = points[..., 0], points[..., 1]
    x0 = _cell(x, 0, W - 2)
    y0 = _cell(y, 0, H - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    v = (fmap[y0, x0] * (1 - fx) * (1 - fy)
         + fmap[y0, x0 + 1] * fx * (1 - fy)
         + fmap[y0 + 1, x0] * (1 - fx) * fy
         + fmap[y0 + 1, x0 + 1] * fx * fy)
    return v[..., 0] if squeeze else v


def _cubic_weights(t):
    """Catmull-Rom weights [..., 4] of the fractional offset t [...]."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def interpolate_bicubic(fmap: torch.Tensor, points: torch.Tensor):
    """Bicubic (Catmull-Rom) sampling, C1-smooth; fmap [H, W, C] or
    [H, W], points [..., 2] xy."""
    squeeze = fmap.dim() == 2
    if squeeze:
        fmap = fmap[..., None]
    H, W, _ = fmap.shape
    x, y = points[..., 0], points[..., 1]
    x0 = _cell(x, 1, W - 3)
    y0 = _cell(y, 1, H - 3)
    wx = _cubic_weights(torch.clamp(x - x0, 0.0, 1.0))
    wy = _cubic_weights(torch.clamp(y - y0, 0.0, 1.0))
    out = 0.0
    for j in range(4):
        row = 0.0
        for i in range(4):
            row = row + wx[..., i, None] * fmap[y0 + j - 1, x0 + i - 1]
        out = out + wy[..., j, None] * row
    return out[..., 0] if squeeze else out


class FeatureMap:
    """A dense map [H, W, C] or [H, W] with its interpolator."""

    def __init__(self, array, interpolation: str = "bicubic", device=None):
        from limap_tpu_torch import resolve_device
        self.array = torch.as_tensor(np.asarray(array),
                                     device=resolve_device(device))
        self.interpolation = interpolation

    def h(self):
        return self.array.shape[0]

    def w(self):
        return self.array.shape[1]

    def channels(self):
        return 1 if self.array.dim() == 2 else self.array.shape[2]

    def interpolate(self, points):
        fn = (interpolate_bicubic if self.interpolation == "bicubic"
              else interpolate_bilinear)
        return fn(self.array, torch.as_tensor(
            points, dtype=self.array.dtype, device=self.array.device))


def extract_line_patches(fmap: torch.Tensor, seg_start: torch.Tensor,
                         seg_end: torch.Tensor, n_along: int = 32,
                         n_perp: int = 5, perp_spacing: float = 2.0):
    """Line-aligned patches: fmap [H, W, C]; seg_start/seg_end [N, 2].
    Returns [N, n_along, n_perp, C] samples, along the segment from its
    start and across it centred on it."""
    d = seg_end - seg_start
    length = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d / (length + 1e-8)
    n = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    t_along = torch.linspace(0.0, 1.0, n_along, dtype=fmap.dtype,
                             device=fmap.device)
    t_perp = (torch.arange(n_perp, dtype=fmap.dtype, device=fmap.device)
              - (n_perp - 1) / 2.0) * perp_spacing
    base = seg_start[:, None, :] + t_along[None, :, None] \
        * (seg_end - seg_start)[:, None, :]              # [N, A, 2]
    pts = base[:, :, None, :] + t_perp[None, None, :, None] \
        * n[:, None, None, :]                            # [N, A, P, 2]
    return interpolate_bilinear(fmap, pts)


class LinePatchExtractorOptions:
    """Stretch of the segment and width of the patch across it."""

    def __init__(self, d: Optional[dict] = None):
        d = d or {}
        self.k_stretch = d.get("k_stretch", 1.0)
        self.t_stretch = d.get("t_stretch", 10)
        self.range_perp = d.get("range_perp", 20)


class LinePatchExtractor:
    """Track-level patch extraction: per support, stretch the 2D segment
    (final length = max(length * k_stretch, length + t_stretch)) and cut
    a rotated patch of ``range_perp`` pixels across it, resampled on a
    fixed grid, so that a track's supports come back as one array."""

    def __init__(self, options: Optional[LinePatchExtractorOptions] = None,
                 n_along: int = 32, device=None):
        from limap_tpu_torch import resolve_device
        self.options = options or LinePatchExtractorOptions()
        self.n_along = n_along
        self.device = resolve_device(device)

    def _stretch(self, start: np.ndarray, end: np.ndarray):
        opt = self.options
        d = end - start
        length = np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8
        u = d / length
        final = np.maximum(length * opt.k_stretch, length + opt.t_stretch)
        mid = 0.5 * (start + end)
        return mid - u * final / 2, mid + u * final / 2

    def _patches(self, s, e, feature):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        return extract_line_patches(
            f(feature), f(s), f(e), n_along=self.n_along,
            n_perp=int(self.options.range_perp),
            perp_spacing=1.0).cpu().numpy()

    def extract_line_patch(self, line2d: np.ndarray, feature):
        """line2d [2, 2] -> (patch [A, P, C], stretched start, end)."""
        s, e = self._stretch(line2d[0][None], line2d[1][None])
        return self._patches(s, e, feature)[0], s[0], e[0]

    def extract_line_patches(self, line2ds: np.ndarray, feature):
        """line2ds [N, 2, 2] -> patches [N, A, P, C]."""
        line2ds = np.asarray(line2ds, np.float64).reshape(-1, 2, 2)
        s, e = self._stretch(line2ds[:, 0], line2ds[:, 1])
        return self._patches(s, e, feature)

    def extract_one_image(self, track, img_id: int, view, feature):
        """Patches of all of one track's supports in one image."""
        segs = [np.asarray(l2d) for (iid, l2d) in
                zip(track.image_id_list, track.line2d_list)
                if iid == img_id]
        if not segs:
            C = np.asarray(feature).shape[-1]
            return np.zeros((0, self.n_along,
                             int(self.options.range_perp), C))
        return self.extract_line_patches(np.stack(segs), feature)
