"""Torch versions of the OpenCV calls that the learned front end makes.

The reference package calls OpenCV on the host in its detectors and
descriptors.  The card's machine cannot be counted on to have ``cv2``,
so the port computes the same functions with torch ops, on any device:

- :func:`gaussian_blur` (5x5, ``getGaussianKernel``'s weights; replicate
  or reflect-101 borders), float32 and uint8;
- :func:`resize` (``INTER_NEAREST`` and ``INTER_LINEAR``), float32 and
  uint8;
- :func:`warp_affine` (``INTER_LINEAR``, a constant 0 border), float32;
- :func:`rgb_to_hsv` and :func:`hsv_to_bgr` on uint8.

What each reproduces and how closely is measured against ``cv2`` in
``tests/test_torch_cv2_ops.py``:

- float32 ``INTER_NEAREST`` resize and the colour conversions are equal
  bit for bit; the float32 blur and ``INTER_LINEAR`` resize agree to a
  few float32 roundings;
- uint8 ``INTER_LINEAR`` resize follows OpenCV's fixed-point rule
  (weights in 1/2048, rows summed exactly, rounded once); the uint8 blur
  is computed in float64 and rounded, within one grey level of OpenCV's
  fixed-point kernel;
- OpenCV 5's ``warpAffine`` takes its source coordinates in float32 (a
  translation by 0.3 px weights the neighbours 0.70/0.30, not by 1/32
  steps) and interpolates in a SIMD order that this module does not
  reproduce: it differs by a few float32 roundings where a coordinate
  rounds the other way.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INTER_NEAREST = 0
INTER_LINEAR = 1


# ------------------------------------------------------------------ blur
def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)``: the exponentials
    normalized by their sum in float64, then rounded to float32."""
    scale = -0.5 / (sigma * sigma)
    taps = np.array([math.exp(scale * (i - (ksize - 1) * 0.5) ** 2)
                     for i in range(ksize)])
    return (taps * (1.0 / taps.sum())).astype(np.float32)


def _pad2(x: torch.Tensor, r: int, border: str) -> torch.Tensor:
    """x [C, H, W] padded by r on each side of H and W."""
    mode = {"replicate": "replicate", "reflect101": "reflect"}[border]
    return F.pad(x[None], (r, r, r, r), mode=mode)[0]


def gaussian_blur(img: torch.Tensor, sigma: float, ksize: int = 5,
                  border: str = "replicate") -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma, borderType=...)`` on
    an [H, W] or [H, W, C] float32 or uint8 tensor.  float32 sums the
    symmetric taps pairwise in float32, rows then columns; uint8 blurs in
    float64 and rounds half up."""
    dtype = img.dtype
    chw = img[None] if img.dim() == 2 else img.permute(2, 0, 1)
    r = ksize // 2
    k = torch.as_tensor(gaussian_kernel(ksize, sigma), device=img.device)
    work = torch.float32 if dtype == torch.float32 else torch.float64
    k = k.to(work)
    x = _pad2(chw.to(work), r, border)
    W = chw.shape[2]
    H = chw.shape[1]
    # rows: centre tap, then the symmetric pairs from the inside out
    row = x[:, :, r:r + W] * k[r]
    for j in range(1, r + 1):
        row = row + (x[:, :, r - j:r - j + W] + x[:, :, r + j:r + j + W]) \
            * k[r + j]
    col = row[:, r:r + H] * k[r]
    for j in range(1, r + 1):
        col = col + (row[:, r - j:r - j + H] + row[:, r + j:r + j + H]) \
            * k[r + j]
    if dtype == torch.uint8:
        col = torch.floor(col + 0.5).clamp(0, 255).to(torch.uint8)
    out = col
    return out[0] if img.dim() == 2 else out.permute(1, 2, 0)


# ---------------------------------------------------------------- resize
def _nearest_index(n_in: int, n_out: int, device,
                   factor=None) -> torch.Tensor:
    """OpenCV's INTER_NEAREST source index: floor(i / (out / in)) in
    float64 (``factor`` in place of out / in where the caller gave one),
    capped at in - 1."""
    inv = 1.0 / (factor or n_out / n_in)
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.clamp(torch.floor(i * inv).to(torch.int64), max=n_in - 1)


def _linear_taps(n_in: int, n_out: int, device, factor=None):
    """OpenCV's INTER_LINEAR taps along one axis: (first index, second
    index, float64 fraction), the source coordinate (i + 0.5) / (out /
    in) - 0.5 in float64, clipped at both edges."""
    scale = 1.0 / (factor or n_out / n_in)
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    f = (i + 0.5) * scale - 0.5
    s = torch.floor(f)
    frac = f - s
    s = s.to(torch.int64)
    low = s < 0
    frac = torch.where(low, torch.zeros_like(frac), frac)
    s = torch.where(low, torch.zeros_like(s), s)
    high = s >= n_in - 1
    frac = torch.where(high, torch.zeros_like(frac), frac)
    s = torch.where(high, torch.full_like(s, n_in - 1), s)
    return s, torch.clamp(s + 1, max=n_in - 1), frac


def resize(img: torch.Tensor, size, interpolation: int = INTER_LINEAR,
           fx: float = None, fy: float = None) -> torch.Tensor:
    """``cv2.resize(img, size, fx=fx, fy=fy)`` on an [H, W] or [H, W, C]
    float32 or uint8 tensor.  ``size`` = (width, height), or None to take
    round(W fx) x round(H fy), whose coordinates then scale by fx and fy
    themselves, as OpenCV's."""
    H, W = img.shape[:2]
    if size is None:
        size = (int(round(W * fx)), int(round(H * fy)))
    out_w, out_h = int(size[0]), int(size[1])
    dev = img.device
    if interpolation == INTER_NEAREST:
        return img[_nearest_index(H, out_h, dev, fy)][
            :, _nearest_index(W, out_w, dev, fx)]
    if interpolation != INTER_LINEAR:
        raise NotImplementedError(f"interpolation {interpolation}")
    y0, y1, wy = _linear_taps(H, out_h, dev, fy)
    x0, x1, wx = _linear_taps(W, out_w, dev, fx)
    fx, fy = wx, wy
    extra = (None,) * (img.dim() - 2)
    if img.dtype == torch.uint8:
        # fixed point: weights in 1/2048 (INTER_RESIZE_COEF_BITS = 11),
        # the row pass exact in integers, one rounding at the end
        one = 2048
        wx1 = torch.round(fx * one).to(torch.int64)
        wy1 = torch.round(fy * one).to(torch.int64)
        wx0, wy0 = one - wx1, one - wy1
        src = img.to(torch.int64)
        rows = (src[:, x0] * wx0[(None, slice(None)) + extra]
                + src[:, x1] * wx1[(None, slice(None)) + extra])
        v = (rows[y0] * wy0[(slice(None), None) + extra]
             + rows[y1] * wy1[(slice(None), None) + extra])
        return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    src = img.to(torch.float32)
    # float32 weights: the fraction rounded, its complement 1 - it
    ax1 = fx.to(torch.float32)[(None, slice(None)) + extra]
    ay1 = fy.to(torch.float32)[(slice(None), None) + extra]
    rows = src[:, x0] * (1.0 - ax1) + src[:, x1] * ax1
    return rows[y0] * (1.0 - ay1) + rows[y1] * ay1


# ----------------------------------------------------------- warpAffine
def invert_affine(A: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64: [2, 3] -> [2, 3]."""
    M = np.asarray(A, np.float64).reshape(-1)
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = M[4] * D, M[0] * D, -M[1] * D, -M[3] * D
    b1 = -a11 * M[2] - a12 * M[5]
    b2 = -a21 * M[2] - a22 * M[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def warp_coords(Minv: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Source coordinates of destination pixels (xs, ys) under the
    inverse map ``Minv`` [6] float32: x' = M0 x + (M1 y + M2), in float32
    with every product and sum rounded."""
    sx = Minv[0] * xs + (Minv[1] * ys + Minv[2])
    sy = Minv[3] * xs + (Minv[4] * ys + Minv[5])
    return sx, sy


def bilinear_zero(img: torch.Tensor, sx: torch.Tensor,
                  sy: torch.Tensor) -> torch.Tensor:
    """img [H, W] float32 at float32 coordinates, corners outside the image
    read as 0; lerp along x, then along y."""
    H, W = img.shape
    fx0 = torch.floor(sx)
    fy0 = torch.floor(sy)
    ax = sx - fx0
    ay = sy - fy0
    x0 = fx0.to(torch.int64)
    y0 = fy0.to(torch.int64)

    def get(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(ok, v, torch.zeros_like(v))

    p00, p01 = get(y0, x0), get(y0, x0 + 1)
    p10, p11 = get(y0 + 1, x0), get(y0 + 1, x0 + 1)
    a = p00 + ax * (p01 - p00)
    b = p10 + ax * (p11 - p10)
    return a + ay * (b - a)


def warp_affine(img: torch.Tensor, A, size) -> torch.Tensor:
    """``cv2.warpAffine(img, A, size)`` (INTER_LINEAR, constant 0 border)
    of an [H, W] float32 tensor; ``size`` = (width, height)."""
    out_w, out_h = int(size[0]), int(size[1])
    dev = img.device
    Minv = torch.as_tensor(invert_affine(A).reshape(-1).astype(np.float32),
                           device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    sx, sy = warp_coords(Minv, xs.expand(out_h, out_w),
                         ys.expand(out_h, out_w))
    return bilinear_zero(img, sx, sy)


# -------------------------------------------------------------- colours
_HSV_SHIFT = 12


def _div_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(i, 1)),
                        0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT)
                                       / (6.0 * np.maximum(i, 1))), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8 [H, W, 3]: OpenCV's
    integer rule (H in [0, 180))."""
    sdiv, hdiv = (torch.as_tensor(t, device=img.device)
                  for t in _div_tables())
    c = img.to(torch.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def hsv_to_bgr(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_HSV2BGR)`` on uint8 [H, W, 3]: OpenCV's
    float32 rule, rounded half to even."""
    f = img.to(torch.float32)
    h = f[..., 0] * np.float32(6.0 / 180.0)
    s = f[..., 1] * np.float32(1.0 / 255.0)
    v = f[..., 2] * np.float32(1.0 / 255.0)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.to(torch.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, torch.zeros_like(sector), sector)
    h = torch.where(bad, torch.zeros_like(h), h)
    one = torch.ones((), dtype=torch.float32, device=img.device)
    tab = torch.stack([v, v * (one - s), v * (one - s * h),
                       v * (one - s * (one - h))], dim=-1)
    order = torch.as_tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                             [0, 1, 3], [2, 1, 0]], device=img.device)
    idx = order[sector]                                    # [H, W, 3]
    bgr = torch.gather(tab, -1, idx)
    grey = (s == 0)[..., None]
    bgr = torch.where(grey, v[..., None].expand_as(bgr), bgr)
    return torch.round(bgr * 255.0).clamp(0, 255).to(torch.uint8)
