"""Device-native line segment detector ("tpu_lsd").

An LSD-style detector made of data-parallel steps (region growing is a
serial flood fill, so it is replaced):

1. Sobel gradients and the level-line orientation (mod pi),
2. pixels binned into overlapping orientation buckets (the 2 nearest of
   B bins, about LSD's 22.5 deg angle tolerance),
3. parallel connected components on each orientation mask (min-label
   propagation over the 8-neighbourhood plus pointer jumping),
4. each component reduced to a segment by gradient-weighted PCA with
   scatter-adds (second moments) and scatter-min/max (extent along the
   principal axis),
5. a length / width / density filter and the top-K by length.

The registry name stays ``tpu_lsd``: configs and folder names carry it.
Everything is eager torch on the detector's device, one image at a time,
its orientation bins batched.
The moments are formed as in the reference (``sxx / sw - mean_x^2`` in
fp32), so a 2 px stroke at x ~ 800 keeps about two digits of its
variance.  Both devices add a component's pixels in pixel order (see
``scatter_sums``); the gradient field itself rounds differently on the
card, so card and CPU agree to a pixel tolerance, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import BaseDetector, register_detector

_BIG = 1e30


def _sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2.0 \
        + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2])
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2.0 \
        + (p[2:, 2:] - p[:-2, 2:]) + (p[2:, :-2] - p[:-2, :-2])
    return gx / 8.0, gy / 8.0


def _grid_cc(mask: torch.Tensor, n_rounds: int) -> torch.Tensor:
    """Connected components of boolean masks [..., H, W], 8-neighbourhood,
    each mask on its own.

    Returns int64 labels of the mask's shape: the minimum flat pixel
    index (within its mask) of the component, -1 off the mask.  Each
    round is one local min-propagation, then ``max(bit_length(H*W), 4)``
    pointer jumps, every jump reading the labels of the jump before (as
    the reference's functional update does), so the labels equal the
    reference's also where ``n_rounds`` stops short of the fixpoint.
    """
    shape = mask.shape
    H, W = shape[-2:]
    N = H * W
    mask = mask.reshape(-1, H, W)
    B = mask.shape[0]
    dev = mask.device
    # all masks share one pointer array: mask b owns entries
    # [b (N + 1), (b + 1) (N + 1)), its last entry the sentinel that every
    # off-mask pixel points at and that points at itself
    base = torch.arange(B, device=dev)[:, None, None] * (N + 1)
    sentinel = base + N
    labels = torch.where(mask, base + torch.arange(N, device=dev)
                         .reshape(H, W), sentinel)
    n_jumps = max(N.bit_length(), 4)
    for _ in range(n_rounds):
        p = F.pad(labels, (1, 1, 1, 1), value=B * (N + 1))
        cand = labels
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    cand = torch.minimum(
                        cand, p[:, 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx])
        labels = torch.where(mask, cand, sentinel)
        # two buffers in turns, one gather a jump
        flat = torch.cat([labels.reshape(B, N), sentinel.reshape(B, 1)],
                         dim=1).reshape(-1)
        other = torch.empty_like(flat)
        for _ in range(n_jumps):
            torch.index_select(flat, 0, flat, out=other)
            flat, other = other, flat
        labels = flat.reshape(B, N + 1)[:, :N].reshape(B, H, W)
    return torch.where(mask, labels - base,
                       torch.full_like(labels, -1)).reshape(shape)


def _detect_kernel(img: torch.Tensor, n_bins: int, max_segs: int,
                   cc_rounds: int, min_size: int, grad_th: float,
                   max_width: float, min_density: float):
    """img [H, W] float in [0, 1] -> segs [max_segs, 5], count."""
    gx, gy = _sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    # level-line angle (perpendicular to the gradient), mod pi
    theta = torch.remainder(torch.atan2(gy, gx) + math.pi / 2.0, math.pi)
    return detect_from_fields(mag, theta, mag > grad_th, n_bins, max_segs,
                              cc_rounds, min_size, max_width, min_density)


def detect_from_fields(mag: torch.Tensor, theta: torch.Tensor,
                       on: torch.Tensor, n_bins: int, max_segs: int,
                       cc_rounds: int, min_size: int,
                       max_width: float, min_density: float):
    """Segments from a (magnitude, level-line angle, support mask) field
    triple [H, W]: the raw-gradient detector above feeds it, and a
    learned attraction field can."""
    H, W = mag.shape
    N = H * W
    dev = mag.device
    # every orientation bin at once: all per-pixel arrays are [n_bins * N]
    # and bin b's components live in slots [b N, (b + 1) N), so the
    # candidates come out bin by bin as the reference concatenates them
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None] \
        .expand(n_bins, H, W).reshape(-1)
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :] \
        .expand(n_bins, H, W).reshape(-1)
    pixel = torch.arange(N, device=dev).reshape(H, W)
    slot0 = torch.arange(n_bins, device=dev)[:, None, None] * N

    def scatter_sums(lab, cols):
        """The sum of each array of ``cols`` per label, every label's
        addends in pixel order on either device.  On the CPU
        ``index_add_`` walks the pixels in order.  On the card it adds
        with atomics in any order, so there one accumulating
        ``index_put_`` takes all columns: it sorts by label first, and
        the moments repeat from run to run."""
        if dev.type == "cuda":
            out = torch.zeros(n_bins * N, len(cols), device=dev)
            return out.index_put_((lab,), torch.stack(cols, dim=1),
                                  accumulate=True).unbind(1)
        return [torch.zeros(n_bins * N).index_add_(0, lab, v) for v in cols]

    bin_width = math.pi / n_bins
    centers = torch.tensor([(b + 0.5) * bin_width for b in range(n_bins)],
                           dtype=torch.float32, device=dev)
    # circular distance mod pi; accept within one full bin width, so the
    # overlapping buckets approximate LSD's angle tolerance
    d = torch.abs(theta - centers[:, None, None])
    d = torch.minimum(d, math.pi - d)
    mask = on & (d < bin_width)              # [n_bins, H, W]
    labels = _grid_cc(mask, cc_rounds)

    # an off-mask pixel scatters neutral values (0, +-BIG) into its own
    # slot, which is no component's root: the same sums as sending them
    # all to slot 0, without thousands of atomics on one address
    m = mask.reshape(-1)
    lab = (torch.where(mask, labels, pixel) + slot0).reshape(-1)
    wgt = torch.where(mask, mag, torch.zeros_like(mag)).reshape(-1)

    cnt, sw, sx, sy, sxx, sxy, syy = scatter_sums(lab, [
        m.to(torch.float32), wgt, wgt * x, wgt * y, wgt * x * x,
        wgt * x * y, wgt * y * y])

    valid_root = (cnt >= min_size) & (sw > 0)
    sw_safe = torch.clamp(sw, min=1e-8)
    mean_x = sx / sw_safe
    mean_y = sy / sw_safe
    cxx = sxx / sw_safe - mean_x * mean_x
    cxy = sxy / sw_safe - mean_x * mean_y
    cyy = syy / sw_safe - mean_y * mean_y
    # principal axis of the 2x2 covariance, closed form
    tr = cxx + cyy
    diff = cxx - cyy
    disc = torch.sqrt(torch.clamp(diff * diff + 4 * cxy * cxy, min=0.0))
    lam1 = 0.5 * (tr + disc)
    lam2 = 0.5 * (tr - disc)
    one, zero = torch.ones_like(cxx), torch.zeros_like(cxx)
    skew = torch.abs(cxy) > 1e-12
    dx = torch.where(skew, lam1 - cyy, torch.where(cxx >= cyy, one, zero))
    dy = torch.where(skew, cxy, torch.where(cxx >= cyy, zero, one))
    dn = torch.sqrt(dx * dx + dy * dy) + 1e-12
    dx, dy = dx / dn, dy / dn

    # extent along the principal axis via scatter-min/max
    proj = (x - mean_x[lab]) * dx[lab] + (y - mean_y[lab]) * dy[lab]
    big = torch.full_like(proj, _BIG)
    pmin = torch.full_like(proj, _BIG).scatter_reduce_(
        0, lab, torch.where(m, proj, big), reduce="amin", include_self=True)
    pmax = torch.full_like(proj, -_BIG).scatter_reduce_(
        0, lab, torch.where(m, proj, -big), reduce="amax", include_self=True)

    length = pmax - pmin
    width = 2.0 * torch.sqrt(torch.clamp(lam2, min=0.0))
    density = cnt / torch.clamp(length * torch.clamp(width, min=1.0), min=1.0)
    good = (valid_root & (length >= min_size)
            & (width <= max_width) & (density >= min_density))

    segs = torch.stack(
        [mean_x + dx * pmin, mean_y + dy * pmin,
         mean_x + dx * pmax, mean_y + dy * pmax,
         torch.sqrt(torch.clamp(length, min=0.0))], dim=-1)   # [B*N, 5]
    scores = torch.where(good, length, -one)                  # [B*N]
    # top-K by length
    k = min(max_segs, scores.shape[0])
    top_scores, top_idx = torch.topk(scores, k)
    found = top_scores > 0
    out = torch.where(found[:, None], segs[top_idx],
                      torch.zeros((), device=dev))
    return out, found.sum()


def detect_segments(img: np.ndarray, n_bins: int = 8, max_segs: int = 2048,
                    cc_rounds: int = 2, min_size: int = 12,
                    grad_th: float = 0.03, max_width: float = 6.0,
                    min_density: float = 0.3, device=None) -> np.ndarray:
    """Host wrapper: grayscale uint8/float image -> (N, 5) segments
    ``x1 y1 x2 y2 sqrt(length)``, longest first, computed on ``device``
    (``None`` means cuda)."""
    device = resolve_device(device)
    img = np.asarray(img)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    segs, count = _detect_kernel(
        torch.as_tensor(img, device=device), n_bins, max_segs, cc_rounds,
        min_size, grad_th, max_width, min_density)
    out = segs.cpu().numpy()[:int(count)]
    if len(out):
        # overlapping orientation buckets emit duplicate components:
        # dedupe on rounded endpoints, keeping the first of each
        _, keep = np.unique(np.round(out[:, :4]).astype(np.int64), axis=0,
                            return_index=True)
        out = out[np.sort(keep)]
    return out


@register_detector("tpu_lsd")
class TPULSDDetector(BaseDetector):
    """Gradient-grouping detector running fully on the device."""

    def __init__(self, options=None):
        super().__init__(options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        self.n_bins = options.get("n_bins", 8)
        self.grad_th = options.get("grad_th", 0.03)
        self.min_size = options.get("min_size", 12)
        self.max_width = options.get("max_width", 6.0)
        self.min_density = options.get("min_density", 0.3)

    def get_module_name(self):
        return "tpu_lsd"

    def detect(self, camview) -> np.ndarray:
        return self.detect_array(camview.read_image(set_gray=True))

    def detect_array(self, img: np.ndarray) -> np.ndarray:
        return detect_segments(
            img, n_bins=self.n_bins, grad_th=self.grad_th,
            min_size=self.min_size, max_width=self.max_width,
            min_density=self.min_density,
            max_segs=self.max_num_2d_segs or 2048, device=self.device)
