"""Kernel V: the Line Band Descriptor of every line of an image.

``lbd_describe(img, segs, valid)`` takes a grayscale image [H, W] f32,
segments [N, 4] f32 (x1, y1, x2, y2) and a validity mask [N], and returns
descriptors [N, 72] f32 (zero rows where not valid).  For each line: a
band of M_BANDS x W_BAND = 63 rows across the line by NS_ALONG = 32
samples along it; the central-difference gradients (replicated border)
sampled bilinearly (coordinates clipped to [0, size - 1.001]), projected
on the line direction and its normal, weighted by a global Gaussian
across the rows; per band, the local-Gaussian-weighted sums of the
positive and negative parts of both projections over the band and its
two neighbours, one sum a column; per band the mean and the population
std of those over the 32 columns; then L2-normalized, clamped at 0.4 and
L2-normalized again.  CUDA tensors launch ``csrc/lbd_describe.cu``; CPU
tensors take :func:`lbd_describe_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.ops.cuda_build import check_tensor, load_library

SOURCE = "lbd_describe.cu"
M_BANDS = 9
W_BAND = 7
NS_ALONG = 32
ROWS = M_BANDS * W_BAND
DIM = M_BANDS * 8
# jnp.linspace(0, 1, 32): i * float32(1 / 31)
T_STEP = np.float32(1.0 / (NS_ALONG - 1))


_WEIGHTS = {}


def weights(device):
    """(global Gaussian [ROWS], local Gaussians [M_BANDS, ROWS], zero
    outside a band's neighbourhood), float32 as the reference; computed
    once a device."""
    key = str(torch.device(device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = _weights(device)
    return _WEIGHTS[key]


def _weights(device):
    off = torch.arange(ROWS, dtype=torch.float32, device=device) \
        - (ROWS - 1) / 2.0
    wg = torch.exp(-0.5 * (off / (ROWS / 2.0)) ** 2)
    rows = torch.arange(ROWS, device=device)
    band = rows // W_BAND
    wl = []
    for j in range(M_BANDS):
        center = j * W_BAND + (W_BAND - 1) / 2.0
        w = torch.exp(-0.5 * ((rows.to(torch.float32) - center)
                              / W_BAND) ** 2)
        wl.append(torch.where((band - j).abs() <= 1, w, torch.zeros_like(w)))
    return wg, torch.stack(wl)


def gradients(img: torch.Tensor):
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    return gx, gy


def bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    H, W = img.shape
    y = torch.clamp(y, 0.0, H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    fy = y - y0
    fx = x - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx)


def line_frames(segs: torch.Tensor):
    """(start [N, 2], direction d [N, 2], unit dL [N, 2], normal dO)."""
    s = segs[:, 0:2]
    d = segs[:, 2:4] - s
    length = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + 1e-12)
    dL = d / length[:, None]
    dO = torch.stack([-dL[:, 1], dL[:, 0]], dim=-1)
    return s, d, dL, dO


def lbd_describe_plain(img: torch.Tensor, segs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The reference's descriptor in torch ops."""
    dev = img.device
    gx, gy = gradients(img)
    N = segs.shape[0]
    s, d, dL, dO = line_frames(segs)
    t = torch.arange(NS_ALONG, dtype=torch.float32, device=dev) * T_STEP
    off = torch.arange(ROWS, dtype=torch.float32, device=dev) \
        - (ROWS - 1) / 2.0
    base = s[:, None, None, :] + d[:, None, None, :] * t[None, None, :, None]
    pos = base + dO[:, None, None, :] * off[None, :, None, None]
    px, py = pos[..., 0].reshape(-1), pos[..., 1].reshape(-1)
    sgx = bilinear(gx, py, px).reshape(N, ROWS, NS_ALONG)
    sgy = bilinear(gy, py, px).reshape(N, ROWS, NS_ALONG)
    wg, wl = weights(dev)
    gdL = (sgx * dL[:, None, None, 0] + sgy * dL[:, None, None, 1]) \
        * wg[None, :, None]
    gdO = (sgx * dO[:, None, None, 0] + sgy * dO[:, None, None, 1]) \
        * wg[None, :, None]
    feats = []
    for j in range(M_BANDS):
        w = wl[j][None, :, None]
        vs = []
        for g in (gdO, gdL):
            vs.append(torch.sum(torch.clamp_min(g, 0.0) * w, dim=1))
            vs.append(torch.sum(torch.clamp_min(-g, 0.0) * w, dim=1))
        feats += [v.mean(dim=1) for v in vs]
        feats += [v.std(dim=1, correction=0) for v in vs]
    desc = torch.stack(feats, dim=-1)
    desc = desc / torch.sqrt((desc * desc).sum(-1, keepdim=True) + 1e-12)
    desc = torch.clamp_max(desc, 0.4)
    desc = desc / torch.sqrt((desc * desc).sum(-1, keepdim=True) + 1e-12)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def work(H: int, W: int, n_lines: int):
    """(operations, bytes) of one call: a sample's position, its two
    bilinear gradients (each corner's central difference) and two
    projections (~70 fp32 operations), each (band, column, part) summing
    its 21 rows (2 a row), the statistics and the normalizations; the
    image read once, the segments read and the descriptors written."""
    samples = n_lines * ROWS * NS_ALONG
    ops = samples * 70 + n_lines * M_BANDS * NS_ALONG * 4 * 21 * 2 \
        + n_lines * (M_BANDS * 4 * NS_ALONG * 4 + DIM * 8)
    return ops, H * W * 4 + n_lines * (16 + 1 + DIM * 4)


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lbd_describe_launch.argtypes = [ptr, i32, i32, ptr, ptr, i32, ptr,
                                        ptr, ctypes.c_float, ptr, ptr]
    lib.lbd_describe_launch.restype = ctypes.c_int
    return lib


def lbd_describe(img: torch.Tensor, segs: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, 72] of ``segs`` [N, 4] f32 on ``img`` [H, W] f32
    (at least 2 x 2).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (``lbd_describe.launches`` counts its launches)."""
    if img.dim() != 2 or min(img.shape) < 2:
        raise ValueError(f"img must be [H, W] with H, W >= 2, got "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    N = segs.shape[0]
    dev = img.device
    check_tensor("img", img, torch.float32, (H, W), dev)
    check_tensor("segs", segs, torch.float32, (N, 4), dev)
    check_tensor("valid", valid, torch.bool, (N,), dev)
    if dev.type == "cpu":
        return lbd_describe_plain(img, segs, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(N, DIM, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    img, segs, valid = img.contiguous(), segs.contiguous(), valid.contiguous()
    wg, wl = weights(dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.lbd_describe_launch(
            img.data_ptr(), H, W, segs.data_ptr(), valid.data_ptr(), N,
            wg.data_ptr(), wl.contiguous().data_ptr(), float(T_STEP),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lbd_describe launch failed: CUDA error {err}")
    _V.launches += 1
    return out


lbd_describe.launches = 0
# the count is kept on the function through this alias, so a wrapper set
# in the function's place (chip_smoke's recorders) does not hide it
_V = lbd_describe
