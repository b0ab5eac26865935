"""Kernel S: bilinear sampling of a dense descriptor grid, each sampled
descriptor L2-normalized.

``sample_descriptors(grid, points, mode, scale)`` takes the grid
[Hc, Wc, D] f32 (channels last) and points [P, 2], and returns [P, D]
f32.  Two modes:

- ``"clamp"`` (SuperPoint, ``scale`` = the stride 8): points f32 (x, y)
  in pixels; the cell clipped into the grid and the fractions to [0, 1],
  float32, divided by the norm + 1e-8;
- ``"zero"`` (SOLD2, ``scale`` = the grid size 4): points f64 (h, w) in
  pixels; grid_sample semantics with align_corners=False, corners outside
  the grid weighted 0, float64, divided by the norm + 1e-12 and rounded
  to float32.

CUDA tensors launch ``csrc/sample_descriptors.cu``; CPU tensors take
:func:`sample_clamp_plain` / :func:`sample_zero_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from limap_tpu_torch.ops.cuda_build import load_library

SOURCE = "sample_descriptors.cu"
MODES = {"clamp": (0, torch.float32), "zero": (1, torch.float64)}
MAX_CHANNELS = 512


def sample_clamp_plain(grid: torch.Tensor, pts: torch.Tensor,
                       stride: float = 8) -> torch.Tensor:
    """SuperPoint's sampler (the reference's, op for op)."""
    Hc, Wc, D = grid.shape
    x = pts[:, 0] / stride - 0.5
    y = pts[:, 1] / stride - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, Wc - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, Hc - 2)
    fx = torch.clamp(x - x0.to(x.dtype), 0, 1)[:, None]
    fy = torch.clamp(y - y0.to(y.dtype), 0, 1)[:, None]
    d = (grid[y0, x0] * (1 - fx) * (1 - fy)
         + grid[y0, x0 + 1] * fx * (1 - fy)
         + grid[y0 + 1, x0] * (1 - fx) * fy
         + grid[y0 + 1, x0 + 1] * fx * fy)
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)


def sample_zero_plain(grid: torch.Tensor, pts: torch.Tensor,
                      grid_size: float = 4) -> torch.Tensor:
    """SOLD2's line-point sampler: grid_sample(align_corners=False) with
    zero padding, in float64, then rounded to float32."""
    Hc, Wc, D = grid.shape
    u = pts.to(torch.float64) / grid_size - 0.5
    h0 = torch.floor(u[:, 0]).to(torch.int64)
    w0 = torch.floor(u[:, 1]).to(torch.int64)
    fh = u[:, 0] - h0.to(torch.float64)
    fw = u[:, 1] - w0.to(torch.float64)

    def get(hh, ww):
        ok = (hh >= 0) & (hh < Hc) & (ww >= 0) & (ww < Wc)
        v = grid[torch.clamp(hh, 0, Hc - 1), torch.clamp(ww, 0, Wc - 1)]
        return (v * ok[:, None]).to(torch.float64)

    d = (get(h0, w0) * ((1 - fh) * (1 - fw))[:, None]
         + get(h0, w0 + 1) * ((1 - fh) * fw)[:, None]
         + get(h0 + 1, w0) * (fh * (1 - fw))[:, None]
         + get(h0 + 1, w0 + 1) * (fh * fw)[:, None])
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-12)
    return d.to(torch.float32)


def corner_cells(grid_shape, pts: torch.Tensor, mode: str,
                 scale: float) -> torch.Tensor:
    """Flat indices (h * Wc + w) of the distinct grid cells whose rows
    the kernel reads for ``pts``: the four corners of each point, clipped
    into the grid in clamp mode, those inside it in zero mode."""
    Hc, Wc = grid_shape[:2]
    if mode == "clamp":
        p = pts.to(torch.float32)
        x0 = torch.clamp(torch.floor(p[:, 0] / scale - 0.5).to(torch.int64),
                         0, Wc - 2)
        y0 = torch.clamp(torch.floor(p[:, 1] / scale - 0.5).to(torch.int64),
                         0, Hc - 2)
    else:
        u = pts.to(torch.float64) / scale - 0.5
        y0 = torch.floor(u[:, 0]).to(torch.int64)
        x0 = torch.floor(u[:, 1]).to(torch.int64)
    h = torch.stack([y0, y0, y0 + 1, y0 + 1], 1).reshape(-1)
    w = torch.stack([x0, x0 + 1, x0, x0 + 1], 1).reshape(-1)
    ok = (h >= 0) & (h < Hc) & (w >= 0) & (w < Wc)
    return torch.unique(h[ok] * Wc + w[ok])


def work(grid: torch.Tensor, pts: torch.Tensor, mode: str, scale: float):
    """(operations, bytes) of one call on these inputs: 4 products and 3
    sums for the corners plus 2 for the norm a channel (float64 in zero
    mode, counted as two fp32 operations each); the points read, each
    distinct corner row read once (:func:`corner_cells`, at most the
    grid) and one row written a point."""
    P, D = pts.shape[0], grid.shape[2]
    ops = 9 * P * D * (2 if mode == "zero" else 1)
    rows = corner_cells(grid.shape, pts, mode, scale).numel()
    return ops, P * pts.element_size() * 2 + rows * D * 4 + P * D * 4


def build() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sample_descriptors_launch.argtypes = [ptr, i32, i32, i32, ptr, i32,
                                              i32, ctypes.c_double, ptr, ptr]
    lib.sample_descriptors_launch.restype = ctypes.c_int
    return lib


def sample_descriptors(grid: torch.Tensor, pts: torch.Tensor,
                       mode: str = "clamp", scale: float = 8
                       ) -> torch.Tensor:
    """[P, D] descriptors of ``grid`` [Hc, Wc, D] f32 at ``pts`` [P, 2]
    (f32 in clamp mode, f64 in zero mode).  CPU tensors take the plain
    version; CUDA tensors launch the kernel
    (``sample_descriptors.launches`` counts its launches)."""
    code, pdtype = MODES[mode]
    if grid.dtype != torch.float32 or grid.dim() != 3:
        raise ValueError(f"grid must be [Hc, Wc, D] float32, got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if pts.dtype != pdtype or pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"{mode} mode takes points [P, 2] {pdtype}, got "
                         f"{pts.dtype} {tuple(pts.shape)}")
    if pts.device != grid.device:
        raise ValueError(f"grid on {grid.device}, points on {pts.device}")
    Hc, Wc, D = grid.shape
    if mode == "clamp" and (Hc < 2 or Wc < 2):
        raise ValueError(f"clamp mode needs a grid of at least 2 x 2, got "
                         f"{Hc} x {Wc}")
    if grid.device.type == "cpu":
        plain = sample_clamp_plain if mode == "clamp" else sample_zero_plain
        return plain(grid, pts, scale)
    if grid.device.type != "cuda":
        raise ValueError(f"unsupported device {grid.device}")
    if D > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {D}")
    grid, pts = grid.contiguous(), pts.contiguous()
    P = pts.shape[0]
    out = torch.empty(P, D, dtype=torch.float32, device=grid.device)
    if P == 0:
        return out
    lib = build()
    with torch.cuda.device(grid.device):
        err = lib.sample_descriptors_launch(
            grid.data_ptr(), Hc, Wc, D, pts.data_ptr(), P, code,
            float(scale), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sample_descriptors launch failed: CUDA error "
                           f"{err}")
    sample_descriptors.launches += 1
    return out


sample_descriptors.launches = 0
