"""The root finder of the point-line minimal solvers, batched:
``trace_roots`` finds, per instance, all rotations with n1.(R v1) = 0,
Tr(C2 R) = 0 and Tr(C3 R) = 0.

One constraint is met exactly by the 2-angle family R(a, b) =
Rot(d(a), b) R0(a), where d(a) sweeps the great circle perpendicular to
n1 and R0(a) maps v1 to d(a).  Each trace constraint is linear in
(cos b, sin b), so Cramer's rule and cos^2 + sin^2 = 1 leave one smooth
function G(a) on the circle (:func:`family_eval`).  Its roots are found
with fixed shapes: G on a grid, the first ``n_roots`` sign changes
bisected ``n_bisect`` times, and the ``n_roots`` interior local minima
of |G| with the smallest |G| (near-double roots) refined by as many
ternary steps.

``trace_roots`` launches ``csrc/trace_roots.cu`` on CUDA tensors (one
thread an instance, the grid of G in local memory) and takes
:func:`trace_roots_plain` on CPU tensors.  The grid is an input: it must
be the f32 grid the JAX package's solvers use (:func:`alpha_grid`), since
a last-place difference at a grid point can flip a sign test.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from limap_tpu_torch.base.pose import cross, quat_to_rotmat

_EPS = 1e-12
SOURCE = "trace_roots.cu"
MAX_GRID = 1024   # grid intervals the kernel holds in local memory
MAX_ROOTS = 8


def alpha_grid(n_grid: int) -> np.ndarray:
    """The f32 grid of ``jnp.linspace(-pi, pi, n_grid + 1)`` as the JAX
    package's jitted solvers see it, bit for bit: XLA folds the constant
    as start * (1 - s) + stop * s with s = i / n_grid, each product
    rounded to f32 (eager jnp.linspace fuses the second product into an
    FMA instead, and differs in the last place)."""
    f32 = np.float32
    s = np.arange(n_grid, dtype=f32) / f32(n_grid)
    out = (-f32(np.pi)) * (f32(1.0) - s) + f32(np.pi) * s
    return np.concatenate([out, [f32(np.pi)]]).astype(f32)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)


def any_perp(v: torch.Tensor) -> torch.Tensor:
    """A unit vector perpendicular to v (branch-free)."""
    ex = v.new_tensor([1.0, 0.0, 0.0]).expand(v.shape)
    ey = v.new_tensor([0.0, 1.0, 0.0]).expand(v.shape)
    ref = torch.where((torch.abs(v[..., 0]) > 0.9)[..., None], ey, ex)
    return normalize(cross(v, ref))


def skew(d: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(d[..., 0])
    return torch.stack([
        torch.stack([z, -d[..., 2], d[..., 1]], dim=-1),
        torch.stack([d[..., 2], z, -d[..., 0]], dim=-1),
        torch.stack([-d[..., 1], d[..., 0], z], dim=-1)], dim=-2)


def rot_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation R with R a = b for unit vectors (quaternion form), a
    pi-rotation about a perpendicular axis when a ~ -b."""
    v = cross(a, b)
    w = 1.0 + torch.sum(a * b, dim=-1)
    degen = w < 1e-6
    qv = torch.where(degen[..., None], any_perp(a), v)
    qw = torch.where(degen, torch.zeros_like(w), w)
    q = torch.cat([qw[..., None], qv], dim=-1)
    return quat_to_rotmat(
        q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS))


def rot_axis_angle(d: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about the unit axis d by beta."""
    K = skew(d)
    eye = torch.eye(3, dtype=d.dtype, device=d.device).expand(K.shape)
    s = torch.sin(beta)[..., None, None]
    c = torch.cos(beta)[..., None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def trace_coeffs(M: torch.Tensor, d: torch.Tensor):
    """f(b) = Tr(M Rot(d, b)) = a cos(b) + s sin(b) + c."""
    trM = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    dMd = torch.einsum("...i,...ij,...j->...", d, M, d)
    sK = torch.einsum("...ij,...ji->...", M, skew(d))
    return trM - dMd, sK, dMd


def family_eval(alpha, v1, n1, C2, C3):
    """The root function G(alpha) = Nc^2 + Ns^2 - det^2 of the family,
    with Nc = c3 b2 - c2 b3, Ns = c2 a3 - c3 a2, det = a2 b3 - a3 b2
    (the 2x2 system in (cos b, sin b) by Cramer).  ``alpha`` [...]
    broadcasts against the data's batch.  Returns (G, beta, det, d,
    R0)."""
    u = any_perp(n1)
    w = cross(n1, u)
    d = torch.cos(alpha)[..., None] * u + torch.sin(alpha)[..., None] * w
    R0 = rot_between(v1.expand(d.shape), d)
    a2, b2, c2 = trace_coeffs(R0 @ C2, d)
    a3, b3, c3 = trace_coeffs(R0 @ C3, d)
    det = a2 * b3 - a3 * b2
    Nc = c3 * b2 - c2 * b3
    Ns = c2 * a3 - c3 * a2
    G = Nc * Nc + Ns * Ns - det * det
    # beta of the Cramer solution; atan2 ignores the positive scale det^2
    beta = torch.atan2(Ns * det, Nc * det)
    return G, beta, det, d, R0


def trace_roots_plain(v1, n1, C2, C3, alphas, n_bisect: int = 48,
                      n_roots: int = 8):
    """v1, n1 [B, 3], C2, C3 [B, 3, 3] (normalized), alphas [n_grid + 1].
    Returns (R [B, 2 n_roots, 3, 3], ok [B, 2 n_roots])."""
    B = v1.shape[0]
    data = (v1[:, None], n1[:, None], C2[:, None], C3[:, None])

    def geval(alpha):
        return family_eval(alpha, *data)

    G, _, det, _, _ = geval(alphas.expand(B, -1))          # [B, K]
    g_scale = torch.abs(G).amax(1, keepdim=True) + _EPS
    det_scale = torch.abs(det).amax(1, keepdim=True) + _EPS

    # simple roots: the first n_roots grid sign changes, bisected; missing
    # ones are index 0, whose flag is the sign test of cell 0, as
    # jnp.nonzero(size=n_roots, fill_value=0) leaves them
    sc = G[:, :-1] * G[:, 1:] < 0.0
    idx = torch.argsort((~sc).to(torch.int8), dim=1, stable=True)[:, :n_roots]
    idx = torch.where(torch.gather(sc, 1, idx), idx, torch.zeros_like(idx))
    ok = torch.gather(sc, 1, idx)
    lo, hi, glo = alphas[idx], alphas[idx + 1], torch.gather(G, 1, idx)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gm = geval(mid)[0]
        take_lo = glo * gm < 0.0
        hi = torch.where(take_lo, mid, hi)
        lo = torch.where(take_lo, lo, mid)
        glo = torch.where(take_lo, glo, gm)
    root = 0.5 * (lo + hi)

    # (near-)double roots: the interior local minima of |G| with the
    # smallest |G|, refined by ternary search on G^2
    absG = torch.abs(G)
    ext = (absG[:, 1:-1] <= absG[:, :-2]) & (absG[:, 1:-1] <= absG[:, 2:])
    cand = torch.where(ext, absG[:, 1:-1], torch.full_like(absG[:, 1:-1],
                                                           float("inf")))
    eidx = torch.argsort(cand, dim=1, stable=True)[:, :n_roots]
    e_ok = torch.gather(ext, 1, eidx)
    elo, ehi = alphas[eidx], alphas[eidx + 2]
    for _ in range(n_bisect):
        m1 = elo + (ehi - elo) / 3.0
        m2 = ehi - (ehi - elo) / 3.0
        take = geval(m1)[0] ** 2 < geval(m2)[0] ** 2
        ehi = torch.where(take, m2, ehi)
        elo = torch.where(take, elo, m1)
    eroot = 0.5 * (elo + ehi)
    e_ok = e_ok & (torch.abs(geval(eroot)[0]) < 1e-2 * g_scale)

    root = torch.cat([root, eroot], dim=1)
    ok = torch.cat([ok, e_ok], dim=1)
    _, beta, det_r, d, R0 = geval(root)
    ok = ok & (torch.abs(det_r) > 1e-9 * det_scale)
    R = rot_axis_angle(d, beta) @ R0
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    R = torch.where(finite[..., None, None], R, eye)
    return R, ok & finite


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.trace_roots_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                       i64, i64, ptr, ptr, ptr]
    lib.trace_roots_launch.restype = ctypes.c_int
    return lib


def trace_roots(v1, n1, C2, C3, alphas, n_bisect: int = 48,
                n_roots: int = 8):
    """:func:`trace_roots_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (``trace_roots.launches`` counts its launches)."""
    args = (v1, n1, C2, C3, alphas)
    for name, t, shape in zip(("v1", "n1", "C2", "C3"), args,
                              ((3,), (3,), (3, 3), (3, 3))):
        if t.dtype != torch.float32 or tuple(t.shape[1:]) != shape \
                or t.shape[0] != v1.shape[0] or t.device != v1.device:
            raise ValueError(f"{name}: fp32 [B, {shape}] on {v1.device} "
                             f"expected, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if alphas.dim() != 1 or alphas.dtype != torch.float32:
        raise ValueError("alphas must be an fp32 [n_grid + 1] grid")
    if v1.device.type == "cpu":
        return trace_roots_plain(v1, n1, C2, C3, alphas.to(v1.device),
                                 n_bisect, n_roots)
    n_grid = alphas.shape[0] - 1
    if not n_roots < n_grid <= MAX_GRID or not 1 <= n_roots <= MAX_ROOTS:
        raise ValueError(f"the kernel takes 1..{MAX_ROOTS} roots and more"
                         f" grid intervals, at most {MAX_GRID}, got {n_grid}, {n_roots}")
    B = v1.shape[0]
    R = torch.empty((B, 2 * n_roots, 3, 3), dtype=torch.float32,
                    device=v1.device)
    ok = torch.empty((B, 2 * n_roots), dtype=torch.bool, device=v1.device)
    if B == 0:
        return R, ok
    v1, n1, C2, C3, alphas = (t.contiguous() for t in
                              (v1, n1, C2, C3, alphas.to(v1.device)))
    with torch.cuda.device(v1.device):
        err = build().trace_roots_launch(
            v1.data_ptr(), n1.data_ptr(), C2.data_ptr(), C3.data_ptr(),
            alphas.data_ptr(), B, n_grid, n_bisect, n_roots, R.data_ptr(),
            ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"trace_roots launch failed: CUDA error {err}")
    trace_roots.launches += 1
    return R, ok


trace_roots.launches = 0
