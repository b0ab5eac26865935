"""Kernel K: the line refinement, a whole LM solve in one launch.

``solve`` takes T tracks' minimal lines ``params0 [T, 6]``, a
:class:`RefineData` of their padded supports and terms, and the
:class:`RefineTerms` that say which terms run with which weights.  Each
track's residual, in this order:

1. the geometric term of every support (the line BA's, with the IRLS
   weight of its detached residual), where ``use_geometric``;
2. the VP term: the sine between the line's direction in the support's
   camera and the support's VP direction ``[T, S, 3]``, weight ``vp_w``;
3. the heatmap term (``use_heatmap``): the A anchors of each support's
   patch ``[T, S, A, P]`` dropped perpendicularly onto the projected
   line, one minus the patch sampled bilinearly at each foot;
4. the feature-consistency term (``use_fconsis``): per (track, term) the
   line projected into a reference and a target view, the reference
   view's sample line intersected with it, the epipolar line of that
   point intersected with the target projection, and the C channels of
   both patches ``[T, F, P, P, C]`` sampled there, target minus
   reference.

CUDA tensors launch ``csrc/lm_line_refine.cu`` (one warp a track, Jets
for the Jacobian); CPU tensors take :func:`solve_plain`, the eager
``lm_solve`` with :func:`refine_residual`.  :func:`normal_equations` is
the check entry (0 iterations).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.infinite_line import (infline2d_point_projection,
                                                line_world_to_pixel,
                                                minimal_to_plucker)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.ops.cuda_build import check_tensor
from limap_tpu_torch.optimize import lm

SOURCE = "lm_line_refine.cu"
D, P = 4, 6
TRACE_WIDTH = 2 + 2 * P


class RefineData(NamedTuple):
    """The inputs of a refinement solve (T tracks, S supports, F
    feature-consistency terms, N views)."""

    kvec: torch.Tensor          # [T, S, 4] the supports' views
    qvec: torch.Tensor          # [T, S, 4]
    tvec: torch.Tensor          # [T, S, 3]
    p_start: torch.Tensor       # [T, S, 2] the 2D segments
    p_end: torch.Tensor         # [T, S, 2]
    weights: torch.Tensor       # [T, S] (0: no geometric / heatmap term)
    vps: torch.Tensor           # [T, S, 3] homogeneous pixels
    vp_w: torch.Tensor          # [T, S]
    hm_patch: torch.Tensor      # [T, S, A, P]
    hm_origin: torch.Tensor     # [T, S, 2]
    hm_u: torch.Tensor          # [T, S, 2]
    hm_v: torch.Tensor          # [T, S, 2]
    hm_len: torch.Tensor        # [T, S]
    views_k: torch.Tensor       # [N, 4] every view
    views_q: torch.Tensor       # [N, 4]
    views_t: torch.Tensor       # [N, 3]
    fc_ref: torch.Tensor        # [T, F] int32 view rows
    fc_tgt: torch.Tensor        # [T, F] int32
    fc_coords: torch.Tensor     # [T, F, 3] the reference sample lines
    fc_ref_patch: torch.Tensor  # [T, F, Pp, Pp, C]
    fc_tgt_patch: torch.Tensor  # [T, F, Pp, Pp, C]
    fc_ref_origin: torch.Tensor  # [T, F, 2]
    fc_tgt_origin: torch.Tensor  # [T, F, 2]
    fc_w: torch.Tensor          # [T, F]


# the full views, data that every row shares
SHARED = (13, 14, 15)


@dataclasses.dataclass(frozen=True)
class RefineTerms:
    """Which terms a solve runs and their constants."""

    use_geometric: bool = True
    use_heatmap: bool = False
    use_fconsis: bool = False
    geometric_alpha: float = 10.0
    loss: str = "cauchy"
    loss_scale: float = 0.25
    heatmap_multiplier: float = 1.0
    fconsis_multiplier: float = 1.0


def sample_patches(patch: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of per-item patches: patch [B, H, W, C], x and y
    [B, K] (column, row) -> [B, K, C], as ``interpolate_bilinear``."""
    B, H, W, _ = patch.shape
    x0 = torch.clamp(torch.floor(x.detach()), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(y.detach()), 0, H - 2).long()
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    b = torch.arange(B, device=patch.device)[:, None]
    return (patch[b, y0, x0] * (1 - fx) * (1 - fy)
            + patch[b, y0, x0 + 1] * fx * (1 - fy)
            + patch[b, y0 + 1, x0] * (1 - fx) * fy
            + patch[b, y0 + 1, x0 + 1] * fx * fy)


def heatmap_coords(coor, origin, u_axis, v_axis, length, A: int, Pn: int,
                   perp_spacing: float = 1.0):
    """The patch coordinates (pa along, pb across) [..., A] of the
    perpendicular feet of a patch's A anchors on the projected line
    ``coor`` [..., 3]."""
    # the anchors' positions along the segment, i / (A - 1) as the kernel
    # computes them
    t = torch.arange(A, dtype=coor.dtype, device=coor.device) / max(A - 1, 1)
    anchors = origin[..., None, :] + t[:, None] * u_axis[..., None, :] \
        * length[..., None, None]
    feet = infline2d_point_projection(coor[..., None, :], anchors)
    rel = feet - origin[..., None, :]
    pa = torch.sum(rel * u_axis[..., None, :], -1) \
        / torch.clamp(length, min=1e-8)[..., None] * (A - 1)
    pb = torch.sum(rel * v_axis[..., None, :], -1) / perp_spacing \
        + (Pn - 1) / 2.0
    return pa, pb


def heatmap_residual(coor, origin, u_axis, v_axis, length, patch,
                     perp_spacing: float = 1.0, offset=None):
    """One minus the heatmap patch at the perpendicular feet of its
    anchors on the projected line, 0 outside the patch: coor [..., 3],
    origin / u / v [..., 2], length [...], patch [..., A, P] -> [..., A].
    ``offset`` (pa, pb) [..., A] moves the feet's patch coordinates (the
    checks' corner alternatives)."""
    A, Pn = patch.shape[-2], patch.shape[-1]
    pa, pb = heatmap_coords(coor, origin, u_axis, v_axis, length, A, Pn,
                            perp_spacing)
    if offset is not None:
        pa, pb = pa + offset[0], pb + offset[1]
    inside = (pa >= 0) & (pa <= A - 1) & (pb >= 0) & (pb <= Pn - 1)
    lead = patch.shape[:-2]
    vals = sample_patches(patch.reshape(-1, A, Pn, 1), pb.reshape(-1, A),
                          pa.reshape(-1, A))[..., 0].reshape(lead + (A,))
    return torch.where(inside, 1.0 - vals, torch.zeros_like(vals))


def fconsis_points(uvec, wvec, views: CameraViewsBatch, ref_view, tgt_view,
                   coords):
    """The feature term's two points [T, F, 2]: the line's intersection
    with the reference sample line, and the target projection's
    intersection with that point's epipolar line."""
    from limap_tpu_torch.triangulation.functions import epipolar_line
    d, m = minimal_to_plucker(uvec, wvec)
    T, F = coords.shape[:2]
    vref, vtgt = views.select(ref_view), views.select(tgt_view)
    db = d[:, None].expand(T, F, 3)
    mb = m[:, None].expand(T, F, 3)
    coor_ref = line_world_to_pixel(vref.kvec, vref.qvec, vref.tvec, db, mb)
    x_ref_h = cross(coor_ref, coords)
    x_ref = x_ref_h[..., :2] / (x_ref_h[..., 2:3] + 1e-12)
    epl = epipolar_line(vref, vtgt, x_ref)
    coor_tgt = line_world_to_pixel(vtgt.kvec, vtgt.qvec, vtgt.tvec, db, mb)
    x_tgt_h = cross(coor_tgt, epl)
    return x_ref, x_tgt_h[..., :2] / (x_tgt_h[..., 2:3] + 1e-12)


def fconsis_residual(uvec, wvec, views: CameraViewsBatch, ref_view,
                     tgt_view, coords, ref_patch, tgt_patch, ref_origin,
                     tgt_origin, offsets=None):
    """Target minus reference features [T, F, C] at the line's
    intersections with the reference sample line and with the epipolar
    line of that point in the target view; 0 where either falls outside
    its patch.  uvec [T, 4], wvec [T, 2]; the rest [T, F, ...];
    ``offsets`` (ref, tgt) [T, F, 2] move the two points (the checks'
    corner alternatives)."""
    x_ref, x_tgt = fconsis_points(uvec, wvec, views, ref_view, tgt_view,
                                  coords)
    if offsets is not None:
        x_ref, x_tgt = x_ref + offsets[0], x_tgt + offsets[1]
    T, F = coords.shape[:2]
    Pp, C = ref_patch.shape[-2], ref_patch.shape[-1]

    def sample(patch, origin, xy):
        local = xy - origin                                 # (x, y)
        inside = torch.all((local >= 0) & (local <= Pp - 1), -1)
        vals = sample_patches(patch.reshape(T * F, Pp, Pp, C),
                              local[..., 0].reshape(T * F, 1),
                              local[..., 1].reshape(T * F, 1))
        return vals.reshape(T, F, C), inside

    f_ref, in_ref = sample(ref_patch, ref_origin, x_ref)
    f_tgt, in_tgt = sample(tgt_patch, tgt_origin, x_tgt)
    ok = (in_ref & in_tgt)[..., None]
    return torch.where(ok, f_tgt - f_ref, torch.zeros_like(f_ref))


def refine_residual(terms: RefineTerms, offsets: bool = False):
    """Batched residual: params [T, 6] and the fields of
    :class:`RefineData` (the views with a leading [1], :func:`plain_aux`)
    -> [T, R], the terms in the module's order.  With ``offsets`` four
    more inputs follow, the moves of the samples' patch coordinates
    (heatmap pa and pb [T, S, A], feature ref and tgt points [T, F, 2])."""
    from limap_tpu_torch.optimize import residuals as res
    from limap_tpu_torch.optimize.line_ba import (robust_weight,
                                                  unpack_minimal_lines)
    n = len(RefineData._fields)

    def residual(params, *data):
        x = RefineData(*data[:n])
        off = data[n:] if offsets else (None,) * 4
        T = params.shape[0]
        line = unpack_minimal_lines(params)
        uvec, wvec = line.uvec[:, None], line.wvec[:, None]
        views = CameraViewsBatch(x.kvec, x.qvec, x.tvec)
        w = x.weights
        rs = []
        if terms.use_geometric:
            r = res.line_geometric_residual(
                uvec, wvec, views, Segments(x.p_start, x.p_end),
                terms.geometric_alpha)                          # [T, S, 2]
            valid = (w > 0)[..., None]
            r = torch.where(valid, r, torch.zeros_like(r))
            rw = robust_weight(torch.sum(r * r, -1).detach(), terms.loss,
                               terms.loss_scale)
            scale = torch.sqrt(w * rw + 1e-12)[..., None]
            rs.append(torch.where(valid, r * scale,
                                  torch.zeros_like(r)).reshape(T, -1))
        r_vp = res.vp_constraint_residual(uvec, wvec, views, x.vps)
        rs.append(torch.where(x.vp_w > 0, r_vp * torch.sqrt(x.vp_w + 1e-12),
                              torch.zeros_like(r_vp)))
        if terms.use_heatmap:
            d, m = minimal_to_plucker(line.uvec, line.wvec)
            S = w.shape[1]
            coor = line_world_to_pixel(
                x.kvec, x.qvec, x.tvec, d[:, None].expand(T, S, 3),
                m[:, None].expand(T, S, 3))                      # [T, S, 3]
            r_hm = heatmap_residual(
                coor, x.hm_origin, x.hm_u, x.hm_v, x.hm_len, x.hm_patch,
                offset=None if off[0] is None else off[:2])      # [T, S, A]
            hw = (w > 0)[..., None] * terms.heatmap_multiplier
            rs.append((r_hm * torch.sqrt(hw + 1e-12) * (hw > 0))
                      .reshape(T, -1))
        if terms.use_fconsis:
            r_fc = fconsis_residual(
                line.uvec, line.wvec,
                CameraViewsBatch(x.views_k[0], x.views_q[0], x.views_t[0]),
                x.fc_ref,
                x.fc_tgt, x.fc_coords, x.fc_ref_patch, x.fc_tgt_patch,
                x.fc_ref_origin, x.fc_tgt_origin,
                offsets=None if off[2] is None else off[2:])     # [T, F, C]
            fw = x.fc_w[..., None] * terms.fconsis_multiplier
            rs.append((r_fc * torch.sqrt(fw + 1e-12) * (fw > 0))
                      .reshape(T, -1))
        return torch.cat(rs, 1)

    return residual


def plain_aux(data: RefineData):
    """The plain residual's aux: the full views with a leading [1]."""
    return tuple(t[None] if i in SHARED else t for i, t in enumerate(data))


def solve_plain(params0, data: RefineData, terms: RefineTerms,
                num_iterations=20, trace=None):
    """The eager LM on ``data``; ``trace`` as ``lm_solve`` takes it."""
    return lm.lm_solve(params0, refine_residual(terms), lm.retract_quat_so2,
                       D, plain_aux(data), num_iterations=num_iterations,
                       trace=trace)


def normal_equations_plain(params0, data: RefineData, terms: RefineTerms):
    return lm.normal_equations(params0, refine_residual(terms),
                               lm.retract_quat_so2, D, plain_aux(data))


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    # params0, the 24 inputs, dims (T, S, A, Pa, N, F, Pp, C), flags,
    # hp, loss, n_iter, params, cost0, cost, n_acc, trace, ne, stream
    lib.lm_line_refine_launch.argtypes = [ptr] * 25 + [i64] * 8 + [i64] \
        + [ptr] + [i64] * 2 + [ptr] * 7
    lib.lm_line_refine_launch.restype = ctypes.c_int
    return lib


def check(params0, data: RefineData):
    """The shapes, types and device the kernel takes; returns (T, S, A,
    Pa, N, F, Pp, C)."""
    T, dev = params0.shape[0], params0.device
    S = data.weights.shape[1]
    A, Pa = data.hm_patch.shape[2:]
    N = data.views_k.shape[0]
    F = data.fc_w.shape[1]
    Pp, C = data.fc_ref_patch.shape[3:]
    f32, i32 = torch.float32, torch.int32
    check_tensor("params0", params0, f32, (T, P), dev)
    shapes = dict(kvec=(T, S, 4), qvec=(T, S, 4), tvec=(T, S, 3),
                  p_start=(T, S, 2), p_end=(T, S, 2), weights=(T, S),
                  vps=(T, S, 3), vp_w=(T, S), hm_patch=(T, S, A, Pa),
                  hm_origin=(T, S, 2), hm_u=(T, S, 2), hm_v=(T, S, 2),
                  hm_len=(T, S), views_k=(N, 4), views_q=(N, 4),
                  views_t=(N, 3), fc_ref=(T, F), fc_tgt=(T, F),
                  fc_coords=(T, F, 3), fc_ref_patch=(T, F, Pp, Pp, C),
                  fc_tgt_patch=(T, F, Pp, Pp, C), fc_ref_origin=(T, F, 2),
                  fc_tgt_origin=(T, F, 2), fc_w=(T, F))
    for name, t in zip(RefineData._fields, data):
        check_tensor(name, t, i32 if name in ("fc_ref", "fc_tgt") else f32,
                     shapes[name], dev)
    return T, S, A, Pa, N, F, Pp, C


def _launch(params0, data, terms, num_iterations, trace, ne):
    dims = check(params0, data)
    T, dev = dims[0], params0.device
    if terms.loss not in lm.LOSSES:
        raise ValueError(f"unknown loss {terms.loss}")
    if terms.use_fconsis and not (dims[6] >= 2 and dims[7] >= 1):
        raise ValueError("feature-consistency patches of at least 2 x 2 "
                         "texels and one channel expected")
    if terms.use_heatmap and not (dims[2] >= 2 and dims[3] >= 2):
        raise ValueError("heatmap patches of at least 2 x 2 expected")
    s = float(terms.loss_scale)
    hp = np.asarray((terms.geometric_alpha, s, s * s) + lm.LAMBDAS
                    + (terms.heatmap_multiplier, terms.fconsis_multiplier),
                    np.float32)
    flags = (int(terms.use_geometric) | int(terms.use_heatmap) << 1
             | int(terms.use_fconsis) << 2)
    out = lm.LMResult(torch.empty((T, P), dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.float32, device=dev),
                      torch.empty(T, dtype=torch.int32, device=dev))
    tr = torch.empty((T, num_iterations, TRACE_WIDTH), dtype=torch.float32,
                     device=dev) if trace else None
    ne_out = torch.empty((T, D * D + D + 1), dtype=torch.float32,
                         device=dev) if ne else None
    if T:
        args = [t.contiguous() for t in (params0,) + tuple(data)]
        with torch.cuda.device(dev):
            err = build().lm_line_refine_launch(
                *(t.data_ptr() for t in args), *dims, flags, hp.ctypes.data,
                lm.LOSSES.index(terms.loss), num_iterations,
                *(t.data_ptr() for t in out),
                None if tr is None else tr.data_ptr(),
                None if ne_out is None else ne_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"lm_line_refine launch failed: CUDA error {err}")
    return out, tr, ne_out


def solve(params0, data: RefineData, terms: RefineTerms,
          num_iterations=20, trace=False):
    """The LMResult of the refinement; with ``trace`` also the
    per-iteration rows [T, num_iterations, 2 + 2P] (cost, new cost,
    params, new params).  ``solve.launches`` counts the kernel's
    launches."""
    check(params0, data)
    if params0.device.type == "cpu":
        rows = [] if trace else None
        res = solve_plain(params0, data, terms, num_iterations, rows)
        if not trace:
            return res
        return res, (torch.stack(rows, 1) if rows else torch.zeros(
            (params0.shape[0], 0, TRACE_WIDTH)))
    res, tr, _ = _launch(params0, data, terms, num_iterations, trace, False)
    _COUNTER.launches += 1
    return (res, tr) if trace else res


solve.launches = 0
_COUNTER = solve   # stays this function when ``solve`` is wrapped


def normal_equations(params0, data: RefineData, terms: RefineTerms):
    """(J^T J [T, 4, 4], J^T r [T, 4], cost [T]) at ``params0``: the
    kernel's on the card (0 iterations), the plain ``jvp``'s on the CPU."""
    T = check(params0, data)[0]
    if params0.device.type == "cpu":
        return normal_equations_plain(params0, data, terms)
    _, _, ne = _launch(params0, data, terms, 0, False, True)
    return (ne[:, :D * D].reshape(T, D, D), ne[:, D * D:D * D + D],
            ne[:, -1])
