"""Pose-only optimization from point and line correspondences: the line
localization cost functions (six residuals, five weights) and the joint
point+line solve of many poses at once, on the card by kernel I
(``ops/lm_jointloc.py``, one launch a solve) and on the CPU by
:func:`lm_solve` with :func:`_jointloc_residual`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.line_geometry import project_segments
from limap_tpu_torch.base.lines import EPS, Segments
from limap_tpu_torch.base.pose import cross
from limap_tpu_torch.ops import lm_jointloc
from limap_tpu_torch.optimize.line_ba import robust_weight

COST_FUNCTIONS = ("2d_midpoint_dist2", "2d_midpoint_angle_dist3",
                  "2d_perpendicular_dist2", "2d_perpendicular_dist4",
                  "3d_line_line_dist2", "3d_plane_line_dist2")
COST_WEIGHTS = ("none", "cosine", "line3dpp", "length", "invlength")

# the reference's enum and user-facing names -> ours
_COST_ALIASES = {
    "E2DMidpointDist2": "2d_midpoint_dist2",
    "E2DMidpointAngleDist3": "2d_midpoint_angle_dist3",
    "E2DPerpendicularDist2": "2d_perpendicular_dist2",
    "E2DPerpendicularDist4": "2d_perpendicular_dist4",
    "E3DLineLineDist2": "3d_line_line_dist2",
    "E3DPlaneLineDist2": "3d_plane_line_dist2",
    "ENoneWeight": "none", "ECosineWeight": "cosine",
    "ELine3dppWeight": "line3dpp", "ELengthWeight": "length",
    "EInvLengthWeight": "invlength",
    "MidpointDist": "2d_midpoint_dist2",
    "MidpointDist2": "2d_midpoint_dist2",
    "2DMidpointDist": "2d_midpoint_dist2",
    "2DMidpointDist2": "2d_midpoint_dist2",
    "MidpointAngle": "2d_midpoint_angle_dist3",
    "MidpointAngleDist": "2d_midpoint_angle_dist3",
    "2DMidpointAngleDist": "2d_midpoint_angle_dist3",
    "PerpendicularDist": "2d_perpendicular_dist2",
    "PerpendicularDist2": "2d_perpendicular_dist2",
    "2DPerpendicularDist": "2d_perpendicular_dist2",
    "2DPerpendicularDist2": "2d_perpendicular_dist2",
    "PerpendicularDist4": "2d_perpendicular_dist4",
    "2DPerpendicularDist4": "2d_perpendicular_dist4",
    "3DLineLineDist": "3d_line_line_dist2",
    "3DLineLineDist2": "3d_line_line_dist2",
    "3DPlaneLineDist": "3d_plane_line_dist2",
    "3DPlaneLineDist2": "3d_plane_line_dist2",
    "Cosine": "cosine", "Line3dpp": "line3dpp", "Length": "length",
    "InvLength": "invlength",
}


@dataclasses.dataclass(frozen=True)
class LineLocConfig:
    """The line localization options (cost, weight, robust loss)."""

    cost_function: str = "2d_perpendicular_dist2"
    cost_function_weight: str = "none"
    weight_point: float = 1.0
    weight_line: float = 1.0
    loss: str = "trivial"
    loss_scale: float = 1.0
    max_num_iterations: int = 100
    alpha: float = 10.0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LineLocConfig":
        if d is None:
            return cls()
        d = {k: _COST_ALIASES.get(v, v) if isinstance(v, str) else v
             for k, v in d.items()}
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _weight_2d(weight_type: str, proj_dir: torch.Tensor, l2d: Segments,
               alpha: float) -> torch.Tensor:
    """The 2D weight of a line correspondence."""
    if weight_type == "none":
        return torch.ones_like(l2d.start[..., 0]).expand(proj_dir.shape[:-1])
    direc = l2d.end - l2d.start
    norm = torch.sqrt(torch.sum(direc * direc, -1) + 1e-8)
    if weight_type == "length":
        return norm
    if weight_type == "invlength":
        return 1.0 / norm
    cos = torch.abs(torch.sum(proj_dir * direc, -1)) / norm
    cos = torch.clamp(cos, max=1.0)
    if weight_type == "cosine":
        return torch.exp(alpha * (1.0 - cos))
    if weight_type == "line3dpp":
        return torch.exp(alpha * torch.arccos(cos))
    raise ValueError(f"unknown weight {weight_type!r}")


def line_loc_residuals(l3d: Segments, l2d: Segments,
                       views: CameraViewsBatch,
                       cfg: LineLocConfig) -> torch.Tensor:
    """Per-correspondence residual block [..., R] (R in {2, 3, 4}); l3d,
    l2d and the views broadcast."""
    proj = project_segments(l3d, views)
    pd = proj.direction()
    w = _weight_2d(cfg.cost_function_weight, pd, l2d, cfg.alpha)[..., None]
    cf = cfg.cost_function

    if cf == "2d_midpoint_dist2":
        r = proj.midpoint() - l2d.midpoint()
    elif cf == "2d_midpoint_angle_dist3":
        md = proj.midpoint() - l2d.midpoint()
        dir2 = l2d.direction()
        sine = torch.abs(pd[..., 0] * dir2[..., 1] - pd[..., 1] * dir2[..., 0])
        r = torch.cat([md, (proj.length() * sine)[..., None]], dim=-1)
    elif cf in ("2d_perpendicular_dist2", "2d_perpendicular_dist4"):
        # the observed endpoints' distance to the projected infinite line
        p2d = proj.midpoint()

        def per_endpoint(p):
            disp = p - p2d
            dn = torch.sqrt(torch.sum(disp * disp, -1) + 1e-8)
            sine = torch.abs(pd[..., 0] * disp[..., 1]
                             - pd[..., 1] * disp[..., 0]) / dn
            return disp * sine[..., None]

        r4_start = per_endpoint(l2d.start)
        r4_end = per_endpoint(l2d.end)
        if cf == "2d_perpendicular_dist4":
            r = torch.cat([r4_start, r4_end], dim=-1)
        else:
            r = torch.cat(
                [torch.sqrt(torch.sum(r4_start ** 2, -1, keepdim=True) + 1e-8),
                 torch.sqrt(torch.sum(r4_end ** 2, -1, keepdim=True) + 1e-8)],
                dim=-1)
    elif cf == "3d_line_line_dist2":
        # 3D distance of the observed endpoints' rays to the 3D line
        C = views.center()
        d3 = l3d.direction()

        def ray_line_dist(p):
            ray = views.ray_direction(p)
            n = cross(ray, d3)
            nn = torch.sum(n * n, -1)
            d = l3d.start - C
            generic = torch.abs(torch.sum(n * d, -1)) \
                / torch.sqrt(torch.clamp(nn, min=1e-8))
            cr = cross(ray, d)
            parallel = torch.sqrt(torch.sum(cr * cr, -1)
                                  / (torch.sum(ray * ray, -1) + 1e-8) + 1e-8)
            return torch.where(nn <= 1e-8, parallel, generic)

        r = torch.stack([ray_line_dist(l2d.start), ray_line_dist(l2d.end)],
                        dim=-1)
    elif cf == "3d_plane_line_dist2":
        # the 3D endpoints' distance to the observed segment's
        # back-projection plane
        C = views.center()
        n = cross(views.ray_direction(l2d.start),
                  views.ray_direction(l2d.end))
        n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + EPS)
        r = torch.stack(
            [torch.abs(torch.sum(n * (l3d.start - C), -1)),
             torch.abs(torch.sum(n * (l3d.end - C), -1))], dim=-1)
    else:
        raise ValueError(f"unknown cost function {cf!r}")
    return r * w


def pack_pose(qvec, tvec, device=None) -> torch.Tensor:
    """(qvec [..., 4], tvec [..., 3]) -> the LM's fp32 params [..., 7]."""
    return torch.cat([torch.as_tensor(qvec, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(tvec, dtype=torch.float32,
                                      device=device)], dim=-1)


def _jointloc_residual(cfg: LineLocConfig, has_lines: bool,
                       has_points: bool):
    """The joint residual of :func:`solve_jointloc_batch`, batched over
    rows: params [T, 7], masks [T, N] and data with a leading [1] ->
    [T, R]."""

    def weighted(r, weight, mask):
        rw = robust_weight(torch.sum(r * r, -1).detach(), cfg.loss,
                           cfg.loss_scale)
        scale = torch.sqrt(weight * rw + 1e-12)
        return torch.where(mask[..., None], r * scale[..., None],
                           torch.zeros_like(r))

    def residual_fn(params, l3s, l3e, l2s, l2e, lmask, p3, p2, pmask, kv):
        views = CameraViewsBatch(kv[:, None], params[:, None, :4],
                                 params[:, None, 4:7])
        rs = []
        if has_lines:
            r_line = line_loc_residuals(Segments(l3s, l3e), Segments(l2s, l2e),
                                        views, cfg)            # [T, nl, R]
            rs.append(weighted(r_line, cfg.weight_line, lmask)
                      .reshape(params.shape[0], -1))
        if has_points:
            r_pt = views.project(p3) - p2
            rs.append(weighted(r_pt, cfg.weight_point, pmask)
                      .reshape(params.shape[0], -1))
        if not rs:
            return torch.zeros((params.shape[0], 1), dtype=params.dtype,
                               device=params.device)
        return torch.cat(rs, dim=1)

    return residual_fn


def solve_jointloc_batch(l3d_start, l3d_end, l2d_start, l2d_end, p3ds,
                         p2ds, kvec, qvecs, tvecs,
                         cfg: LineLocConfig = LineLocConfig(),
                         line_masks=None, point_masks=None,
                         num_iterations: int = 50, device=None):
    """T independent pose problems on one set of matches, in one
    :func:`lm_solve`: row t starts from (qvecs[t], tvecs[t]) and uses
    the matches of line_masks[t] and point_masks[t] ([T, N] each; all
    when None).  Arrays or tensors; returns the tensors (qvecs [T, 4],
    tvecs [T, 3], final costs [T]) on ``device``."""
    device = resolve_device(device)

    def b(x, shape, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device).reshape(shape)

    nl, npt = len(l3d_start), len(p3ds)
    params0 = pack_pose(b(qvecs, (-1, 4)), b(tvecs, (-1, 3)))
    T = params0.shape[0]
    if line_masks is None:
        line_masks = np.ones((T, nl), bool)
    if point_masks is None:
        point_masks = np.ones((T, npt), bool)
    result = lm_jointloc.solve(
        params0.contiguous(), b(l3d_start, (nl, 3)), b(l3d_end, (nl, 3)),
        b(l2d_start, (nl, 2)), b(l2d_end, (nl, 2)),
        b(line_masks, (T, nl), torch.bool), b(p3ds, (npt, 3)),
        b(p2ds, (npt, 2)), b(point_masks, (T, npt), torch.bool),
        b(kvec, (4,)), cfg, num_iterations)
    return result.params[:, :4], result.params[:, 4:7], result.cost


def solve_jointloc(l3d_start, l3d_end, l2d_start, l2d_end, p3ds, p2ds,
                   kvec, qvec0, tvec0, cfg: LineLocConfig = LineLocConfig(),
                   line_mask=None, point_mask=None,
                   num_iterations: int = 50, device=None):
    """Optimize one pose from point and line matches (any may be empty)
    on ``device``.  Arrays or tensors; returns (qvec, tvec, final cost)
    as numpy and a float."""
    q, t, cost = solve_jointloc_batch(
        l3d_start, l3d_end, l2d_start, l2d_end, p3ds, p2ds, kvec,
        np.asarray(qvec0)[None], np.asarray(tvec0)[None], cfg,
        None if line_mask is None else np.asarray(line_mask)[None],
        None if point_mask is None else np.asarray(point_mask)[None],
        num_iterations, device)
    return q[0].cpu().numpy(), t[0].cpu().numpy(), float(cost[0])
