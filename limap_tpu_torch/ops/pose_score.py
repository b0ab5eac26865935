"""MSAC scoring of candidate poses against point and line matches.

``pose_score`` takes H poses (qvec [H, 4], tvec [H, 3]) and one
camera's kvec, and per pose and correspondence the squared error: for a
point the squared reprojection distance, for a line the squared norm of
the two endpoint-perpendicular residuals of the ``2d_perpendicular_dist2``
cost; a point or line endpoint at depth <= 1e-6 has an infinite error.
Scores mode gives the MSAC score wp sum min(e, th_p^2) + wl sum min(e,
th_l^2) [H] and the inlier masks e <= th^2 [H, Np], [H, Nl]; errors mode
the errors themselves.

CUDA tensors launch ``csrc/pose_score.cu`` (one block a pose, threads
over the correspondences, a block reduction for the score); CPU tensors
take :func:`pose_score_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.ops.cuda_build import check_tensor

SOURCE = "pose_score.cu"


class ScoreParams(NamedTuple):
    """Squared thresholds and data-type weights, each rounded to fp32 as
    the JAX program computes them."""

    th_pt2: float
    th_ln2: float
    wp: float
    wl: float

    @classmethod
    def from_thresholds(cls, th_point, th_line, w_point=1.0, w_line=1.0):
        f32 = np.float32
        tp2 = f32(th_point) * f32(th_point)
        tl2 = f32(th_line) * f32(th_line)
        # data-type weights *= [th_line^2, th_point^2] / (th_pt^2 + th_ln^2)
        wp = f32(w_point) * tl2 / (tp2 + tl2)
        wl = f32(w_line) * tp2 / (tp2 + tl2)
        return cls(float(tp2), float(tl2), float(wp), float(wl))


def pose_sq_errors_plain(qvec, tvec, kvec, p3, p2, l3s, l3e, l2s, l2e):
    """(point errors [H, Np], line errors [H, Nl]) in plain torch."""
    from limap_tpu_torch.optimize.hybrid_localization import (
        LineLocConfig, line_loc_residuals)
    H = qvec.shape[0]
    vp = CameraViewsBatch(kvec.expand(H, 4)[:, None], qvec[:, None],
                          tvec[:, None])
    proj = vp.project(p3[None])
    ept2 = torch.sum((proj - p2[None]) ** 2, dim=-1)
    inf = torch.full_like(ept2, float("inf"))
    ept2 = torch.where(vp.projdepth(p3[None]) > 1e-6, ept2, inf)
    l3 = Segments(l3s[None], l3e[None])
    r = line_loc_residuals(l3, Segments(l2s[None], l2e[None]), vp,
                           LineLocConfig(cost_function="2d_perpendicular_dist2"))
    eln2 = torch.sum(r * r, dim=-1)
    ok = (vp.projdepth(l3.start) > 1e-6) & (vp.projdepth(l3.end) > 1e-6)
    return ept2, torch.where(ok, eln2, torch.full_like(eln2, float("inf")))


def pose_score_plain(qvec, tvec, kvec, p3, p2, l3s, l3e, l2s, l2e,
                     params: ScoreParams, errors: bool = False):
    ept2, eln2 = pose_sq_errors_plain(qvec, tvec, kvec, p3, p2, l3s, l3e,
                                      l2s, l2e)
    if errors:
        return ept2, eln2
    # clamp, as jnp.minimum, keeps a NaN error NaN
    scores = (params.wp * torch.clamp(ept2, max=params.th_pt2).sum(-1)
              + params.wl * torch.clamp(eln2, max=params.th_ln2).sum(-1))
    return scores, ept2 <= params.th_pt2, eln2 <= params.th_ln2


def build() -> ctypes.CDLL:
    from limap_tpu_torch.ops.cuda_build import load_library
    lib = load_library(SOURCE)
    ptr, i64, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.pose_score_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ptr,
                                      ptr, ptr, ptr, i64, i64, f, f, f, f,
                                      i64, ptr, ptr, ptr, ptr]
    lib.pose_score_launch.restype = ctypes.c_int
    return lib


def _checked(name, t, shape, device):
    check_tensor(name, t, torch.float32, shape, device)
    return t.contiguous()


def pose_score(qvec, tvec, kvec, p3, p2, l3s, l3e, l2s, l2e,
               params: ScoreParams, errors: bool = False):
    """Scores mode: (scores [H], point inliers [H, Np], line inliers
    [H, Nl]); errors mode: (point errors [H, Np], line errors [H, Nl]).
    ``pose_score.launches`` counts the kernel's launches."""
    device = qvec.device
    H, Np, Nl = qvec.shape[0], p3.shape[0], l3s.shape[0]
    args = [_checked(n, t, s, device) for n, t, s in (
        ("qvec", qvec, (H, 4)), ("tvec", tvec, (H, 3)), ("kvec", kvec, (4,)),
        ("p3", p3, (Np, 3)), ("p2", p2, (Np, 2)), ("l3s", l3s, (Nl, 3)),
        ("l3e", l3e, (Nl, 3)), ("l2s", l2s, (Nl, 2)), ("l2e", l2e, (Nl, 2)))]
    if device.type == "cpu":
        return pose_score_plain(*args, params, errors)
    opts = dict(dtype=torch.float32, device=device)
    if errors:
        out_p, out_l = torch.empty((H, Np), **opts), torch.empty((H, Nl), **opts)
        scores = None
    else:
        scores = torch.empty(H, **opts)
        out_p = torch.empty((H, Np), dtype=torch.bool, device=device)
        out_l = torch.empty((H, Nl), dtype=torch.bool, device=device)
    if H == 0:
        return (out_p, out_l) if errors else (scores, out_p, out_l)
    with torch.cuda.device(device):
        err = build().pose_score_launch(
            *(a.data_ptr() for a in args[:5]), Np,
            *(a.data_ptr() for a in args[5:]), Nl, H, *params, int(errors),
            scores.data_ptr() if scores is not None else None,
            out_p.data_ptr(), out_l.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pose_score launch failed: CUDA error {err}")
    pose_score.launches += 1
    return (out_p, out_l) if errors else (scores, out_p, out_l)


pose_score.launches = 0
