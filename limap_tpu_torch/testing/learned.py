"""Inputs for chip_smoke.py's phases 15a and 15, the learned front end:
random checkpoints in the published layouts, the Sinkhorn runner's
config, and a line heatmap rendered from the GT lines' projections.

No checkpoint is in the repository, so the networks run with random
weights written to files in the published layouts (``superpoint_v1.pth``,
``superglue_outdoor.pth``, ``sold2_wireframe.tar``) and loaded through
``weight_path``, as a user's files would be.  Their quality gates are
parity gates; the two paths whose quality does not depend on weights
(the Sinkhorn endpoint matcher and SOLD2's detector on a GT heatmap) are
gated on quality (``tests/torch_port_reference_gates.py --sinkhorn`` and
``--sold2-gt`` give the floors).
"""

from __future__ import annotations

import os

import numpy as np
import torch

SUPERPOINT_FILE = "superpoint_v1.pth"
SUPERGLUE_FILE = "superglue_outdoor.pth"
SOLD2_FILE = "sold2_wireframe.tar"
HEATMAP_SIGMA = 1.0        # px, the GT heatmap's line profile
HEATMAP_REACH = 3          # px beyond which it is 0
RECALL_TOL = 3.0           # px, both endpoints of a recovered segment


def superglue_random_state_dict(seed: int = 0) -> dict:
    """A SuperGlue state dict in the published layout with kernels drawn
    with the fan-in scale (so the 18 layers stay well conditioned),
    zero biases, identity batch norms and a dustbin score of 1."""
    from limap_tpu_torch.point2d.superglue import key_spec
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in key_spec().items():
        if k.endswith("running_var") or k == "bin_score":
            a = np.ones(shape, np.float32)
        elif k.endswith(("running_mean", "bias")):
            a = np.zeros(shape, np.float32)
        elif len(shape) == 1:                   # batch-norm weights
            a = np.ones(shape, np.float32)
        else:
            a = (rng.normal(size=shape) / np.sqrt(shape[1])).astype(
                np.float32)
        sd[k] = torch.as_tensor(a)
    return sd


# the zoo's checkpoints under a weights directory, where both packages'
# loaders look for them: (name, path under the directory, wrapped in
# {"model": ...})
ZOO_FILES = (
    ("deeplsd", "line2d/DeepLSD/deeplsd_md.tar", True),
    ("tp_lsd", "line2d/TP_LSD/tp_lsd.pth", True),
    ("hawpv3", "line2d/HAWPv3/weights/hawpv3_wireframe.pth", True),
    ("l2d2", "line2d/L2D2/checkpoint_line_descriptor.th", False),
    ("linetr", "line2d/LineTR/weights/LineTR_weight.pth", False),
    ("gluestick", "line2d/GlueStick/checkpoint_GlueStick_MD.tar", True),
)


def zoo_random_state_dicts(seed: int = 0) -> dict:
    """The zoo's seeded random weights (the reference's own draws)."""
    from limap_tpu_torch.line2d import (deeplsd, gluestick, hawpv3, l2d2,
                                        linetr, tp_lsd)
    return {"deeplsd": deeplsd.init_params(seed),
            "tp_lsd": tp_lsd.init_params(seed),
            "hawpv3": hawpv3.init_params(seed),
            "l2d2": l2d2.init_params(seed),
            "linetr": linetr.init_params(seed),
            "gluestick": gluestick.init_params(seed)}


def write_random_checkpoints(folder: str, seed: int = 0) -> dict:
    """Random weights of SuperPoint, SuperGlue and SOLD2 written under
    ``folder`` in the published files' layouts, the zoo's under
    ``folder/zoo`` where the loaders of a weights directory look, and
    S2DNet's; {name: path} ("zoo" the weights directory)."""
    from limap_tpu_torch.features.extractors import s2dnet_random_state_dict
    from limap_tpu_torch.line2d.sold2.nets import init_params
    from limap_tpu_torch.point2d.superpoint import random_state_dict
    os.makedirs(folder, exist_ok=True)
    paths = {k: os.path.join(folder, f) for k, f in (
        ("superpoint", SUPERPOINT_FILE), ("superglue", SUPERGLUE_FILE),
        ("sold2", SOLD2_FILE), ("s2dnet", "s2dnet.pth"))}
    torch.save(random_state_dict(seed), paths["superpoint"])
    torch.save(superglue_random_state_dict(seed), paths["superglue"])
    torch.save({"model_state_dict": init_params(seed)}, paths["sold2"])
    torch.save(s2dnet_random_state_dict(seed), paths["s2dnet"])
    paths["zoo"] = os.path.join(folder, "zoo")
    sds = zoo_random_state_dicts(seed)
    for name, rel, wrapped in ZOO_FILES:
        path = os.path.join(paths["zoo"], rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": sds[name]} if wrapped else sds[name], path)
    return paths


def sinkhorn_runner_config(output_dir: str, n_neighbors: int) -> dict:
    """The from-pixels runner's config (``pipeline.runner_config``) with
    the weight-free Sinkhorn endpoint matcher on every pair (topk 0),
    keeping every mutual argmax of the assignment (match_threshold 0):
    the patch descriptors of the rendered strokes are so alike (line
    scores 0.95 on average) that no assignment probability reaches the
    default 0.2 (their row maxima average 0.003), and the triangulator's
    geometric scoring sorts the matches."""
    from limap_tpu_torch.testing import pipeline
    cfg = pipeline.runner_config(output_dir, n_neighbors)
    cfg["line2d"]["matcher"] = {"method": "sinkhorn_endpoints", "topk": 0,
                                "match_threshold": 0.0}
    return cfg


def project_segments(gt: np.ndarray, K: np.ndarray, R: np.ndarray,
                     t: np.ndarray, hw) -> np.ndarray:
    """The GT lines [N, 2, 3] in front of the camera, projected and
    clipped to the image: [M, 2, 2] (h, w), float64, at least 10 px
    long."""
    h, w = hw
    out = []
    for a, b in np.asarray(gt, np.float64):
        pa, pb = R @ a + t, R @ b + t
        if pa[2] <= 0.1 or pb[2] <= 0.1:
            continue
        ua = (K @ pa)[:2] / pa[2]
        ub = (K @ pb)[:2] / pb[2]
        # clip the segment (x, y) to [0, w-1] x [0, h-1] (Liang-Barsky)
        d = ub - ua
        lo, hi = 0.0, 1.0
        ok = True
        for p, q in ((-d[0], ua[0]), (d[0], w - 1 - ua[0]),
                     (-d[1], ua[1]), (d[1], h - 1 - ua[1])):
            if p == 0:
                ok &= q >= 0
            elif p < 0:
                lo = max(lo, q / p)
            else:
                hi = min(hi, q / p)
        if not ok or lo >= hi:
            continue
        s, e = ua + lo * d, ua + hi * d
        if np.linalg.norm(e - s) < 10:
            continue
        out.append([[s[1], s[0]], [e[1], e[0]]])
    return np.asarray(out, np.float64).reshape(-1, 2, 2)


def gt_heatmap(segs_hw: np.ndarray, hw) -> tuple:
    """A line heatmap [H, W] f64 from segments (h, w): each pixel takes
    exp(-d^2 / 2 sigma^2) of its distance d to the nearest segment, 0
    beyond HEATMAP_REACH; and the junctions [J, 2] (h, w), the segments'
    endpoints rounded (unique)."""
    h, w = hw
    heat = np.zeros((h, w))
    for s, e in segs_hw:
        lo = np.floor(np.minimum(s, e) - HEATMAP_REACH).astype(int)
        hi = np.ceil(np.maximum(s, e) + HEATMAP_REACH).astype(int)
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [h - 1, w - 1])
        yy, xx = np.mgrid[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1]
        p = np.stack([yy, xx], -1).astype(np.float64)
        d = e - s
        tt = np.clip(((p - s) @ d) / max(d @ d, 1e-12), 0, 1)
        dist = np.linalg.norm(p - (s + tt[..., None] * d), axis=-1)
        v = np.where(dist <= HEATMAP_REACH,
                     np.exp(-dist ** 2 / (2 * HEATMAP_SIGMA ** 2)), 0.0)
        heat[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1] = np.maximum(
            heat[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1], v)
    junc = np.unique(np.rint(segs_hw.reshape(-1, 2)), axis=0)
    junc[:, 0] = np.clip(junc[:, 0], 0, h - 1)
    junc[:, 1] = np.clip(junc[:, 1], 0, w - 1)
    return heat, np.unique(junc, axis=0)


def segment_recall(detected_hw: np.ndarray, gt_hw: np.ndarray,
                   tol: float = RECALL_TOL) -> float:
    """The share of GT segments with a detected segment whose endpoints
    lie within ``tol`` of theirs (either orientation)."""
    if len(gt_hw) == 0:
        return 1.0
    if len(detected_hw) == 0:
        return 0.0
    g = np.asarray(gt_hw)[:, None]
    d = np.asarray(detected_hw)[None]
    same = np.maximum(np.linalg.norm(g[..., 0, :] - d[..., 0, :], axis=-1),
                      np.linalg.norm(g[..., 1, :] - d[..., 1, :], axis=-1))
    flip = np.maximum(np.linalg.norm(g[..., 0, :] - d[..., 1, :], axis=-1),
                      np.linalg.norm(g[..., 1, :] - d[..., 0, :], axis=-1))
    return float((np.minimum(same, flip).min(1) <= tol).mean())


def gt_heatmap_views(scene, view_ids):
    """{view id: (heatmap, junctions, visible GT segments)} of
    :func:`pipeline.build_scene`'s views."""
    imagecols, _, _, gt = scene
    out = {}
    for i in view_ids:
        view = imagecols.camview(i)
        cam, pose = view.cam, view.pose
        hw = (cam.h(), cam.w())
        segs = project_segments(gt, cam.K(), pose.R(), pose.tvec, hw)
        heat, junc = gt_heatmap(segs, hw)
        out[i] = (heat, junc, segs)
    return out
