"""The learned front-end zoo on the card against the CPU (chip_smoke's
phase 16a and the parts of phase 16 that need no JAX).

Every network takes the same random weights on both devices (the
reference's seeded init, or a file written by
``testing/learned.py::write_random_checkpoints``); the inputs are
rendered views of ``testing/pipeline.py``'s scene.  Each function
returns a dict of measured differences that the caller gates.

    python -m limap_tpu_torch.testing.zoo

runs the small comparisons on one GPU and prints them.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (arrays or tensors on any device)."""
    a, b = (np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                       np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
        if a.size else 0.0


# HAWPv3's scores card against CPU: within HAWP_SCORE_RTOL of their
# largest value (2.9e-6 at 128 x 128 and 4.3e-6 at 600 x 800 on an H100,
# whose random hourglass grows the scores to ~1e5).  Its maps are held
# texel by texel by hawp_maps_excess.
HAWP_SCORE_RTOL = 2e-5
# a map's own float32 rounding on either device: 8 ulps of 1
MAP_ROUNDING = 2.0 ** -20


def _sigmoid_slope_near(s: torch.Tensor, e: float) -> torch.Tensor:
    """The largest slope of the sigmoid over [s - e, s + e]: at the point
    of that interval nearest 0."""
    near = torch.sign(s) * torch.clamp(s.abs() - e, min=0.0)
    p = torch.sigmoid(near)
    return p * (1.0 - p)


def hawp_maps_excess(score_a: torch.Tensor, score_b: torch.Tensor) -> float:
    """HAWPv3's maps of two score tensors [..., 9] (float32) compared
    texel by texel: the largest |map_a - map_b| over what the scores'
    own difference allows there, the sigmoid's largest slope within e of
    the score times e (e the largest absolute score difference; jloc is
    the sigmoid of a difference of two scores, so its e doubles and
    grows by the float32 rounding of that difference on each device),
    plus MAP_ROUNDING.  At most 1 when the maps follow from the
    scores."""
    from limap_tpu_torch.line2d.hawpv3 import heads
    a = score_a.detach().cpu().to(torch.float32)
    b = score_b.detach().cpu().to(torch.float32)
    e = float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
    ma, mb = heads(a), heads(b)
    b64 = b.to(torch.float64)
    e_jloc = 2 * e + 2.0 ** -23 * (b64[..., 5:6].abs() + b64[..., 6:7].abs()
                                   + 2 * e)
    slope = {"md": _sigmoid_slope_near(b64[..., 0:3], e) * e,
             "dis": _sigmoid_slope_near(b64[..., 3:4], e) * e,
             "res": _sigmoid_slope_near(b64[..., 4:5], e) * e,
             "jloc": _sigmoid_slope_near(b64[..., 6:7] - b64[..., 5:6],
                                         e_jloc) * e_jloc,
             "joff": _sigmoid_slope_near(b64[..., 7:9], e) * e}
    worst = 0.0
    for k, allow in slope.items():
        diff = (ma[k].to(torch.float64) - mb[k].to(torch.float64)).abs()
        worst = max(worst, float((diff / (allow + MAP_ROUNDING)).max()))
    return worst


def noisy_segments(scene, k, noise=0.3, seed=0):
    """The GT segments of view k (x, y), projected, with endpoint noise:
    [N, 5] float64 (score = length)."""
    from limap_tpu_torch.testing import learned
    imagecols, _, _, gt = scene
    view = imagecols.camview(k)
    hw = (view.cam.h(), view.cam.w())
    s = learned.project_segments(gt, view.cam.K(), view.pose.R(),
                                 view.pose.tvec, hw)[:, :, ::-1]
    rng = np.random.default_rng(seed + k)
    s = s + rng.normal(scale=noise, size=s.shape)
    segs = s.reshape(-1, 4)
    length = np.linalg.norm(segs[:, 2:] - segs[:, :2], axis=1)
    return np.concatenate([segs, length[:, None]], 1)


def detectors_card_vs_cpu(img, ckpt_dir=None):
    """DeepLSD, TP-LSD and HAWPv3 forwards card against CPU on one image;
    each decode run on both devices from the CPU's maps."""
    from limap_tpu_torch.line2d import deeplsd, hawpv3, tp_lsd
    out = {}
    opts = {"weight_path": ckpt_dir}
    dg = deeplsd.DeepLSDDetector(dict(opts, device="cuda"))
    dc = deeplsd.DeepLSDDetector(dict(opts, device="cpu"))
    fg, fc = dg.fields(img), dc.fields(img)
    out["deeplsd_df"] = rel_err(fg[0].cpu(), fc[0])
    out["deeplsd_angle"] = rel_err(fg[1].cpu(), fc[1])
    sg = deeplsd.segments_from_fields(fc[0].cuda(), fc[1].cuda())
    sc = deeplsd.segments_from_fields(*fc)
    out["deeplsd_segments"] = (len(sg), len(sc))
    tg = tp_lsd.TPLSDDetector(dict(opts, device="cuda"))
    tc = tp_lsd.TPLSDDetector(dict(opts, device="cpu"))
    cg, cc = tg.maps(img), tc.maps(img)
    out["tplsd_center"] = rel_err(cg[0].cpu(), cc[0])
    out["tplsd_disp"] = rel_err(cg[1].cpu(), cc[1])
    kg = tp_lsd.tplsd_decode(cc[0].cuda(), cc[1].cuda(), tc.max_segs,
                             tc.score_thresh)
    kc = tp_lsd.tplsd_decode(*cc, tc.max_segs, tc.score_thresh)
    out["tplsd_decode_equal"] = bool(torch.equal(kg[0].cpu(), kc[0])
                                     and int(kg[1]) == int(kc[1]))
    out["tplsd_count"] = int(kc[1])
    hg = hawpv3.HAWPv3Detector(dict(opts, device="cuda"))
    hc = hawpv3.HAWPv3Detector(dict(opts, device="cpu"))
    with torch.no_grad():
        sg, sc = (d.net.scores(d.image_tensor(img)) for d in (hg, hc))
    out["hawpv3_scores"] = rel_err(sg.cpu(), sc)
    out["hawpv3_maps_excess"] = hawp_maps_excess(sg, sc)
    mc = hc.maps(img)
    H, W = img.shape[:2]
    seg_g = hawpv3.decode({k: v.cuda() for k, v in mc.items()}, H, W)
    seg_c = hawpv3.decode(mc, H, W)
    out["hawpv3_segments"] = (len(seg_g), len(seg_c))
    out["hawpv3_segment_err"] = (float(np.abs(seg_g - seg_c).max())
                                 if seg_g.shape == seg_c.shape and len(seg_c)
                                 else None)
    return out


def descriptors_card_vs_cpu(imgs, segs, ckpt_dir=None, sp_weight=None):
    """LBD, L2D2, LineTR, GlueStick and dense NCC: descriptors card
    against CPU on two images with the same segments, and matches of
    the pair on each device."""
    from limap_tpu_torch.line2d import get_extractor, get_matcher
    out = {}
    for method, mopts in (("lbd", {"topk": 0}), ("l2d2", {"topk": 0}),
                          ("linetr", {"topk": 0}),
                          ("gluestick", {"topk": 0}),
                          ("dense_naive", {"topk": 0})):
        infos, matches = {}, {}
        for dev in ("cuda", "cpu"):
            ext = get_extractor({"method": method,
                                 "sp_weight_path": sp_weight},
                                weight_path=ckpt_dir, device=dev)
            mname = "dense_ncc" if method == "dense_naive" else method
            mat = get_matcher(dict(mopts, method=mname), ext,
                              weight_path=ckpt_dir, device=dev)
            infos[dev] = [ext.extract_array(im, s) if hasattr(
                ext, "extract_array") else ext.compute_descinfo(im, s)
                for im, s in zip(imgs, segs)]
            matches[dev] = mat.match_pair(*infos[dev])
        key = {"lbd": "line_descriptors", "l2d2": "line_descriptors",
               "linetr": "line_descriptors", "gluestick": "junc_desc",
               "dense_naive": "lines"}[method]
        out[f"{method}_desc"] = max(rel_err(g[key], c[key]) for g, c in
                                    zip(infos["cuda"], infos["cpu"]))
        mg = set(map(tuple, np.asarray(matches["cuda"]).tolist()))
        mc = set(map(tuple, np.asarray(matches["cpu"]).tolist()))
        out[f"{method}_matches"] = (len(mg), len(mc), len(mg ^ mc))
    return out


def s2dnet_card_vs_cpu(img, weight_path=None):
    from limap_tpu_torch.features.extractors import S2DNetExtractor
    fg = S2DNetExtractor(weight_path, device="cuda").extract(img)
    fc = S2DNetExtractor(weight_path, device="cpu").extract(img)
    return {"s2dnet": float((fg.cpu() - fc).abs().max())}


def main():
    import tempfile
    from limap_tpu_torch.testing import learned, pipeline
    scene = pipeline.build_scene(n_views=2, hw=(128, 128))
    imgs = [scene[1][k] for k in (0, 1)]
    segs = [noisy_segments(scene, k) for k in (0, 1)]
    with tempfile.TemporaryDirectory() as d:
        ckpt = learned.write_random_checkpoints(d)
        res = detectors_card_vs_cpu(imgs[0], ckpt["zoo"])
        res.update(descriptors_card_vs_cpu(imgs, segs, ckpt["zoo"],
                                           ckpt["superpoint"]))
        res.update(s2dnet_card_vs_cpu(imgs[0], ckpt["s2dnet"]))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())


# ----------------------------------------------------------- GT fields
# Fields that a trained network would predict, built from a view's
# projected GT segments, so that each detector's decoding is measured on
# quality without weights (chip_smoke phase 16; the JAX package's recall
# on the same fields: tests/torch_port_reference_gates.py --zoo-fields).
CENTER_SIGMA = 1.5          # px, the TP-LSD centre blob
HAFM_SCALE = 5.0            # HAWPv3's distance normalization (1/4 res px)


def _nearest_segment(p, segs_xy):
    """Per point [..., 2] the nearest segment's index, the distance and
    the foot (x, y)."""
    best = np.full(p.shape[:-1], np.inf)
    idx = np.zeros(p.shape[:-1], np.int64)
    foot = np.zeros(p.shape)
    for k, (a, b) in enumerate(segs_xy):
        d = b - a
        t = np.clip(((p - a) @ d) / max(d @ d, 1e-12), 0, 1)
        f = a + t[..., None] * d
        dist = np.linalg.norm(p - f, axis=-1)
        closer = dist < best
        best = np.where(closer, dist, best)
        idx = np.where(closer, k, idx)
        foot = np.where(closer[..., None], f, foot)
    return idx, best, foot


FIELD_BAND = 4              # px about a segment where the fields are set
FAR = 1e3                   # the distance field beyond that band


def _window(a, b, reach, h, w):
    lo = np.maximum(np.floor(np.minimum(a, b) - reach).astype(int), 0)
    hi = np.minimum(np.ceil(np.maximum(a, b) + reach).astype(int),
                    [w - 1, h - 1])
    yy, xx = np.mgrid[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
    return (slice(lo[1], hi[1] + 1), slice(lo[0], hi[0] + 1),
            np.stack([xx, yy], -1).astype(np.float64))


def deeplsd_fields(segs_xy, hw):
    """(distance field, line angle mod pi) [H, W] float32 of segments
    [N, 2, 2] (x, y): set within FIELD_BAND px of a segment (the
    extraction reads them where the distance is under 1.5 px), FAR and 0
    elsewhere."""
    h, w = hw
    df = np.full((h, w), FAR)
    ang = np.zeros((h, w))
    for a, b in np.asarray(segs_xy, np.float64):
        ys, xs, p = _window(a, b, FIELD_BAND, h, w)
        d = b - a
        t = np.clip(((p - a) @ d) / max(d @ d, 1e-12), 0, 1)
        dist = np.linalg.norm(p - (a + t[..., None] * d), axis=-1)
        closer = dist < df[ys, xs]
        df[ys, xs] = np.where(closer, dist, df[ys, xs])
        ang[ys, xs] = np.where(closer, np.arctan2(d[1], d[0]) % np.pi,
                               ang[ys, xs])
    return df.astype(np.float32), ang.astype(np.float32)


def tplsd_fields(segs_xy, hw):
    """(centre map [H, W], displacements [H, W, 4]) float32: a Gaussian
    blob at each segment's midpoint (set within 4 sigma), and within that
    reach the vectors to the endpoints of the segment whose midpoint is
    nearest (0 elsewhere: the decoding reads them at peaks only)."""
    h, w = hw
    reach = 4 * CENTER_SIGMA
    center = np.zeros((h, w))
    disp = np.zeros((h, w, 4))
    near = np.full((h, w), np.inf)
    for a, b in np.asarray(segs_xy, np.float64):
        m = 0.5 * (a + b)
        ys, xs, p = _window(m, m, reach, h, w)
        d2 = ((p - m) ** 2).sum(-1)
        center[ys, xs] = np.maximum(center[ys, xs],
                                    np.exp(-d2 / (2 * CENTER_SIGMA ** 2)))
        closer = d2 < near[ys, xs]
        near[ys, xs] = np.where(closer, d2, near[ys, xs])
        vec = np.concatenate([a - p, b - p], -1)
        disp[ys, xs] = np.where(closer[..., None], vec, disp[ys, xs])
    return center.astype(np.float32), disp.astype(np.float32)


def hawp_fields(segs_xy, hw):
    """HAWPv3's maps at 1/4 resolution, channels last, float32: the
    attraction field (md, dis, res = 0) inverted from its decoding
    formulas for pixels within HAFM_SCALE of a segment whose foot lies
    inside it (dis 0 elsewhere: a candidate that collapses onto its pixel
    and snaps nowhere), and a junction map of 1 at each endpoint's cell
    with its offset."""
    h, w = hw[0] // 4, hw[1] // 4
    s = np.asarray(segs_xy, np.float64) / 4.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xx, yy], -1)
    idx, dist, foot = _nearest_segment(p, s)
    v = foot - p
    theta = np.arctan2(v[..., 1], v[..., 0])
    u = np.stack([-np.sin(theta), np.cos(theta)], -1)
    ta = ((s[idx][..., 0, :] - foot) * u).sum(-1)
    tb = ((s[idx][..., 1, :] - foot) * u).sum(-1)
    t_st, t_ed = np.maximum(ta, tb), np.minimum(ta, tb)
    ok = (dist > 1e-3) & (dist < HAFM_SCALE) & (t_st >= 0) & (t_ed <= 0)
    dd = np.maximum(dist, 1e-3)
    md = np.stack([theta / (2 * np.pi) + 0.5,
                   np.arctan(t_st / dd) / (np.pi / 2),
                   np.arctan(-t_ed / dd) / (np.pi / 2)], -1)
    dis = np.where(ok, dist / HAFM_SCALE, 0.0)[..., None]
    jloc = np.zeros((h, w, 1))
    joff = np.zeros((h, w, 2))
    for e in s.reshape(-1, 2):
        cx, cy = int(np.floor(e[0])), int(np.floor(e[1]))
        if 0 <= cx < w and 0 <= cy < h:
            jloc[cy, cx, 0] = 1.0
            joff[cy, cx] = e - [cx, cy] - 0.5
    f32 = np.float32
    return {"md": md.astype(f32), "dis": dis.astype(f32),
            "res": np.zeros_like(dis, f32), "jloc": jloc.astype(f32),
            "joff": joff.astype(f32)}


def gt_field_views(scene, view_ids):
    """{view: GT segments [N, 2, 2] (x, y)} of the views, visible and at
    least 10 px long."""
    from limap_tpu_torch.testing import learned
    imagecols, _, _, gt = scene
    out = {}
    for i in view_ids:
        view = imagecols.camview(i)
        hw = (view.cam.h(), view.cam.w())
        out[i] = learned.project_segments(gt, view.cam.K(), view.pose.R(),
                                          view.pose.tvec, hw)[:, :, ::-1]
    return out


def recall_xy(detected, gt_xy, tol=3.0):
    """learned.segment_recall of detections [N, >=4] (x1 y1 x2 y2)."""
    from limap_tpu_torch.testing import learned
    det = np.asarray(detected, np.float64)[:, :4].reshape(-1, 2, 2)
    return learned.segment_recall(det[:, :, ::-1], np.asarray(
        gt_xy)[:, :, ::-1], tol)

