"""Refinement and point-line association on a façade line map: the path
of chip_smoke.py's phases 12a and 12 and of
``tests/torch_port_reference_gates.py --pointline``.

Given a line map of the façade scene (tracks, per-image segments and the
views), a second COLMAP model of the scene with points on the GT lines
(``pipeline.write_colmap_scene(..., n_line_points=...)``) and the
rendered images:

1. the refinement CLI's path: ``line_refinement`` with
   ``cfgs/refinement/default.yaml`` and ``use_vp`` (kernel J, then K);
2. ``solve_line_refinement`` with the heatmap and feature-consistency
   terms (kernel K): the features of ``GradientFeatureExtractor`` on the
   rendered images, the heatmap their normalized gradient magnitude (a
   stand-in for SOLD2's, which is a learned network);
3. ``pointline_association`` with
   ``cfgs/global_pl_association/default.yaml`` (kernels J, L and M).

:func:`run` returns the outputs (with the pixel solve's input) and a
summary: tracks, distances to the GT lines, quality at 5 cm, the pixel
solve's costs, accepted steps and the tracks it took off their heatmap
patches (their count, their distances to the GT lines, and those of
their float64 ends: ``float64_ends``), the points' distances, the hard
point-line associations, the VPs and their orthogonality, the stage
seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from limap_tpu_torch.testing import pipeline


def configs():
    """(refinement section with use_vp, association config) from the
    config files, or their dict copies where PyYAML is missing."""
    import importlib.util
    from limap_tpu_torch.util.config import (default_pl_association_config,
                                             default_refinement_config,
                                             load_config)
    if importlib.util.find_spec("yaml"):
        r = load_config("cfgs/refinement/default.yaml")
        g = load_config("cfgs/global_pl_association/default.yaml")
    else:
        r, g = default_refinement_config(), default_pl_association_config()
    return dict(r["refinement"], use_vp=True), g


def feature_maps(imagecols, device, features="gradient", weight_path=None):
    """Per image the dense features of ``features`` ("gradient": [H, W,
    6]; "s2dnet": [H4, W4, 128]) and the heatmap, the gradient magnitude
    over its largest value."""
    from limap_tpu_torch.features import GradientFeatureExtractor
    from limap_tpu_torch.features.extractors import get_extractor
    grad = GradientFeatureExtractor(device=device)
    ext = grad if features == "gradient" else get_extractor(
        features, weight_path=weight_path, device=device)
    feats, heat = {}, {}
    for img_id in imagecols.get_img_ids():
        img = imagecols.camview(img_id).read_image(set_gray=True)
        g = grad.extract(img)
        feats[img_id] = g if ext is grad else ext.extract(img)
        heat[img_id] = g[..., 1] / torch.clamp(g[..., 1].max(), min=1e-12)
    return feats, heat


def line_distances(tracks, gt, n_samples=50):
    """Per track the mean distance of its samples to the nearest GT
    segment, in float64."""
    gt = np.asarray(gt, np.float64)
    a, d = gt[:, 0], gt[:, 1] - gt[:, 0]
    dd = (d * d).sum(1)
    ts = np.linspace(0, 1, n_samples)
    out = []
    for t in tracks:
        s, e = np.asarray(t.line, np.float64)
        out.append(pipeline._point_to_segments_min_dist(
            s[None] + ts[:, None] * (e - s)[None], a, d, dd).mean())
    return np.asarray(out)


def track_summary(tracks, gt):
    dist = line_distances(tracks, gt)
    q = pipeline.quality_eval(tracks, gt)
    return {"n_tracks": len(tracks), "dist_mean_m": float(dist.mean()),
            "dist_median_m": float(np.median(dist)),
            "recall_0.05": q["recall_0.05"],
            "precision_0.05": q["precision_0.05"]}


def left_patches(params0, data, terms, params):
    """[T] rows with a weighted heatmap anchor's foot inside its patch at
    ``params0`` and none at ``params``: the tracks that the pixel
    refinement took off their patches (where its heatmap and feature
    terms are 0 and the robust geometric term alone holds them)."""
    from limap_tpu_torch.testing.lm_checks import refine_coords
    d = [t.detach().cpu() for t in data]
    A, Pa = d[8].shape[2:]

    def inside(p):
        c = refine_coords(d, terms, np.arange(p.shape[0]),
                          p.detach().cpu().double())
        (pa, on), pb = c["pa"], c["pb"][0]
        return (on & (pa >= 0) & (pa <= A - 1) & (pb >= 0)
                & (pb <= Pa - 1)).flatten(1).any(1)

    return (inside(params0) & ~inside(params)).numpy()


def float64_ends(batch, views, cfg, solve_input, params, rows):
    """The output tracks of ``rows`` when their pixel solve (``solve_input``
    = (params0, data, terms)) runs again in float64 through the plain
    version, on the input's device, the other rows kept at ``params``:
    where exact arithmetic would end the tracks that the solve took off
    their patches."""
    from limap_tpu_torch.base.linetrack import batch_to_tracks
    from limap_tpu_torch.ops import lm_line_refine as K
    from limap_tpu_torch.optimize.line_ba import get_output_tracks
    from limap_tpu_torch.optimize.line_refinement import unpack_minimal_lines
    params0, data, terms = solve_input
    idx = torch.as_tensor(np.asarray(rows), device=params0.device)
    sub = K.RefineData(*[t if i in K.SHARED else t[idx]
                         for i, t in enumerate(data)])
    sub = K.RefineData(*[t.double() if t.is_floating_point() else t
                         for t in sub])
    mixed = params.clone()
    mixed[idx] = K.solve_plain(params0[idx].double(), sub, terms).params \
        .to(params.dtype)
    tracks = batch_to_tracks(get_output_tracks(
        batch, views, unpack_minimal_lines(mixed),
        cfg.num_outliers_aggregator))
    return [tracks[r] for r in rows]


def vp_summary(vps, th_orth=87.0):
    """The VPs and the worst |angle - 90 deg| of the pairs at least
    ``th_orth`` apart."""
    v = np.asarray(vps, np.float64).reshape(-1, 3)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    worst, angles = 0.0, []
    for i in range(len(v)):
        for j in range(i + 1, len(v)):
            ang = np.degrees(np.arccos(min(abs(float(v[i] @ v[j])), 1.0)))
            angles.append(float(ang))
            if ang >= th_orth:
                worst = max(worst, abs(ang - 90.0))
    return {"n_vps": len(v), "worst_orthogonal_deg": worst,
            "pair_angles_deg": angles}


def run(tracks, imagecols, all_2d_segs, model_path, gt, out_dir, device,
        n_wall_points=pipeline.N_POINTS, prof=None, features="gradient",
        weight_path=None, associate=True):
    """The three steps on ``device``; returns (outputs, summary).
    ``prof`` a StageProfiler (stage seconds), made here if None;
    ``features`` the dense features of the pixel refinement's
    consistency term (``weight_path`` their network's weights);
    ``associate`` False stops after the refinements."""
    from limap_tpu_torch.base.linetrack import (batch_to_tracks,
                                                tracks_to_batch)
    from limap_tpu_torch.optimize.line_ba import get_output_tracks
    from limap_tpu_torch.optimize.line_refinement import (
        RefinementConfig, build_fconsis_terms, build_heatmap_patches,
        line_refinement, refine_data, solve_line_refinement, support_vps)
    from limap_tpu_torch.pointsfm import read_model
    from limap_tpu_torch.runners import pointline_association
    from limap_tpu_torch.util.profiler import StageProfiler
    from limap_tpu_torch.vplib import get_vp_detector
    prof = prof or StageProfiler(device=device)
    ref_cfg, pl_cfg = configs()
    out = {}
    with prof.stage("vp_detect"):
        vpres = get_vp_detector(ref_cfg["vpdet"], device=device) \
            .detect_vp_all_images(all_2d_segs)
    with prof.stage("line_refinement"):
        out["refined"] = line_refinement(ref_cfg, tracks, imagecols,
                                         vpresults=vpres, device=device)
    with prof.stage("features"):
        feats, heat = feature_maps(imagecols, device, features,
                                   weight_path)
        id2idx = imagecols.img_id_to_index()
        batch = tracks_to_batch(tracks, id2idx, device=device)
        views = imagecols.batch(device)
        hm = build_heatmap_patches(batch, heat)
        fc = build_fconsis_terms(
            batch, views, feats, id2idx,
            n_samples=int(ref_cfg["n_samples_feature"]),
            sample_range=(ref_cfg["sample_range_min"],
                          ref_cfg["sample_range_max"]))
        vps, has = support_vps(batch, vpres)
    with prof.stage("pixel_refinement"):
        cfg_px = RefinementConfig.from_dict(dict(ref_cfg, use_heatmap=True,
                                                 use_feature=True))
        lines, result = solve_line_refinement(batch, views, cfg_px, vps, has,
                                              hm, fc)
        out["refined_px"] = batch_to_tracks(get_output_tracks(
            batch, views, lines, cfg_px.num_outliers_aggregator))
    # the pixel solve's input (its rows are the tracks in order, then
    # padding) and the tracks it took off their heatmap patches
    out["pixel_solve"] = refine_data(batch, views, cfg_px, vps, has, hm, fc)
    left = left_patches(*out["pixel_solve"], result.params)
    left_rows = np.nonzero(left)[0]
    left64 = float64_ends(batch, views, cfg_px, out["pixel_solve"],
                          result.params, left_rows) if len(left_rows) else []
    px_summary = dict(
        track_summary(out["refined_px"], gt),
        pixel_cost0=float(result.cost0.sum()),
        pixel_cost=float(result.cost.sum()),
        n_accepted=int(result.n_accepted.sum()),
        n_left_patches=int(left.sum()),
        left_patches_dist_m=line_distances(
            [out["refined_px"][r] for r in left_rows], gt).tolist(),
        left_patches_dist_f64_m=line_distances(left64, gt).tolist())
    if not associate:
        return out, {"refined": track_summary(out["refined"], gt),
                     "refined_px": px_summary,
                     "feature_terms": int((fc[7] > 0).sum()),
                     "stages_s": dict(prof.times)}
    with prof.stage("association"):
        _, _, p2d, p3d = read_model(model_path)
        cfg = dict(pl_cfg, output_dir=out_dir)
        new_tracks, points, vps_out, assoc = pointline_association(
            cfg, imagecols, tracks, all_2d_segs, p3d, p2d, device=device,
            return_associator=True)
        bpt = assoc.get_bipartite3d_pointline()
    out.update(associated=new_tracks, points=points, vps=vps_out,
               p3d=p3d, bipartite=bpt, vpresults=vpres)
    # the points on GT lines (ids from n_wall_points on) before and after
    ids = list(p3d)            # the runner's order of the points
    xyz0 = np.stack([np.asarray(p3d[i]["xyz"]) for i in ids])
    on_line = np.asarray(ids) >= n_wall_points
    g = np.asarray(gt, np.float64)
    d, dd = g[:, 1] - g[:, 0], ((g[:, 1] - g[:, 0]) ** 2).sum(1)
    dist = lambda p: pipeline._point_to_segments_min_dist(p, g[:, 0], d, dd)
    hard = [(p, l) for p in bpt.get_point_ids()
            for l in bpt.neighbor_lines(p)]
    summary = {
        "refined": track_summary(out["refined"], gt),
        "refined_px": px_summary,
        "associated": track_summary(new_tracks, gt),
        "input": track_summary(tracks, gt),
        "points": {"n": len(points), "n_on_lines": int(on_line.sum()),
                   "line_points_dist_before_m": float(np.median(
                       dist(xyz0[on_line]))) if on_line.any() else 0.0,
                   "line_points_dist_after_m": float(np.median(
                       dist(points[on_line]))) if on_line.any() else 0.0,
                   "wall_points_moved_median_m": float(np.median(
                       np.linalg.norm(points[~on_line] - xyz0[~on_line],
                                      axis=1))) if (~on_line).any() else 0.0},
        "associations": {"soft": len(assoc.pl_weights), "hard": len(hard),
                         "hard_line_points": int(sum(
                             on_line[p] for p, _ in hard))},
        "vps": vp_summary(vps_out),
        "feature_terms": int((fc[7] > 0).sum()),
        "stages_s": dict(prof.times),
    }
    return out, summary
