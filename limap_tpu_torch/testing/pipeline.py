"""The end-to-end line-mapping pipeline from pixels, stage by stage, on a
synthetic rendered scene: the counterpart of the reference's
``bench_pipeline.py`` (posed 800x600 views of a wall of lines: detection
-> endpoint descriptors + batched neighbour matching -> triangulation +
scoring -> track building -> filters + remerge -> line bundle
adjustment), with the default config's front end (``tpu_lsd``,
``patch_endpoints``, ``nn_endpoints``).

Strokes are drawn by a small numpy rasteriser, so the scene needs no
OpenCV.  There is no baseline comparison here: the C++ engine belongs to
the reference package.

    python -m limap_tpu_torch.testing.pipeline [N_VIEWS] [DEVICE]

prints one JSON line (stage seconds, counts, quality); DEVICE defaults
to cuda, and ``cpu`` must be asked for.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.util.profiler import StageProfiler

N_VIEWS = 100
H, W = 600, 800
N_GT_LINES = 120
N_NEIGHBORS = 10
WALL_Z = 10.0
# a facade: the wall's lines horizontal or vertical
FACADE = (0.0, np.pi / 2)
# the façade's COLMAP model: wall points with a relief of +-RELIEF m,
# each listed with the views that see it in the central VISIBLE share
# of the image
N_POINTS = 2000
RELIEF = 0.5
VISIBLE = 0.6
F2D = {"th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
       "th_sv_num_supports": 3, "th_overlap": 0.05,
       "th_overlap_num_supports": 3}


def draw_line(img: np.ndarray, p1, p2, value: int, width: float = 2.0):
    """Draw the segment p1-p2 (xy pixels) into uint8 ``img`` in place:
    every pixel whose centre lies within ``width / 2`` of the segment
    takes ``value``."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    r = width / 2.0
    x_lo = max(int(np.floor(min(p1[0], p2[0]) - r)), 0)
    x_hi = min(int(np.ceil(max(p1[0], p2[0]) + r)), img.shape[1] - 1)
    y_lo = max(int(np.floor(min(p1[1], p2[1]) - r)), 0)
    y_hi = min(int(np.ceil(max(p1[1], p2[1]) + r)), img.shape[0] - 1)
    if x_lo > x_hi or y_lo > y_hi:
        return
    ys, xs = np.mgrid[y_lo:y_hi + 1, x_lo:x_hi + 1]
    d = p2 - p1
    t = ((xs - p1[0]) * d[0] + (ys - p1[1]) * d[1]) / max(d @ d, 1e-12)
    t = np.clip(t, 0.0, 1.0)
    dist2 = (xs - p1[0] - t * d[0]) ** 2 + (ys - p1[1] - t * d[1]) ** 2
    img[y_lo:y_hi + 1, x_lo:x_hi + 1][dist2 <= r * r] = value


def ring_pose(frac: float, rng):
    """(R, t) of a camera at ``frac`` of the way round the scene's ring,
    looking at the wall, its rotation jittered from ``rng``."""
    Rm = Rotation.from_rotvec(rng.normal(size=3) * 0.02).as_matrix()
    C = np.array([3.5 * np.sin(2 * np.pi * frac),
                  2.5 * np.cos(2 * np.pi * frac),
                  0.2 * np.sin(4 * np.pi * frac)])
    return Rm, -Rm @ C


def render_view(gt, K, hw, Rm, t, rng) -> np.ndarray:
    """The uint8 [H, W] image of the GT lines seen from (Rm, t): strokes
    on a light background, plus Gaussian noise from ``rng``."""
    h, w = hw
    img = np.full((h, w), 235, np.uint8)
    for li, line in enumerate(gt):
        p1 = K @ (Rm @ line[0] + t)
        p2 = K @ (Rm @ line[1] + t)
        if p1[2] <= 0 or p2[2] <= 0:
            continue
        draw_line(img, (p1[:2] / p1[2]).astype(int),
                  (p2[:2] / p2[2]).astype(int), int(15 + (li * 37) % 180))
    return np.clip(img.astype(np.float64) + rng.normal(size=(h, w)) * 2, 0,
                   255).astype(np.uint8)


def build_scene(n_views=N_VIEWS, n_lines=N_GT_LINES, seed=0, hw=(H, W),
                n_neighbors=N_NEIGHBORS, image_dir=None, directions=None):
    """Render the wall-of-lines scene: (imagecols, imgs {img_id: uint8
    [H, W]}, nbrs {img_id: [ids]}, gt [n_lines, 2, 3]).  Cameras, GT
    lines, neighbours and image noise come from ``seed`` in the
    reference's order of draws.  A size ``hw`` other than 600 x 800
    scales the focal length with the width.  With ``image_dir`` every
    image is also saved there as ``img_{id}.npy`` and named in the
    collection, so a runner can read it.  ``directions`` (angles in the
    wall's plane, radians) draws each GT line's direction from those
    (:data:`FACADE`: horizontal or vertical); None draws it uniformly,
    as the reference does."""
    h, w = hw
    rng = np.random.default_rng(seed)
    f = 700.0 * w / W
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cams = {0: Camera(K=K, hw=(h, w), cam_id=0)}

    gt = []
    for _ in range(n_lines):
        p = rng.uniform([-6, -4.5, WALL_Z], [6, 4.5, WALL_Z])
        ang = rng.uniform(0, np.pi) if directions is None \
            else directions[int(rng.integers(len(directions)))]
        ln = rng.uniform(1.0, 4.0)
        d = np.array([np.cos(ang), np.sin(ang), 0.0])
        gt.append([p - d * ln / 2, p + d * ln / 2])
    gt = np.asarray(gt)

    images, imgs = {}, {}
    for k in range(n_views):
        Rm, t = ring_pose(k / n_views, rng)
        img = render_view(gt, K, hw, Rm, t, rng)
        imgs[k] = img
        name = "none"
        if image_dir is not None:
            os.makedirs(image_dir, exist_ok=True)
            name = os.path.join(image_dir, f"img_{k}.npy")
            np.save(name, img)
        images[k] = CameraImage(0, CameraPose(R=Rm, tvec=t), name)
    imagecols = ImageCollection(cams, images)
    half = n_neighbors // 2
    nbrs = {i: [j % n_views for j in range(i - half, i + half + 1)
                if j % n_views != i] for i in range(n_views)}
    return imagecols, imgs, nbrs, gt


def write_colmap_scene(workdir, n_views=N_VIEWS, n_lines=N_GT_LINES, seed=0,
                       hw=(H, W), n_points=N_POINTS):
    """The façade variant of the scene (:data:`FACADE`) as a COLMAP text
    model: images as ``.npy`` in ``workdir/images``, the model in
    ``workdir/sparse`` (cameras, posed images named relative to the image
    folder, and ``n_points`` wall points drawn from ``seed``, each with
    the views that see it).  Returns (model path, image path, gt)."""
    from limap_tpu_torch.pointsfm import write_model_txt
    image_dir = os.path.join(workdir, "images")
    imagecols, _, _, gt = build_scene(n_views, n_lines, seed, hw,
                                      image_dir=image_dir,
                                      directions=FACADE)
    for img_id in imagecols.get_img_ids():
        imagecols.change_image_name(
            img_id, os.path.basename(imagecols.image_name(img_id)))
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform([-6, -4.5, WALL_Z - RELIEF],
                      [6, 4.5, WALL_Z + RELIEF], (n_points, 3))
    h, w = hw
    lo = np.array([w, h]) * (1 - VISIBLE) / 2
    hi = np.array([w, h]) - lo
    seen = []
    for img_id in imagecols.get_img_ids():
        view = imagecols.camview(img_id)
        pc = pts @ view.R().T + view.T()
        uv = pc[:, :2] / pc[:, 2:] * view.cam.kvec()[:2] \
            + view.cam.kvec()[2:]
        seen.append((pc[:, 2] > 0) & np.all((uv >= lo) & (uv <= hi), 1))
    seen = np.stack(seen, 1)
    ids = np.asarray(imagecols.get_img_ids())
    points3d = {int(p): {"xyz": pts[p], "image_ids": ids[seen[p]].tolist()}
                for p in range(n_points) if seen[p].sum() >= 2}
    model = os.path.join(workdir, "sparse")
    write_model_txt(model, imagecols, points3d)
    return model, image_dir, gt


def colmap_vp_config(output_dir, n_neighbors=N_NEIGHBORS) -> dict:
    """:func:`runner_config` with ``use_vp`` (the default J-Linkage VP
    detector of the config file), the neighbours and ranges left to the
    point model."""
    cfg = runner_config(output_dir, n_neighbors)
    cfg["triangulation"]["use_vp"] = True
    return cfg


def _point_to_segments_min_dist(pts, a, d, dd):
    """Distance of each point [P, 3] to the nearest of the segments
    a + [0, 1] d."""
    w = pts[:, None, :] - a[None]
    proj = np.clip((w * d[None]).sum(-1) / dd[None], 0.0, 1.0)
    close = a[None] + proj[..., None] * d[None]
    return np.linalg.norm(pts[:, None] - close, axis=-1).min(1)


def quality_eval(linetracks, gt, taus=(0.01, 0.05, 0.10),
                 n_samples=50, min_support=4):
    """Synthetic-protocol quality metrics over tracks of >=
    ``min_support`` images: length recall @ tau = sum over tracks of
    track length x inlier ratio(tau), precision @ tau = % of tracks with
    any inlier sample, gt_coverage @ tau = % of the GT length whose
    samples lie within tau of ANY track (duplicate tracks cannot inflate
    it).  Distances are exact point-to-segment, in float64."""
    gt = np.asarray(gt, np.float64)  # [G, 2, 3]
    a = gt[:, 0]
    d = gt[:, 1] - gt[:, 0]
    dd = (d * d).sum(1)
    tracks = [t for t in linetracks if t.count_images() >= min_support]
    out = {"n_tracks": len(tracks)}
    if not tracks:
        for tau in taus:
            out[f"recall_{tau}"] = 0.0
            out[f"precision_{tau}"] = 0.0
        return out
    ts = np.linspace(0, 1, n_samples)
    pred = np.stack([np.asarray(t.line, np.float64) for t in tracks])
    lengths = np.linalg.norm(pred[:, 1] - pred[:, 0], axis=1)
    dist = np.stack([_point_to_segments_min_dist(
        s[None] + ts[:, None] * (e - s)[None], a, d, dd)
        for s, e in pred])                           # [T, S]
    for tau in taus:
        r = (dist < tau).mean(1)
        out[f"recall_{tau}"] = float((lengths * r).sum())
        out[f"precision_{tau}"] = float((r > 0).mean() * 100.0)
    out["total_track_length"] = float(lengths.sum())
    out["gt_total_length"] = float(np.sqrt(dd).sum())

    pa = pred[:, 0]
    pd = pred[:, 1] - pred[:, 0]
    pdd = np.maximum((pd * pd).sum(1), 1e-12)
    gt_len = np.sqrt(dd)
    gpts = (gt[:, None, 0] * (1 - ts[None, :, None])
            + gt[:, None, 1] * ts[None, :, None])   # [G, S, 3]
    gdist = _point_to_segments_min_dist(gpts.reshape(-1, 3), pa, pd, pdd) \
        .reshape(len(gt), len(ts))
    for tau in taus:
        cov = (gdist < tau).mean(1)                 # [G]
        out[f"gt_coverage_{tau}"] = float(
            (gt_len * cov).sum() / max(gt_len.sum(), 1e-12) * 100.0)
    return out


def map_lines(imagecols, segs, matches, device, prof):
    """Stages 3-6 with the protocol's settings (32 triangulations a
    node, ``F2D``, remerge, 20 LM iterations) from 2D segments {img_id:
    [N, >=4]} and ``matches`` as ``triangulate_all`` takes them, timed
    as ``prof``'s stages triangulate, tracks, filters and ba.  Returns
    the line tracks."""
    from limap_tpu_torch.base.line_linker import LineLinker3dConfig
    from limap_tpu_torch.base.linetrack import batch_to_tracks
    from limap_tpu_torch.merging.merging import (compact_track_batch,
                                                 filter_chain_batch)
    from limap_tpu_torch.optimize.line_ba import (
        LineBAConfig, get_output_tracks, solve_line_bundle_adjustment)
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)

    views = imagecols.batch(device)
    # [3] triangulation + scoring, [4] track building
    with prof.stage("triangulate"):
        tri = GlobalLineTriangulator(
            TriangulatorConfig(max_tris_per_node=32), device=device)
        tri.init(segs, imagecols)
        tri.triangulate_all(matches)
    with prof.stage("tracks"):
        tb, host = tri.compute_track_batch(return_host=True)

    # [5] filters + remerge
    with prof.stage("filters"):
        if tb is not None:
            tb, host = filter_chain_batch(tb, views, F2D,
                                          LineLinker3dConfig(), host=host)
            tb, host = compact_track_batch(
                host.refresh(tb, with_line=True), return_host=True,
                device=device)
            if not host.track_mask.any():
                tb = None

    # [6] line bundle adjustment
    linetracks = []
    with prof.stage("ba"):
        if tb is not None:
            cfg = LineBAConfig(max_num_iterations=20)
            refined, _ = solve_line_bundle_adjustment(tb, views, cfg)
            tb = get_output_tracks(tb, views, refined,
                                   cfg.num_outliers_aggregator)
            linetracks = [x for x in batch_to_tracks(tb, host=host)
                          if x.count_lines() > 0]
    return linetracks


def runner_config(output_dir, n_neighbors=N_NEIGHBORS) -> dict:
    """The default triangulation config with the protocol's settings
    where it has them (neighbours, top-2 matches at score 0.5, 32
    triangulations a node, ``F2D``, 20 LM iterations), for
    ``line_triangulation`` on a :func:`build_scene` collection.  The
    runner describes at full resolution and remerges with the config
    file's 3D linker, so its tracks are not those of :func:`run`."""
    from limap_tpu_torch.util.config import default_triangulation_config
    cfg = default_triangulation_config()
    cfg.update(output_dir=output_dir, n_neighbors=n_neighbors)
    cfg["line2d"]["matcher"].update(topk=2, min_score=0.5)
    cfg["triangulation"].update(max_tris_per_node=32, filtering2d=dict(F2D))
    cfg["refinement"]["max_num_iterations"] = 20
    return cfg


def exhaustive_runner_config(output_dir, n_neighbors=N_NEIGHBORS) -> dict:
    """:func:`runner_config` with ``use_exhaustive_matcher``: no
    descriptors and no matcher; every line is proposed against every
    line of each neighbour."""
    cfg = runner_config(output_dir, n_neighbors)
    cfg["triangulation"]["use_exhaustive_matcher"] = True
    return cfg


def run(n_views=N_VIEWS, scene=None, device=None):
    """One pass of the pipeline from pixels with per-stage wall-clock
    (each stage ends with a device synchronize).  ``scene`` is a
    :func:`build_scene` result (default: the protocol scene at
    ``n_views``).  Returns a dict with ``stages_s``, ``n_tracks``,
    ``avg_segs``, ``quality`` and the ``linetracks``, ``segs`` and
    ``matches`` themselves."""
    from limap_tpu_torch.line2d.base import detect_arrays_parallel
    from limap_tpu_torch.line2d.endpoints import (
        match_all_neighbors_batched, upload_image_u8)

    device = resolve_device(device)
    imagecols, imgs, nbrs, gt = scene or build_scene(n_views)
    prof = StageProfiler(device=device)

    # [1] detection, with the half-resolution uploads for stage 2
    with prof.stage("detect"):
        device_imgs = {i: upload_image_u8(img, downscale=2, device=device)
                       for i, img in imgs.items()}
        segs = detect_arrays_parallel({"method": "tpu_lsd"}, imgs,
                                      device=device)

    # [2] fused describe + match: descriptors stay on the device between
    # extraction and pair scoring
    with prof.stage("describe_match"):
        matches = match_all_neighbors_batched(
            imgs, segs, nbrs, topk=2, min_score=0.5,
            device_imgs=device_imgs, img_scale=0.5, device=device)

    linetracks = map_lines(imagecols, segs, matches, device, prof)
    return {"stages_s": dict(prof.times), "n_tracks": len(linetracks),
            "avg_segs": float(np.mean([len(s) for s in segs.values()])),
            "quality": quality_eval(linetracks, gt),
            "linetracks": linetracks, "segs": segs, "matches": matches}


def main(n_views: int = N_VIEWS, device=None) -> None:
    r = run(int(n_views), device=device)
    print(json.dumps({
        "device": str(resolve_device(device)), "n_views": int(n_views),
        "stages_s": r["stages_s"], "total_s": sum(r["stages_s"].values()),
        "n_tracks": r["n_tracks"], "avg_segs": r["avg_segs"],
        "n_matches": int(sum(len(m) for v in r["matches"].values()
                             for m in v.values())),
        "quality": r["quality"]}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
