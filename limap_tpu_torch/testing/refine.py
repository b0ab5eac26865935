"""The joint SfM refinement's path on the façade scene (chip_smoke phases
14a and 14): the rendered façade of ``testing/pipeline.py`` written as
COLMAP models with wall points and their 2D observations, the poses
perturbed by ``refine_sfm``'s own rule, then
``runners/hypersim/refine_sfm.py::run_refine_sfm`` (a line map from the
``.npy`` pixels on the noisy poses, then the hybrid BA on kernels O, P
and Q).  Also the small writers the CLIs of phase 14 read: a Bundler
``bundle.out`` with its image list, and the localization CLI's files.

    python -m limap_tpu_torch.testing.refine [N_VIEWS] [DEVICE] [--gt-map]

prints the path's summary as one JSON line (DEVICE defaults to cuda).
With ``--gt-map`` the path is phase 14's line half instead: the line map
on the GT poses (:func:`gt_line_map`) through the hybrid BA on the noisy
poses and points (:func:`run_map_ba`).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from limap_tpu_torch.testing import pipeline

N_POINTS = 4000
NOISE_PX = 0.3
POSE_NOISE = 0.01
BA_ITERATIONS = 20


def write_refine_scene(workdir, n_views=pipeline.N_VIEWS,
                       n_lines=pipeline.N_GT_LINES, seed=0,
                       hw=(pipeline.H, pipeline.W), n_points=N_POINTS,
                       noise_px=NOISE_PX, pose_noise=POSE_NOISE):
    """Render the façade (images as ``.npy`` in ``workdir/images``), draw
    ``n_points`` wall points (from ``seed + 1``; each kept where two or
    more views see it in the central share of the image), their 2D
    observations (the GT projection plus ``noise_px`` of noise, from
    ``seed + 3``), and write two COLMAP text models of them: ``sparse_gt``
    with the GT poses and ``sparse`` with the poses perturbed as
    ``refine_sfm`` does (seed 0, the first two exact).  Returns a dict:
    model, model_gt, image_dir, imagecols_gt (named as in the models),
    gt lines, points3d, points2d."""
    from limap_tpu_torch.pointsfm import write_model_txt
    from limap_tpu_torch.runners.hypersim.refine_sfm import perturb_poses
    image_dir = os.path.join(workdir, "images")
    imagecols, _, _, gt = pipeline.build_scene(
        n_views, n_lines, seed, hw, image_dir=image_dir,
        directions=pipeline.FACADE)
    for img_id in imagecols.get_img_ids():
        imagecols.change_image_name(
            img_id, os.path.basename(imagecols.image_name(img_id)))
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform([-6, -4.5, pipeline.WALL_Z - pipeline.RELIEF],
                      [6, 4.5, pipeline.WALL_Z + pipeline.RELIEF],
                      (n_points, 3))
    h, w = hw
    lo = np.array([w, h]) * (1 - pipeline.VISIBLE) / 2
    hi = np.array([w, h]) - lo
    ids = np.asarray(imagecols.get_img_ids())
    seen, uvs = [], []
    for img_id in ids:
        view = imagecols.camview(int(img_id))
        pc = pts @ view.R().T + view.T()
        uv = pc[:, :2] / pc[:, 2:] * view.cam.kvec()[:2] \
            + view.cam.kvec()[2:]
        seen.append((pc[:, 2] > 0) & np.all((uv >= lo) & (uv <= hi), 1))
        uvs.append(uv)
    seen = np.stack(seen, 1)
    keep = [p for p in range(n_points) if seen[p].sum() >= 2]
    points3d = {p: {"xyz": pts[p], "image_ids": ids[seen[p]].tolist(),
                    "point2D_idxs": []} for p in keep}
    nrng = np.random.default_rng(seed + 3)
    points2d = {}
    for v, img_id in enumerate(ids):
        sel = [p for p in keep if seen[p, v]]
        uv = uvs[v][sel] + nrng.normal(0, noise_px, (len(sel), 2))
        points2d[int(img_id)] = np.concatenate(
            [uv, np.asarray(sel, np.float64)[:, None]], 1)
        for row, p in enumerate(sel):
            points3d[p]["point2D_idxs"].append(row)
    model_gt = os.path.join(workdir, "sparse_gt")
    model = os.path.join(workdir, "sparse")
    write_model_txt(model_gt, imagecols, points3d, points2d)
    write_model_txt(model, perturb_poses(imagecols, pose_noise), points3d,
                    points2d)
    return {"model": model, "model_gt": model_gt, "image_dir": image_dir,
            "imagecols_gt": imagecols, "gt": gt, "points3d": points3d,
            "points2d": points2d}


def refine_config(output_dir, n_neighbors=pipeline.N_NEIGHBORS,
                  ba_iterations=BA_ITERATIONS) -> dict:
    """``pipeline.runner_config`` with the BA's iteration count."""
    cfg = pipeline.runner_config(output_dir, n_neighbors)
    cfg["ba_iterations"] = ba_iterations
    return cfg


def imagecols_gt_read(scene):
    """The GT collection with the image names joined to the image folder
    (as ``ReadInfos(model, image_dir)`` names them)."""
    from limap_tpu_torch.pointsfm import ReadInfos
    return ReadInfos(scene["model_gt"], scene["image_dir"])


def run(scene, output_dir, device=None, cfg=None):
    """``run_refine_sfm`` on the scene's noisy COLMAP model (the COLMAP
    branch): returns (its output dict, seconds, summary)."""
    from limap_tpu_torch.runners.hypersim.refine_sfm import (
        read_colmap_inputs, run_refine_sfm)
    cfg = cfg or refine_config(output_dir)
    imagecols, pointtracks = read_colmap_inputs(scene["model"],
                                                scene["image_dir"])
    gt = imagecols_gt_read(scene)
    t0 = time.perf_counter()
    out = run_refine_sfm(cfg, gt, imagecols, pointtracks, device=device)
    secs = time.perf_counter() - t0
    return out, secs, summary(out, pointtracks, imagecols, gt)


def gt_line_map(scene, output_dir, device=None):
    """The façade's line map on its GT poses: ``line_triangulation`` on
    the GT model, with neighbours from its points (phase 14's direct
    call).  refine_sfm's noisy poses leave the map a few tracks."""
    from limap_tpu_torch.pointsfm import ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation
    gt_cols = imagecols_gt_read(scene)
    return line_triangulation(pipeline.runner_config(output_dir), gt_cols,
                              points3d=ReadPointTracks(scene["model_gt"]),
                              device=device)


def run_map_ba(scene, linetracks, device=None, solver="dense",
               n_iterations=BA_ITERATIONS):
    """``run_refine_sfm``'s hybrid BA on the scene's noisy poses and
    points with the line map ``linetracks`` (the GT-pose map: the BA's
    line half at the size of a real map).  Returns (the BA's output,
    seconds, summary): the median pose errors before and after (float64),
    the line tracks in and out, their median distance to the GT lines
    before and after (m), the costs and accepts."""
    from limap_tpu_torch.parallel import (HybridBAOptions,
                                          solve_hybrid_bundle_adjustment)
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    from limap_tpu_torch.testing.pointline import line_distances
    imagecols, pointtracks = read_colmap_inputs(scene["model"],
                                                scene["image_dir"])
    gt = imagecols_gt_read(scene)
    t0 = time.perf_counter()
    out = solve_hybrid_bundle_adjustment(
        imagecols, pointtracks, linetracks,
        HybridBAOptions(n_fixed_poses=2, solver=solver),
        n_iterations=n_iterations, device=device)
    secs = time.perf_counter() - t0
    cols, _, tracks, costs = out
    (te0, re0), (te1, re1) = (pose_errors64(c, gt) for c in (imagecols,
                                                             cols))
    return out, secs, {
        "trans_before": float(np.median(te0)),
        "rot_before": float(np.median(re0)),
        "trans_after": float(np.median(te1)),
        "rot_after": float(np.median(re1)),
        "n_tracks_in": len(linetracks), "n_tracks": len(tracks),
        "line_dist_before": float(np.median(line_distances(linetracks,
                                                           scene["gt"]))),
        "line_dist_after": float(np.median(line_distances(tracks,
                                                          scene["gt"]))),
        "cost_first": float(costs[0]), "cost_last": float(costs[-1]),
        "n_accepted": int(sum(b < a for a, b in zip(costs, costs[1:])))}


def pose_errors64(imagecols, imagecols_gt):
    """Per-image (centre distance m, rotation angle deg) in float64 from
    the quaternions (``eval_imagecols`` goes through float32 rotation
    matrices, which read any angle under ~0.03 deg as 0)."""
    from scipy.spatial.transform import Rotation
    te, re = [], []
    for i in imagecols_gt.get_img_ids():
        a, b = imagecols.campose(i), imagecols_gt.campose(i)
        ra, rb = (Rotation.from_quat(np.roll(p.qvec, -1)) for p in (a, b))
        ca, cb = (-r.inv().apply(p.tvec) for r, p in ((ra, a), (rb, b)))
        te.append(float(np.linalg.norm(ca - cb)))
        re.append(float(np.degrees((ra.inv() * rb).magnitude())))
    return te, re


def summary(out, pointtracks=(), imagecols_in=None, imagecols_gt=None):
    """Median pose errors before and after (in float64 when the input and
    GT collections are given), track and point counts, the costs."""
    (te0, re0), (te1, re1) = out["errors_before"], out["errors_after"]
    if imagecols_gt is not None:
        te0, re0 = pose_errors64(imagecols_in, imagecols_gt)
        te1, re1 = pose_errors64(out["imagecols"], imagecols_gt)
    return {"trans_before": float(np.median(te0)),
            "rot_before": float(np.median(re0)),
            "trans_after": float(np.median(te1)),
            "rot_after": float(np.median(re1)),
            "n_tracks": len(out["linetracks"]),
            "n_points": len(out["points"]),
            "n_point_obs": int(sum(len(t.image_id_list)
                                   for t in pointtracks)),
            "cost_first": float(out["costs"][0]),
            "cost_last": float(out["costs"][-1]),
            "n_accepted": int(sum(b < a for a, b in zip(out["costs"],
                                                         out["costs"][1:])))}


def write_bundler(folder, imagecols, points3d,
                  list_name="bundle.list.txt", model_name="bundle.out"):
    """A Bundler v0.3 reconstruction of a PINHOLE (fx = fy, zero
    distortion) collection: ``folder/list_name`` with the image names and
    ``folder/model_name`` with each camera (f k1 k2, R and t in Bundler's
    camera looking down -z) and each point (xyz, colour, its views).
    The point observations are written as (view, index 0, 0, 0): the
    reader takes the views alone."""
    flip = np.diag([1.0, -1.0, -1.0])
    ids = imagecols.get_img_ids()
    row = {img_id: i for i, img_id in enumerate(ids)}
    os.makedirs(os.path.dirname(os.path.join(folder, model_name)) or folder,
                exist_ok=True)
    with open(os.path.join(folder, list_name), "w") as f:
        for img_id in ids:
            f.write(imagecols.image_name(img_id) + "\n")
    lines = ["# Bundle file v0.3", f"{len(ids)} {len(points3d)}"]
    for img_id in ids:
        view = imagecols.camview(img_id)
        fx = view.cam.kvec()[0]
        lines.append(f"{float(fx)!r} 0 0")
        R, t = flip @ view.R(), flip @ view.T()
        lines += [" ".join(repr(float(v)) for v in r) for r in R]
        lines.append(" ".join(repr(float(v)) for v in t))
    for rec in points3d.values():
        lines.append(" ".join(repr(float(v)) for v in rec["xyz"]))
        lines.append("128 128 128")
        obs = [f"{row[i]} 0 0 0" for i in rec["image_ids"] if i in row]
        lines.append(" ".join([str(len(obs))] + obs))
    with open(os.path.join(folder, model_name), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(n_views=pipeline.N_VIEWS, device=None, gt_map=False):
    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        scene = write_refine_scene(workdir, n_views)
        if not gt_map:
            _, secs, summ = run(scene, os.path.join(workdir, "out"), device)
            print(json.dumps(dict(summ, seconds=secs)))
            return
        t0 = time.perf_counter()
        tracks = gt_line_map(scene, os.path.join(workdir, "direct"), device)
        map_s = time.perf_counter() - t0
        _, secs, summ = run_map_ba(scene, tracks, device)
    print(json.dumps(dict(summ, n_views=n_views, map_s=map_s, ba_s=secs)))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--gt-map"]
    main(int(args[0]) if args else pipeline.N_VIEWS,
         args[1] if len(args) > 1 else None, "--gt-map" in sys.argv[1:])
