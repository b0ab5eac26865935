"""Quality references for chip_smoke.py's full-width phases, from the JAX
package on the CPU.  Each mode prints one JSON line.  Run from the repo
root:

    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --from-pixels [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --runner [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --localize [N_QUERIES]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --fitnmerge [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --exhaustive [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --colmap-vp [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --pointline [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --refine-sfm [N_VIEWS]
    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py \
        --refine-sfm-lines [N_VIEWS]

Without arguments: the slice from given segments and matches
(triangulate -> tracks -> filters + remerge -> line BA) on the protocol
scene of bench.py (100 views x 1500 lines x 20 neighbours,
max_tris_per_node=32), its lines scored against a GT cloud of 500 points
per GT segment with 1000 samples per line at taus (0.01, 0.05, 0.10).
The nearest-neighbour distances come from an exact k-d tree (scipy), so
the scoring does not depend on either package's kernel.

With ``--from-pixels``: the pipeline from pixels on the rendered scene
of limap_tpu_torch/testing/pipeline.py (the port's rasteriser draws the
strokes, so both packages see the same images): tpu_lsd detection,
half-resolution patch-endpoint descriptors and the batched neighbour
matcher (topk 2, min_score 0.5), then the same stages 3-6, scored by
bench_pipeline.quality_eval.  About a minute on the CPU at 100 views.

With ``--runner``: limap_tpu.runners.line_triangulation on the same
rendered scene, its images written as PNG (the JAX package reads images
through OpenCV), with the config of pipeline.runner_config; the same
JSON keys.

With ``--localize``: that runner's map of the 100-view scene, then
limap_tpu.runners.hybrid_localization with the default localization
config on the first N_QUERIES (default 10) queries of
limap_tpu_torch/testing/localization.py (rendered between database
views, with their priors, retrievals and 1000 point matches each):
per-query pose errors, the count under 5 cm / 0.5 deg and the medians.

With ``--fitnmerge``: limap_tpu.runners.line_fitnmerge on the same
rendered scene (default 100 views), its images as PNG and each view's
analytic depth of the wall plane (limap_tpu_torch/testing/fitnmerge.py),
with cfgs/fitnmerge/default.yaml and the scene's 10 neighbours: the
track counts (all, and of >= 4 images), the average segments an image,
the fitted segments, quality_eval and the runner's stage seconds.  Eager
JAX compiles anew for every image's segment count: ~7 s an image.

With ``--exhaustive``: the PORT's runner (limap_tpu_torch.runners.
line_triangulation on the CPU, with the plain versions of its kernels)
with pipeline.exhaustive_runner_config (no descriptors, no matcher: every
line against every line of the scene's 10 neighbours) on the same
rendered scene (default 100 views) from .npy images: the track counts,
the average segments an image, quality_eval, the proposals (candidate
pairs, survivors in all and the most of a line) and the stage seconds.
The JAX package cannot give this reference: its exhaustive path keeps
the first max_tris_per_node raw candidates of a line before any cull, so
at ~491 segments an image every line keeps only candidates of its first
neighbour, whose pairs all share a slot and score 0.  Beside the port's
numbers the mode records what JAX's runner gives on the same images (as
PNG), to keep that collapse on record.

With ``--colmap-vp``: the façade variant of the rendered scene (its
lines horizontal or vertical) written as a COLMAP text model with wall
points (limap_tpu_torch/testing/pipeline.py::write_colmap_scene), read
back and triangulated with ``use_vp`` and pipeline.colmap_vp_config,
neighbours and ranges from the model: the PORT on the CPU (the JAX
package's VP bank of the neighbour line turns that line's VP into a
direction with the wrong view, ROADMAP.md section 3), then the JAX
package's runner beside it; the track counts, the average segments, the
matches, quality_eval and the stage seconds.

With ``--pointline``: the PORT on the CPU over chip_smoke phase 12's
inputs: the ``--colmap-vp`` map of the façade (the port's runner), a
second COLMAP model of the scene with 4,000 points on the GT lines and
every point's 2D observations (pipeline.write_colmap_scene with
n_line_points), then limap_tpu_torch/testing/pointline.py::run: the
refinement CLI's path with use_vp, the refinement with the heatmap and
feature-consistency terms, and pointline_association; its summary.
Beside it, the JAX package's line_refinement and pointline_association
on the same map with the port's VP results replayed (patching the JAX
runner's get_vp_detector at run time: the J-Linkage hypotheses come from
another generator).

With ``--refine-sfm-lines``: both packages' line_triangulation on
chip_smoke phase 14's façade (limap_tpu_torch/testing/refine.py) at
N_VIEWS (default 16), on refine_sfm's noisy poses and on the GT poses:
the track counts a package keeps on each.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
import bench_pipeline  # noqa: E402
from limap_tpu.base.image_collection import ImageCollection  # noqa: E402
from limap_tpu.base.line_linker import LineLinker3dConfig  # noqa: E402
from limap_tpu.base.linetrack import batch_to_tracks  # noqa: E402
from limap_tpu.merging.merging import (compact_track_batch,  # noqa: E402
                                       filter_chain_batch)
from limap_tpu.optimize.line_ba import (LineBAConfig,  # noqa: E402
                                        get_output_tracks,
                                        solve_line_bundle_adjustment)
from limap_tpu.triangulation.triangulator import (  # noqa: E402
    GlobalLineTriangulator, TriangulatorConfig)
from limap_tpu_torch.testing import pipeline, synthetic  # noqa: E402

TAUS = (0.01, 0.05, 0.1)
F2D = {"th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
       "th_sv_num_supports": 3, "th_overlap": 0.05,
       "th_overlap_num_supports": 3}


def map_lines(imagecols, segs, matches):
    """Stages 3-6 of the JAX package with the protocol's settings."""
    views = imagecols.batch()
    tri = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=32))
    tri.init(segs, imagecols)
    tri.triangulate_all(matches)
    tb, host = tri.compute_track_batch(return_host=True)
    tb, host = filter_chain_batch(tb, views, F2D, LineLinker3dConfig(),
                                  host=host)
    tb, host = compact_track_batch(host.refresh(tb, with_line=True),
                                   return_host=True)
    cfg = LineBAConfig(max_num_iterations=20)
    refined, _ = solve_line_bundle_adjustment(tb, views, cfg)
    tb = get_output_tracks(tb, views, refined, cfg.num_outliers_aggregator)
    return [t for t in batch_to_tracks(tb, host=host) if t.count_lines()]


def from_pixels(n_views=100):
    from limap_tpu.line2d.base import detect_arrays_parallel
    from limap_tpu.line2d.endpoints import (match_all_neighbors_batched,
                                            upload_image_u8)
    port_cols, imgs, nbrs, gt = pipeline.build_scene(n_views)
    imagecols = ImageCollection.from_dict(port_cols.as_dict())
    t0 = time.perf_counter()
    segs = detect_arrays_parallel({"method": "tpu_lsd"}, imgs)
    t_detect = time.perf_counter() - t0
    device_imgs = {i: upload_image_u8(img, downscale=2)
                   for i, img in imgs.items()}
    matches = match_all_neighbors_batched(
        imgs, segs, nbrs, topk=2, min_score=0.5, device_imgs=device_imgs,
        img_scale=0.5)
    t_match = time.perf_counter() - t0 - t_detect
    tracks = map_lines(imagecols, segs, matches)
    print(json.dumps({
        "n_views": n_views, "n_tracks_all": len(tracks),
        "avg_segs": float(np.mean([len(s) for s in segs.values()])),
        "n_matches": int(sum(len(m) for v in matches.values()
                             for m in v.values())),
        "detect_s": t_detect, "match_s": t_match,
        "total_s": time.perf_counter() - t0,
        "quality": bench_pipeline.quality_eval(tracks, gt)}))


def runner(n_views=100):
    import cv2
    from limap_tpu.runners import line_triangulation
    from limap_tpu.util import io as limapio
    port_cols, imgs, nbrs, gt = pipeline.build_scene(n_views)
    with tempfile.TemporaryDirectory() as workdir:
        cols = port_cols.as_dict()
        for i, img in imgs.items():
            name = os.path.join(workdir, f"img_{i}.png")
            cv2.imwrite(name, img)
            cols["images"][i]["image_name"] = name
        cfg = pipeline.runner_config(os.path.join(workdir, "out"),
                                     n_neighbors=len(nbrs[0]))
        t0 = time.perf_counter()
        tracks = line_triangulation(cfg, ImageCollection.from_dict(cols),
                                    nbrs)
        total = time.perf_counter() - t0
        segs = limapio.read_all_segments_from_folder(os.path.join(
            cfg["dir_save"], "line_detections", "tpu_lsd", "segments"))
        matches_dir = os.path.join(
            cfg["dir_save"], "line_matchings", "tpu_lsd",
            "feats_patch_endpoints", "matches_nn_endpoints")
        n_matches = sum(len(m) for i in nbrs for m in np.load(
            os.path.join(matches_dir, f"matches_{i}.npy"),
            allow_pickle=True).item().values())
    print(json.dumps({
        "n_views": n_views, "n_tracks_all": len(tracks),
        "avg_segs": float(np.mean([len(s) for s in segs.values()])),
        "n_matches": int(n_matches), "total_s": total,
        "quality": bench_pipeline.quality_eval(tracks, gt)}))


def localize(n_queries=10):
    import cv2
    from limap_tpu.base.camera import CameraPose
    from limap_tpu.base.image_collection import ImageCollection as JCols
    from limap_tpu.runners import line_triangulation
    from limap_tpu_torch.testing import localization
    from limap_tpu_torch.util.config import default_localization_config
    import importlib
    runner_mod = importlib.import_module(
        "limap_tpu.runners.hybrid_localization")
    scene = pipeline.build_scene(100)
    port_cols, imgs, nbrs, gt = scene
    with tempfile.TemporaryDirectory() as workdir:
        cols = port_cols.as_dict()
        for i, img in imgs.items():
            name = os.path.join(workdir, f"img_{i}.png")
            cv2.imwrite(name, img)
            cols["images"][i]["image_name"] = name
        db = JCols.from_dict(cols)
        cfg = pipeline.runner_config(os.path.join(workdir, "map"),
                                     n_neighbors=len(nbrs[0]))
        t0 = time.perf_counter()
        tracks = line_triangulation(cfg, db, nbrs)
        map_s = time.perf_counter() - t0
        q = localization.build_queries(
            scene, n_queries, image_dir=os.path.join(workdir, "queries"),
            ext=".png")
        loc_cfg = default_localization_config()
        loc_cfg["output_dir"] = os.path.join(workdir, "loc")
        t0 = time.perf_counter()
        poses = runner_mod.hybrid_localization(
            loc_cfg, db, JCols.from_dict(q["imagecols"].as_dict()),
            q["points"], tracks, q["retrieval"])
        loc_s = time.perf_counter() - t0
    from limap_tpu_torch.base.camera import CameraPose as PortPose
    errors = localization.pose_errors(
        {k: PortPose(p.qvec, p.tvec) for k, p in poses.items()}, q["gt"])
    assert all(isinstance(p, CameraPose) for p in poses.values())
    print(json.dumps({
        "n_tracks": len(tracks), "map_s": map_s, "localize_s": loc_s,
        "errors": {str(k): list(v) for k, v in errors.items()},
        **localization.summarize(errors)}))


def fitnmerge(n_views=100):
    import cv2
    from limap_tpu.base.depth_reader_base import ArrayDepthReader
    from limap_tpu.runners import line_fitnmerge
    from limap_tpu.util.config import load_config
    from limap_tpu_torch.testing import fitnmerge as port_fitnmerge
    port_cols, imgs, nbrs, gt, depths = port_fitnmerge.build_scene(n_views)
    with tempfile.TemporaryDirectory() as workdir:
        cols = port_cols.as_dict()
        for i, img in imgs.items():
            name = os.path.join(workdir, f"img_{i}.png")
            cv2.imwrite(name, img)
            cols["images"][i]["image_name"] = name
        cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "cfgs", "fitnmerge", "default.yaml"))
        out = os.path.join(workdir, "out")
        cfg.update(output_dir=out, n_neighbors=len(nbrs[0]))
        t0 = time.perf_counter()
        tracks = line_fitnmerge(
            cfg, ImageCollection.from_dict(cols),
            {i: ArrayDepthReader(d.depth) for i, d in depths.items()}, nbrs)
        total = time.perf_counter() - t0
        summary = port_fitnmerge.summarize(tracks, out, gt)
    print(json.dumps({
        "n_views": n_views, "n_tracks_all": summary["n_tracks_all"],
        "n_tracks_nv4": summary["quality"]["n_tracks"],
        "avg_segs": summary["avg_segs"], "n_fitted": summary["n_fitted"],
        "total_s": total, "stages_s": summary["stages_s"],
        "quality": summary["quality"]}))


def exhaustive(n_views=100):
    import cv2
    from limap_tpu.runners import line_triangulation as jax_runner
    from limap_tpu_torch.base.image_collection import \
        ImageCollection as PortCollection
    from limap_tpu_torch.runners import line_triangulation as port_runner
    with tempfile.TemporaryDirectory() as workdir:
        port_cols, imgs, nbrs, gt = pipeline.build_scene(
            n_views, image_dir=os.path.join(workdir, "images"))
        out = {"n_views": n_views}
        cfg = pipeline.exhaustive_runner_config(
            os.path.join(workdir, "port"), n_neighbors=len(nbrs[0]))
        t0 = time.perf_counter()
        tracks = port_runner(cfg, PortCollection.from_dict(
            port_cols.as_dict()), nbrs, device="cpu")
        out["port"] = _exhaustive_summary(tracks, cfg, gt,
                                          time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        cols = port_cols.as_dict()
        for i, img in imgs.items():
            name = os.path.join(workdir, f"img_{i}.png")
            cv2.imwrite(name, img)
            cols["images"][i]["image_name"] = name
        cfg = pipeline.exhaustive_runner_config(
            os.path.join(workdir, "jax"), n_neighbors=len(nbrs[0]))
        t0 = time.perf_counter()
        tracks = jax_runner(cfg, ImageCollection.from_dict(cols), nbrs)
        out["jax"] = _exhaustive_summary(tracks, cfg, gt,
                                         time.perf_counter() - t0)
    print(json.dumps(out))


def colmap_vp(n_views=100, hw=None):
    """The façade scene as a COLMAP model (pipeline.write_colmap_scene),
    read back by each package and triangulated with use_vp, neighbours
    and ranges from the model's points: the PORT on the CPU first (its
    VP bank of the neighbour line takes that line's own view, where the
    JAX package takes the other view; ROADMAP.md section 3), then the
    JAX package's runner on the same images as PNG."""
    import cv2
    from limap_tpu.pointsfm import ReadInfos as jax_read_infos
    from limap_tpu.pointsfm import ReadPointTracks as jax_read_points
    from limap_tpu.runners import line_triangulation as jax_runner
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation as port_runner
    hw = hw or (pipeline.H, pipeline.W)
    with tempfile.TemporaryDirectory() as workdir:
        model, image_dir, gt = pipeline.write_colmap_scene(
            workdir, n_views, hw=hw)
        out = {"n_views": n_views, "hw": list(hw)}
        cfg = pipeline.colmap_vp_config(os.path.join(workdir, "port"))
        t0 = time.perf_counter()
        tracks = port_runner(cfg, ReadInfos(model, image_dir),
                             points3d=ReadPointTracks(model), device="cpu")
        out["port"] = _colmap_vp_summary(tracks, cfg, gt,
                                         time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        cols = jax_read_infos(model, image_dir)
        for i in cols.get_img_ids():
            name = cols.image_name(i)
            png = name[:-len(".npy")] + ".png"
            cv2.imwrite(png, np.load(name))
            cols.change_image_name(i, png)
        cfg = pipeline.colmap_vp_config(os.path.join(workdir, "jax"))
        t0 = time.perf_counter()
        tracks = jax_runner(cfg, cols, points3d=jax_read_points(model))
        out["jax"] = _colmap_vp_summary(tracks, cfg, gt,
                                        time.perf_counter() - t0)
    print(json.dumps(out))


def pointline(n_views=100, hw=None):
    """Phase 12's path on the CPU: the port's summary, the JAX package's
    refinement and association beside it (VPs replayed)."""
    import importlib
    import limap_tpu.base.linetrack as jlt
    from limap_tpu.pointsfm import ReadInfos as jax_read_infos
    from limap_tpu.pointsfm import read_model as jax_read_model
    from limap_tpu.vplib.jlinkage import VPResult as JResult
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation as port_runner
    from limap_tpu_torch.testing import pointline as pl
    from limap_tpu_torch.util import io as limapio
    from limap_tpu_torch.vplib import get_vp_detector
    jlr = importlib.import_module("limap_tpu.optimize.line_refinement")
    jpl = importlib.import_module("limap_tpu.runners.pointline_association")
    hw = hw or (pipeline.H, pipeline.W)
    with tempfile.TemporaryDirectory() as workdir:
        model, image_dir, gt = pipeline.write_colmap_scene(
            workdir, n_views, hw=hw)
        cfg = pipeline.colmap_vp_config(os.path.join(workdir, "port"))
        t0 = time.perf_counter()
        cols = ReadInfos(model, image_dir)
        tracks = port_runner(cfg, cols, points3d=ReadPointTracks(model),
                             device="cpu")
        segs = limapio.read_all_segments_from_folder(os.path.join(
            cfg["dir_save"], "line_detections", "tpu_lsd", "segments"))
        out = {"n_views": n_views, "hw": list(hw),
               "map_s": time.perf_counter() - t0}
        model2, _, _ = pipeline.write_colmap_scene(
            os.path.join(workdir, "points"), n_views, hw=hw,
            n_line_points=4000)
        t0 = time.perf_counter()
        res, out["port"] = pl.run(tracks, cols, segs, model2, gt,
                                  os.path.join(workdir, "pl"), "cpu")
        out["port"]["total_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)

        class Replay:
            def __init__(self, res):
                self.res = res

            def detect_vp_all_images(self, s, camviews=None):
                return {i: JResult(self.res[i].labels, self.res[i].vps)
                        for i in s}

        ref_cfg, pl_cfg = pl.configs()
        jcols = jax_read_infos(model, image_dir)
        jtracks = [jlt.LineTrack.from_dict(t.as_dict()) for t in tracks]
        vpres = Replay(res["vpresults"]).detect_vp_all_images(segs)
        t0 = time.perf_counter()
        refined = jlr.line_refinement(ref_cfg, jtracks, jcols,
                                      vpresults=vpres)
        jax_out = {"refined": pl.track_summary(refined, gt),
                   "refine_s": time.perf_counter() - t0}
        # the port's detector draws its hypotheses from a generator seeded
        # anew for each detector: this repeats the port runner's VPs
        port_vps = get_vp_detector(pl_cfg["vpdet_config"], device="cpu") \
            .detect_vp_all_images(segs)
        jpl.get_vp_detector = lambda c, n_jobs=1: Replay(port_vps)
        _, _, jp2d, jp3d = jax_read_model(model2)
        t0 = time.perf_counter()
        new, pts, vps = jpl.pointline_association(
            dict(pl_cfg, output_dir=os.path.join(workdir, "jax_pl")),
            jcols, jtracks, segs, jp3d, jp2d)
        jax_out.update(associated=pl.track_summary(new, gt),
                       vps=pl.vp_summary(np.asarray(vps)),
                       association_s=time.perf_counter() - t0)
        out["jax"] = jax_out
    print(json.dumps(out))


def _colmap_vp_summary(tracks, cfg, gt, total):
    out = _exhaustive_summary(tracks, cfg, gt, total)
    matches_dir = os.path.join(
        cfg["dir_save"], "line_matchings", "tpu_lsd",
        "feats_patch_endpoints", "matches_nn_endpoints")
    out["n_matches"] = int(sum(
        len(m) for f in sorted(os.listdir(matches_dir))
        for m in np.load(os.path.join(matches_dir, f),
                         allow_pickle=True).item().values()))
    return out


def _exhaustive_summary(tracks, cfg, gt, total):
    from limap_tpu_torch.util import io as limapio
    segs = limapio.read_all_segments_from_folder(os.path.join(
        cfg["dir_save"], "line_detections", "tpu_lsd", "segments"))
    with open(os.path.join(cfg["dir_save"], "metrics.json")) as f:
        metrics = json.load(f)
    quality = bench_pipeline.quality_eval(tracks, gt)
    return {"n_tracks_all": len(tracks),
            "n_tracks_nv4": quality["n_tracks"],
            "avg_segs": float(np.mean([len(s) for s in segs.values()])),
            "total_s": total, "stages_s": metrics["stages_s"],
            "overflow_edges": metrics.get("overflow_edges"),
            "exhaustive": metrics.get("exhaustive"), "quality": quality}


def refine_sfm(n_views=100):
    """chip_smoke phase 14's path on the CPU, by the PORT
    (limap_tpu_torch/testing/refine.py: the façade with 4,000 wall points
    and their 2D observations, the poses perturbed by refine_sfm's rule,
    run_refine_sfm through the COLMAP branch).  JAX's dense S_red
    ([T, S, S, Dc, Dc], about 9 GB here) makes its full-width run
    impractical; JAX parity is held in tests/test_torch_hybrid_ba*.py."""
    from limap_tpu_torch.testing import refine
    with tempfile.TemporaryDirectory() as workdir:
        scene = refine.write_refine_scene(workdir, n_views)
        _, secs, summ = refine.run(scene, os.path.join(workdir, "out"),
                                   "cpu")
    print(json.dumps(dict(summ, n_views=n_views, seconds=secs)))


def refine_sfm_lines(n_views=16):
    """Both packages' line_triangulation on the refine_sfm façade
    (testing/refine.py) at ``n_views``, on the noisy poses (as
    run_refine_sfm calls it) and on the GT poses: the track counts.  The
    images are written as PNG for the JAX package's reader."""
    import cv2
    from limap_tpu.runners import line_triangulation as jax_triangulation
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    from limap_tpu_torch.testing import refine
    out = {"n_views": n_views}
    with tempfile.TemporaryDirectory() as workdir:
        scene = refine.write_refine_scene(workdir, n_views)
        n_nbrs = min(refine.pipeline.N_NEIGHBORS, n_views - 1)
        for poses, model in (("noisy", "model"), ("gt", "model_gt")):
            cols, _ = read_colmap_inputs(scene[model], scene["image_dir"])
            jcols = cols.as_dict()
            for i, rec in jcols["images"].items():
                png = os.path.join(workdir, f"{poses}_{i}.png")
                cv2.imwrite(png, np.load(rec["image_name"]))
                rec["image_name"] = png
            counts = {}
            for name, fn, arg in (
                    ("jax", jax_triangulation,
                     ImageCollection.from_dict(jcols)),
                    ("port", lambda c, x: line_triangulation(c, x,
                                                             device="cpu"),
                     cols)):
                cfg = refine.refine_config(
                    os.path.join(workdir, f"{poses}_{name}"), n_nbrs)
                counts[name] = len(fn(cfg, arg))
            out[poses] = counts
    print(json.dumps(out))


def main(n_views=100, n_lines=1500, n_neighbors=20):
    t0 = time.perf_counter()
    imagecols, segs, nbrs = bench.build_scene(n_views, n_lines, n_neighbors)
    tracks = map_lines(imagecols, segs, nbrs)
    t_map = time.perf_counter() - t0

    # the same GT draw as bench.build_scene, and the GT cloud chip_smoke
    # evaluates against
    gt = synthetic.build_scene(n_views, n_lines, n_neighbors,
                               device="cpu")[3]
    cloud = synthetic.gt_point_cloud(gt, 500)
    lines = np.stack([tr.line for tr in tracks]).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 1000, dtype=np.float32)
    samples = lines[:, None, 0] + ts[None, :, None] * (
        lines[:, None, 1] - lines[:, None, 0])
    d, _ = cKDTree(cloud).query(samples.reshape(-1, 3), workers=2)
    d = d.reshape(len(lines), -1)
    lengths = np.linalg.norm(lines[:, 1] - lines[:, 0], axis=1)
    out = {"n_tracks": len(tracks), "map_s": t_map,
           "gt_length": float(np.linalg.norm(gt[:, 1] - gt[:, 0],
                                             axis=1).sum())}
    for tau in TAUS:
        ratios = (d <= tau).mean(1)
        out[f"recall_{tau}"] = float((ratios * lengths).sum())
        out[f"precision_{tau}"] = float((ratios > 0).mean() * 100.0)
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--from-pixels"]:
        from_pixels(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--runner"]:
        runner(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--localize"]:
        localize(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--fitnmerge"]:
        fitnmerge(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--exhaustive"]:
        exhaustive(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--colmap-vp"]:
        colmap_vp(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--pointline"]:
        pointline(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--refine-sfm"]:
        refine_sfm(*map(int, sys.argv[2:3]))
    elif sys.argv[1:2] == ["--refine-sfm-lines"]:
        refine_sfm_lines(*map(int, sys.argv[2:3]))
    else:
        main()
