"""Smoke run of the PyTorch/CUDA port (limap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels from limap_tpu_torch/csrc (nvcc, sm_90a);
  2. hold the tensor-core kernel's raw filter values to a matrix product
     (this pins the mma fragment layout), then each kernel to its plain
     torch version on the card, at ragged sizes and at the main path's
     shapes;
  3. run the slice on the card and on the CPU on a reduced scene and
     require the same tracks and supports, and every line within
     tolerance (or off only through a near-tied proposal); then hold the
     kernels to the plain version on three inputs built against the
     filter from that scene's queries and cloud;
  4. the main path at full width: the protocol scene (100 views x 1500
     lines x 20 neighbours), triangulate -> tracks -> filters + remerge
     -> line BA (the lm_line_ba kernel), then GT evaluation, with quality
     gates;
  5. hold each kernel to its plain version on that path's whole
     evaluation input and time it beside its bound, the plain version
     and one PyTorch library call computing the same function; the
     tensor-core kernel and the CUDA-core yardstick in turns;
  6. the front end and the runner, card against CPU, on a reduced
     rendered scene (6 views of 240x320): line_triangulation from .npy
     images on both devices, detections as sets within a pixel
     tolerance, descriptors and match lists on the same segments;
  7. the pipeline from pixels at full width: 100 rendered views of
     800x600, tpu_lsd -> patch-endpoint descriptors -> batched neighbour
     matcher -> triangulate -> tracks -> filters -> BA, once through the
     runner (line_triangulation from .npy images, with its file caches)
     and twice through the timed stages of
     limap_tpu_torch/testing/pipeline.py, with quality gates; then GT
     evaluation of the tracks through nn_min_dist, and phase 5's checks
     and timings of both kernels on that evaluation's input;
  8. localization at full width on phase 7's runner map: 10 queries
     rendered between the database views, each with a prior, 10 retrieved
     views and 1000 point matches, through hybrid_localization (tpu_lsd,
     epipolar-IoU grid, reprojection filter, PnPL RANSAC with the
     pose_score and trace_roots kernels, LO on the lm_jointloc kernel, f64
     polish), with quality gates; then the four localization kernels held
     to their plain versions and timed on that path's own inputs.
  9. fit and merge at full width on phase 7's images, each with the
     analytic depth of the wall: line_fitnmerge (tpu_lsd, one batched
     RANSAC over every segment with the line_ransac kernel, the linker's
     edge test with the linker_edges kernel, connected components,
     reprojection filter and remerge), with quality gates; then both
     kernels held to their plain versions and timed on that path's
     whole inputs.
 10. the exhaustive matcher at full width on phase 7's images:
     line_triangulation with use_exhaustive_matcher (tpu_lsd, no
     descriptors, no matcher; kernel F enumerates every line against every
     line of the 10 neighbours and keeps the survivors of its culls,
     kernel G scores them), with quality gates from the port's own CPU
     run; then GT evaluation through nn_min_dist, and F and G held to
     their plain versions and timed on that path's whole input.
 11. the COLMAP entry point with VP triangulation at full width: the
     façade variant of phase 7's scene (100 views of 800x600, its lines
     horizontal or vertical) written as a COLMAP text model with wall
     points, read back (ReadInfos, ReadPointTracks), then
     line_triangulation with use_vp: neighbours and ranges from the
     point model, VP detection of every image in one launch of kernel J,
     kernels F and G with the two VP banks, with quality gates from the
     port's own CPU run; then J, F and G held to their plain versions and
     timed on that path's whole input.  Phase 11a, before it, runs that
     path on the card and on the CPU on a reduced façade (8 views, the
     same segments and matches) and requires the same VP labels, the
     same VPs, tracks and supports.
Phase 2 also holds the triangulator's kernels (tri_propose, F, in both
input forms and with the VP banks, and tri_score, G) and the VP
detector (vp_detect, J) to their plain versions on seeded inputs;
phases 4 and 7 hold F and G to them on their paths' whole inputs; phase
10a, before phase 10, runs the exhaustive runner on the card and on the
CPU on a reduced rendered scene (the same segments) and requires the same
tracks and supports.
Phase 2 also holds the localization kernels (trace_roots, pose_score,
epipolar_iou_grid), the fit-and-merge kernels (line_ransac,
linker_edges) and the LM kernels (lm_line_ba, H; lm_jointloc, I, under
every cost function, weight and loss) to their plain versions on seeded
inputs; phases 4, 7 and 10 hold H to its plain version on their paths'
whole BA input and phase 8 holds I to it on every LO solve of its
queries, each row by row (testing/lm_checks.py); phase 3b, after
phase 3, runs the PnPL estimator on the card and on the CPU on one
problem (the same hypotheses scored alike, and the same final pose), and
phase 9a, before phase 9, runs line_fitnmerge on the card and on the CPU
on a reduced scene with depth: the same fitted segments, tracks and
lines.

Prints the kernels' JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.
"""

import copy
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores (a fused
# multiply-add counts as two, so half of it for a compare or a min), TF32
# on the tensor cores (dense), HBM3 rate
FP32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_BYTES_PER_S = 3.35e12

# The JAX package's own CPU run of the phase-4 scene and evaluation,
# printed by tests/torch_port_reference_gates.py: n_tracks, recall (m of
# the 2411.91 m of GT) and precision (%) at tau.  The gates allow 1 % of
# the tracks, 1 % of the recall and 1 point of precision.
REFERENCE = {"n_tracks": 1462,
             "recall": {0.01: 2345.6145807653666, 0.05: 2345.6145807653666,
                        0.1: 2345.6145807653666},
             "precision": {0.01: 100.0, 0.05: 100.0, 0.1: 100.0}}
TAUS = (0.01, 0.05, 0.1)

# The JAX package's CPU run of the phase-7 scene from the same pixels
# (tests/torch_port_reference_gates.py --from-pixels 100): tracks of any
# size, tracks of >= 4 images, and quality_eval at tau = 0.05.
REFERENCE_FROM_PIXELS = {
    "n_tracks_all": 700, "avg_segs": 491.04, "n_matches": 982080,
    "n_tracks": 345, "recall_0.05": 206.40776633700602,
    "precision_0.05": 91.30434782608695,
    "gt_coverage_0.05": 49.19480726223659}
# The JAX package's runner on the same scene, its images as PNG, with
# the config of testing/pipeline.py::runner_config
# (tests/torch_port_reference_gates.py --runner 100).
REFERENCE_RUNNER = {
    "n_tracks_all": 361, "avg_segs": 491.04, "n_matches": 982080,
    "n_tracks": 288, "recall_0.05": 211.2249182962567,
    "precision_0.05": 95.13888888888889,
    "gt_coverage_0.05": 66.9934549727526}
# (name, "relative" share or "points", slack), for both.  The card repeats its
# result from run to run (the detector adds its moments in pixel order),
# so a pass does not scatter round the reference: it is one more
# rounding of the same computation.  Track-level quality is chaotic in
# the last digits (a filter or score threshold falls either way and the
# tracks regroup): against the JAX run, the port's CPU run and the
# card's run differ by up to 0.6 % of the tracks, 3.2 % of the tracks of
# >= 4 images, 1.8 % of the recall, 0.5 points of coverage and 0.9
# points of precision; detection and matching by 0.002 %; the card's
# runner pass from its reference by 0.3 %, 2.1 %, 2.2 %, 0.9 and 0.1.  With atomic
# scatters the card's runs had spread by 2.3 points; the gates allow
# about that.
FROM_PIXELS_GATES = (
    ("avg_segs", "relative", 0.002), ("n_matches", "relative", 0.002),
    ("n_tracks_all", "relative", 0.02), ("n_tracks", "relative", 0.05),
    ("recall_0.05", "relative", 0.03),
    ("gt_coverage_0.05", "points", 2.5),
    ("precision_0.05", "points", 2.5))
# Card against CPU on the front end.  Both add a component's moments in
# pixel order, but the gradient field rounds differently on the card,
# and the variance of a stroke is a small difference of large fp32 sums:
# a matched segment's endpoints may move by SEG_TOL px, and a component whose width, density
# or length sits on its threshold may pass on one device only.  Measured
# on an H100: 0.0012 px at 240x320 and 0.0112 px at 800x600, none of 492
# unmatched; descriptors 1.6e-7.
SEG_TOL = 0.05
SEG_UNMATCHED_SHARE = 0.02
DESC_TOL = 1e-5
# matches differ only through scores within rounding of min_score or of
# each other (a top-k tie)
MATCH_DIFF_SHARE = 0.005


# The JAX package's CPU run of phase 8's queries through its own runner
# and its own map (tests/torch_port_reference_gates.py --localize 10):
# per query (image id 1000 + k) the centre error (m) and the rotation
# error (deg).  The queries are independent, so the first
# LOCALIZE_QUERIES of them are the reference of a shorter run.  Gates:
# the count of queries under 5 cm / 0.5 deg no lower than the
# reference's by more than 1, the median centre error no worse than
# 1.5 x the reference's + 2 mm, and the median rotation error no worse
# than 1.5 x the reference's + 0.05 deg (a rotation error below ~0.03
# deg reads as 0 or 0.028 from the f32 rotation matrices).
LOCALIZE_QUERIES = 10
REFERENCE_LOCALIZE_ERRORS = [
    (0.0032780762380787897, 0.0), (0.0012084405311309208, 0.0),
    (0.010124502065227081, 0.04845663905143738),
    (0.00533046483449346, 0.02797645330429077),
    (0.002313288774542853, 0.0), (0.00490200483509201, 0.0),
    (0.004325303139943111, 0.03956468030810356),
    (0.0011226444781994402, 0.0),
    (0.006061203991863717, 0.02797645330429077),
    (0.0006540772026187505, 0.0)]
# The JAX package's CPU run of line_fitnmerge on phase 7's 100 images,
# each with the analytic depth of the wall, cfgs/fitnmerge/default.yaml
# and the scene's 10 neighbours (tests/torch_port_reference_gates.py
# --fitnmerge 100): tracks of any size, of >= 4 images, segments an
# image, fitted segments and quality_eval at tau = 0.05 (its runner took
# 899.8 s on the CPU, 818.9 s of it fit_3d_segs).
REFERENCE_FITNMERGE = {
    "n_tracks_all": 338, "n_tracks": 223, "avg_segs": 491.04,
    "n_fitted": 49104, "recall_0.05": 294.8346017004919,
    "precision_0.05": 100.0, "gt_coverage_0.05": 91.21050249543315}
# the phase-7 tolerances, the fitted segments held as the detections
FITNMERGE_GATES = (
    ("avg_segs", "relative", 0.002), ("n_fitted", "relative", 0.002),
    ("n_tracks_all", "relative", 0.02),
    ("n_tracks", "relative", 0.05), ("recall_0.05", "relative", 0.03),
    ("gt_coverage_0.05", "points", 2.5), ("precision_0.05", "points", 2.5))
# The PORT's runner with the exhaustive matcher on the CPU, with the
# plain versions of F and G, on phase 7's images as .npy
# (tests/torch_port_reference_gates.py --exhaustive 100).  The JAX
# package gives no reference here: its exhaustive path keeps each line's
# first 64 raw candidates before any cull, drops 240,295,632 of them and
# makes 0 tracks of these images (the same run; the port's took 952.8 s,
# 842.4 s of it the plain F and G).
REFERENCE_EXHAUSTIVE = {
    "n_tracks_all": 609, "n_tracks": 424, "avg_segs": 491.05,
    "recall_0.05": 284.63913875541346, "precision_0.05": 89.38679245283019,
    "gt_coverage_0.05": 77.91622021388247}
# the phase-7 tolerances, without the matches
EXHAUSTIVE_GATES = tuple(g for g in FROM_PIXELS_GATES if g[0] != "n_matches")
# The PORT's runner on the CPU with the plain versions of its kernels on
# the façade's COLMAP model (tests/torch_port_reference_gates.py
# --colmap-vp 100; 192.9-399.1 s on the CPU): the JAX package's VP bank
# of the neighbour line turns that line's VP into a direction with the
# other view (ROADMAP.md section 3), so its run is a figure beside this
# one, not the reference: 277 tracks, 198 of >= 4 images, 491.33 segments an
# image, 982,660 matches, recall 164.05 m, precision 89.90 %, coverage
# 59.99 % at 5 cm.  Gates: the phase-7 tolerances.
REFERENCE_COLMAP_VP = {
    "n_tracks_all": 281, "n_tracks": 208, "avg_segs": 491.4,
    "n_matches": 982800, "recall_0.05": 167.1927736518379,
    "precision_0.05": 87.98076923076923,
    "gt_coverage_0.05": 61.16026379159752}
# Card against CPU on fit and merge (phase 9a): fitted endpoints within
# 0.1 mm (lines 10 m away; the TLS axis of the card's batched eigensolver
# rounds otherwise), track lines within 1 mm.
FIT_TOL_M = 1e-4
FNM_LINE_TOL_M = 1e-3

# Card against CPU on one PnPL problem (phase 3b): the same hypotheses
# scored alike (rtol 1e-5; an order may differ only among scores within
# 1e-5 of each other) and final poses within 1 mm and 0.01 deg.
LOC_SCORE_RTOL = 1e-5
LOC_POSE_TOL_M = 1e-3
LOC_POSE_TOL_DEG = 0.01


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=True):
    """Mean ms of ``fn`` over ``reps`` runs, after one warm-up run."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_slice(device, n_views, n_lines, n_neighbors, noise=0.0,
              points_per_segment=500, n_samples=1000):
    """The port's slice from given segments through its entry points;
    returns (tracks, report, per-stage seconds, number of queries and
    cloud of the evaluation)."""
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.testing.synthetic import (build_scene,
                                                   gt_point_cloud)
    from limap_tpu_torch.util.profiler import StageProfiler

    imagecols, segs, nbrs, gt = build_scene(n_views, n_lines, n_neighbors,
                                            device=device)
    if noise:
        rng = np.random.default_rng(1)
        segs = {k: (v + rng.normal(0, noise, v.shape)).astype(np.float32)
                for k, v in segs.items()}
    prof = StageProfiler(device=device)
    tracks = pipeline.map_lines(imagecols, segs, nbrs, device, prof)
    with prof.stage("evaluate"):
        cloud = gt_point_cloud(gt, points_per_segment)
        evaluator = PointCloudEvaluator(cloud, device=device)
        lines = np.stack([x.line for x in tracks])
        report = report_error_to_gt(evaluator, lines, TAUS, n_samples)
    return (tracks, report, dict(prof.times), len(lines) * n_samples,
            evaluator.points)


def evaluation_queries(tracks, n_samples):
    """The evaluator's queries [n_tracks * n_samples, 3] on the card."""
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.evaluation.evaluator import \
        sample_points_on_segments
    lines = torch.as_tensor(np.stack([x.line for x in tracks]),
                            dtype=torch.float32, device="cuda")
    return sample_points_on_segments(Segments(lines[:, 0], lines[:, 1]),
                                     n_samples).reshape(-1, 3).contiguous()


def max_err_to_plain(kernel, queries, cloud):
    from limap_tpu_torch.ops.nn_distance import nn_min_dist_plain
    err = (kernel(queries, cloud) - nn_min_dist_plain(queries, cloud)).abs()
    torch.cuda.synchronize()
    return err.max().item()


TURNS = ("nn_min_dist_scalar", "nn_min_dist", "nn_min_dist",
         "nn_min_dist_scalar")


def measure_kernels(kernels, path, queries, cloud, launches):
    """One path's entries of the kernels line: every kernel held to the
    plain version on the WHOLE evaluation input of that path (all fp32
    difference form, only the rounding order differs: 1e-5), the two
    kernels bit-equal, their times in turns on this one card, the plain
    version's and a library call's time (one run each), and the bound."""
    from limap_tpu_torch.ops import nn_distance as nnd
    S, M = queries.shape[0], cloud.shape[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = nnd.nn_min_dist_plain(queries, cloud)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    out = {name: kernel(queries, cloud) for name, kernel in kernels.items()}
    confirms_per_query = int(nnd.nn_min_dist.confirms) / S
    max_err = {name: (d - plain).abs().max().item()
               for name, d in out.items()}
    for name, err in max_err.items():
        check(err <= 1e-5, (name, "vs plain", path, S, M, err))
    check(torch.equal(out["nn_min_dist"], out["nn_min_dist_scalar"]),
          f"the two kernels differ on the {path} path's input")
    del plain, out

    def library():
        step = 1024
        return torch.cat([torch.cdist(queries[i:i + step], cloud).amin(1)
                          for i in range(0, S, step)])

    times = {name: [] for name in kernels}
    for name in TURNS:
        times[name].append(cuda_ms(lambda: kernels[name](queries, cloud), 3))
    library_ms = cuda_ms(library, 1, warmup=False)
    # the least time of any implementation: per pair 16 TF32 operations
    # (one k=8 product) on the tensor cores or one fp32 compare on the
    # CUDA cores, or the bytes; beside it the bound of the CUDA-core
    # route (8 fp32 operations a pair)
    seconds = {"operations": max(S * M * 16 / TF32_PEAK,
                                 S * M / (FP32_PEAK / 2)),
               "bytes": (S * 12 + M * 12 + S * 4) / HBM_BYTES_PER_S}
    bound_by = max(seconds, key=seconds.get)
    log(f"[kernel] {path}: {S} queries x {M} points, both kernels == plain "
        f"on the whole input (max abs err {json.dumps(max_err)}), bit-equal "
        f"to each other; ms in turns {list(TURNS)}: {json.dumps(times)}; "
        f"plain {plain_ms:.1f} ms, library {library_ms:.1f} ms")
    entries = [{
        "name": name, "path": path, "route": "cuda",
        "source": "limap_tpu_torch/csrc/nn_min_dist.cu",
        "replaces": "limap_tpu/ops/pallas/nn_distance.py:55",
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": sum(times[name]) / len(times[name]), "ms_turns": times[name],
        "plain_ms": plain_ms, "bound_ms": seconds[bound_by] * 1e3,
        "bound_by": bound_by,
        "cuda_core_bound_ms": S * M * 8 / FP32_PEAK * 1e3,
        "library_ms": library_ms, "queries": S, "points": M,
        "on_main_path": name == "nn_min_dist"} for name in kernels]
    entries[0]["confirms_per_query"] = confirms_per_query
    return entries


def key(track):
    return tuple(sorted(zip(track.image_id_list, track.line_id_list)))


def endpoint_error(a, b):
    """Max abs endpoint difference of two segments [2, 3], either way
    round (the TLS axis is fixed only up to sign)."""
    return min(np.abs(a - b).max(), np.abs(a[::-1] - b).max())


def by_support(track):
    """(best-tri segments, best scores) of a track's supports, in key
    order."""
    order = sorted(range(track.count_lines()), key=lambda s: (
        track.image_id_list[s], track.line_id_list[s]))
    return ([track.line3d_list[s] for s in order],
            np.array([track.score_list[s] for s in order]))


# Card against CPU.  LM accept tests flip under rounding once the cost is
# flat: 1 cm at ~12 m depth, as the CPU parity tests.
LINE_TOL = 1e-2
# A support whose best-tri segments differ by more than SUPPORT_TOL on the
# two devices took another proposal.  That is a near-tie, which either
# device's rounding of exp/arccos may break, only if its best score agrees
# within TIE_EPS (rounding of the scores themselves reaches ~2.5e-4).
SUPPORT_TOL = 1e-3
TIE_EPS = 1e-3
# Two proposals of one 2D line, triangulated with two neighbours from
# 0.3 px noisy endpoints, lie within a few cm of each other at ~12 m.
TIE_LINE_TOL = 5e-2


def hold_card_to_cpu(gpu_tracks, cpu_tracks):
    """Every card track's line within LINE_TOL of the CPU's, or, for at
    most 1 % of the tracks, out of it only through supports whose best
    proposal is a near-tie.  Returns (max error of the held tracks,
    (line error, best-score gap) of each tied track)."""
    cpu = {key(x): x for x in cpu_tracks}
    held, tied = [], []
    for x in gpu_tracks:
        y = cpu[key(x)]
        err = endpoint_error(x.line, y.line)
        if err <= LINE_TOL:
            held.append(err)
            continue
        check(err <= TIE_LINE_TOL, ("card-vs-CPU line error", key(x), err))
        (seg_g, score_g), (seg_c, score_c) = by_support(x), by_support(y)
        moved = [s for s in range(len(seg_g))
                 if endpoint_error(seg_g[s], seg_c[s]) > SUPPORT_TOL]
        check(moved, ("line off without a moved support", key(x), err))
        gaps = np.abs(score_g[moved] - score_c[moved])
        check(gaps.max() <= TIE_EPS,
              ("moved support without a near-tie", key(x), err, gaps))
        tied.append((float(err), float(gaps.max())))
    check(len(tied) <= 0.01 * len(gpu_tracks), ("near-tied tracks", tied))
    return max(held), tied


def nearest_offsets(a, b):
    """For each row of a [N, >=4], the offset to the nearest row of b
    (max abs over the four endpoint coordinates; inf when b is empty)."""
    if not len(a) or not len(b):
        return np.full(len(a), np.inf)
    return np.abs(a[:, None, :4] - b[None, :, :4]).max(-1).min(1)


def match_pairs(matches):
    return {(a, b, int(i), int(j)) for a, by_nbr in matches.items()
            for b, m in by_nbr.items() for i, j in np.asarray(m)}


def front_end_card_vs_cpu(workdir):
    """Phase 6: the runner from .npy images on the card and on the CPU,
    then descriptors and matches of both devices on the CPU's segments."""
    from limap_tpu_torch.line2d.endpoints import (
        compute_descinfos_batch, match_all_neighbors_batched)
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util import io as limapio
    from limap_tpu_torch.util.config import default_triangulation_config

    imagecols, imgs, nbrs, gt = pipeline.build_scene(
        n_views=6, n_lines=30, hw=(240, 320), n_neighbors=4,
        image_dir=os.path.join(workdir, "images"))
    cfg = default_triangulation_config()
    cfg.update(n_neighbors=4, n_visible_views=3)
    cfg["triangulation"]["fullscore_th"] = 0.5
    cfg["triangulation"]["filtering2d"].update(th_sv_num_supports=2,
                                               th_overlap_num_supports=2)
    cfg["refinement"]["min_num_images"] = 3
    tracks, segs = {}, {}
    for dev in ("cuda", "cpu"):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["output_dir"] = os.path.join(workdir, dev)
        tracks[dev] = line_triangulation(run_cfg, imagecols, nbrs,
                                         device=dev)
        segs[dev] = limapio.read_all_segments_from_folder(os.path.join(
            workdir, dev, "line_detections", "tpu_lsd", "segments"))
        for name in ("imagecols.npy", "metainfos.txt", "alltracks.txt",
                     "metrics.json", "triangulated_lines_nv3.obj",
                     os.path.join("finaltracks", "config.npy")):
            check(os.path.isfile(os.path.join(workdir, dev, name)),
                  (dev, "runner did not write", name))
    n_cpu = sum(len(v) for v in segs["cpu"].values())
    n_gpu = sum(len(v) for v in segs["cuda"].values())
    to_card = np.concatenate([nearest_offsets(segs["cpu"][i], segs["cuda"][i])
                              for i in sorted(segs["cpu"])])
    to_cpu = np.concatenate([nearest_offsets(segs["cuda"][i], segs["cpu"][i])
                             for i in sorted(segs["cpu"])])
    lost, extra = int((to_card > SEG_TOL).sum()), int((to_cpu > SEG_TOL).sum())
    worst = to_card[to_card <= SEG_TOL].max(initial=0.0)
    log(f"[front-end card-vs-cpu] segments {n_gpu} on the card, {n_cpu} on "
        f"the CPU; unmatched within {SEG_TOL} px: {lost} of the CPU's, "
        f"{extra} of the card's; largest matched offset {worst:.4f} px")
    check(n_cpu > 100, ("too few segments", n_cpu))
    check(max(lost, extra) <= SEG_UNMATCHED_SHARE * n_cpu,
          ("card and CPU detections differ", lost, extra, n_cpu))

    same = {i: segs["cpu"][i] for i in imgs}
    desc = {dev: compute_descinfos_batch(imgs, same, device=dev)
            for dev in ("cuda", "cpu")}
    desc_err = max(np.abs(desc["cuda"][i]["endpoints_desc"]
                          - desc["cpu"][i]["endpoints_desc"]).max()
                   for i in imgs)
    check(desc_err <= DESC_TOL, ("descriptors card vs CPU", desc_err))
    pairs = {dev: match_pairs(match_all_neighbors_batched(
        imgs, same, nbrs, topk=2, min_score=0.5, device=dev))
        for dev in ("cuda", "cpu")}
    differ = len(pairs["cuda"] ^ pairs["cpu"])
    log(f"[front-end card-vs-cpu] descriptors max abs err {desc_err:.2e} "
        f"(<= {DESC_TOL}); matches {len(pairs['cuda'])} on the card, "
        f"{len(pairs['cpu'])} on the CPU, {differ} differ")
    check(len(pairs["cpu"]) > 100, "too few matches")
    check(differ <= MATCH_DIFF_SHARE * len(pairs["cpu"]) + 2,
          ("card and CPU match lists differ", differ))
    n = {dev: (len(t), sum(x.count_images() >= 3 for x in t))
         for dev, t in tracks.items()}
    log(f"[front-end card-vs-cpu] runner tracks (all, >= 3 images): "
        f"card {n['cuda']}, CPU {n['cpu']}")
    check(n["cpu"][0] > 0 and abs(n["cuda"][0] - n["cpu"][0])
          <= max(2, 0.1 * n["cpu"][0]), ("runner track counts", n))


def runner_full_width(scene, workdir, card):
    """The runner at full width: line_triangulation from the scene's
    .npy images with the default config and the protocol's settings, its
    caches and results written under ``workdir``.  Returns its measures
    for the gates."""
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util import io as limapio

    imagecols, _, nbrs, gt = scene
    cfg = pipeline.runner_config(workdir, n_neighbors=len(nbrs[0]))
    t0 = time.perf_counter()
    tracks = line_triangulation(cfg, imagecols, nbrs, device="cuda")
    wall = time.perf_counter() - t0
    for name in ("imagecols.npy", "metainfos.txt", "alltracks.txt",
                 "metrics.json", "triangulated_lines_nv4.obj",
                 os.path.join("finaltracks", "config.npy")):
        check(os.path.isfile(os.path.join(workdir, name)),
              ("runner did not write", name))
    with open(os.path.join(workdir, "metrics.json")) as f:
        stages = json.load(f)["stages_s"]
    segs = limapio.read_all_segments_from_folder(os.path.join(
        workdir, "line_detections", "tpu_lsd", "segments"))
    matches_dir = os.path.join(workdir, "line_matchings", "tpu_lsd",
                               "feats_patch_endpoints",
                               "matches_nn_endpoints")
    n_matches = sum(len(m) for i in nbrs for m in np.load(
        os.path.join(matches_dir, f"matches_{i}.npy"),
        allow_pickle=True).item().values())
    n_files = sum(len(files) for _, _, files in os.walk(workdir))
    quality = pipeline.quality_eval(tracks, gt)
    log(f"[runner] line_triangulation, {len(nbrs)} views from .npy images, "
        f"{wall:.3f} s in all, {n_files} files under its folder; stage "
        f"seconds {json.dumps(stages)} on {card}")
    log(f"[runner] {n_matches} matches (descriptors at full resolution); "
        f"{len(tracks)} tracks; quality_eval {json.dumps(quality)}")
    check(np.isfinite([x.line for x in tracks]).all(),
          "non-finite lines from the runner")
    return dict(quality, n_tracks_all=len(tracks), n_matches=n_matches,
                avg_segs=float(np.mean([len(v) for v in segs.values()]))), \
        tracks


def hold_to_gates(what, measured, ref, gates=FROM_PIXELS_GATES):
    for name, unit, slack in gates:
        got = measured[name]
        margin = slack if unit == "points" else ref[name] * slack
        log(f"[{what}] gate {name}: {got:.4f} against the reference's "
            f"{ref[name]:.4f} ({unit} {slack})")
        check(abs(got - ref[name]) <= margin,
              (what, "gate", name, got, ref[name]))


def from_pixels_full_width(card, workdir):
    """Phase 7: the runner once, then two passes of the timed pipeline
    (the first warms the allocator and the libraries), each held to the
    gates, then GT evaluation of the second pass's tracks.  The scene's
    images and the runner's files go under ``workdir``.  Returns the
    evaluation's queries and cloud on the card, the scene and the
    runner's tracks (phase 8's map)."""
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    from limap_tpu_torch.line2d.tpu_lsd import detect_segments
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.testing.synthetic import gt_point_cloud

    t0 = time.perf_counter()
    scene = pipeline.build_scene(image_dir=os.path.join(workdir, "images"))
    log(f"[from-pixels] scene rendered on the host in "
        f"{time.perf_counter() - t0:.1f} s: {len(scene[1])} views of "
        f"{scene[1][0].shape[1]}x{scene[1][0].shape[0]}, "
        f"{len(scene[3])} GT lines, {len(scene[2][0])} neighbours")
    on_card = detect_segments(scene[1][0], max_segs=3000)
    on_cpu = detect_segments(scene[1][0], max_segs=3000, device="cpu")
    to_card = nearest_offsets(on_cpu, on_card)
    lost = int((to_card > SEG_TOL).sum())
    extra = int((nearest_offsets(on_card, on_cpu) > SEG_TOL).sum())
    log(f"[from-pixels] view 0 at full size, card against CPU: "
        f"{len(on_card)} and {len(on_cpu)} segments, {lost} and {extra} "
        f"unmatched within {SEG_TOL} px, largest matched offset "
        f"{to_card[to_card <= SEG_TOL].max(initial=0.0):.4f} px")
    check(max(lost, extra) <= SEG_UNMATCHED_SHARE * len(on_cpu),
          ("full-size detections differ", lost, extra, len(on_cpu)))
    measured, runner_tracks = runner_full_width(
        scene, os.path.join(workdir, "runner"), card)
    hold_to_gates("runner", measured, REFERENCE_RUNNER)

    passes = []
    for what in ("first pass", "second pass"):
        torch.cuda.reset_peak_memory_stats()
        r = pipeline.run(scene=scene, device="cuda")
        r["n_matches"] = sum(len(m) for v in r["matches"].values()
                             for m in v.values())
        log(f"[from-pixels] {what} stage seconds "
            f"{json.dumps(r['stages_s'])} "
            f"(sum {sum(r['stages_s'].values()):.3f}) on {card}")
        log(f"[from-pixels] {what}: avg segments per image "
            f"{r['avg_segs']:.2f}; {r['n_matches']} matches; "
            f"{r['n_tracks']} tracks; quality_eval "
            f"{json.dumps(r['quality'])}")
        hold_to_gates(what, dict(
            r["quality"], n_tracks_all=r["n_tracks"],
            avg_segs=r["avg_segs"], n_matches=r["n_matches"]),
            REFERENCE_FROM_PIXELS)
        check(np.isfinite([x.line for x in r["linetracks"]]).all(),
              "non-finite lines from pixels")
        passes.append(r)
    first, second = passes[0]["segs"], passes[1]["segs"]
    same = all(np.array_equal(first[i], second[i]) for i in first)
    log(f"[from-pixels] the two passes: segments bit-equal {same}; tracks "
        f"{passes[0]['n_tracks']} and {passes[1]['n_tracks']}; quality "
        f"equal {passes[0]['quality'] == passes[1]['quality']}")
    check(same, "the detector did not repeat its segments on the card")

    t0 = time.perf_counter()
    evaluator = PointCloudEvaluator(gt_point_cloud(
        scene[3].astype(np.float32), 500), device="cuda")
    lines = np.stack([x.line for x in r["linetracks"]])
    rep = report_error_to_gt(evaluator, lines, TAUS, 1000)
    torch.cuda.synchronize()
    log(f"[from-pixels] evaluation against the GT cloud "
        f"({len(lines) * 1000} queries x {evaluator.points.shape[0]} "
        f"points) in {time.perf_counter() - t0:.3f} s: recall "
        f"{rep['recall']}; precision {rep['precision']}; peak device "
        f"memory of the pass {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")
    check(all(np.isfinite(rep["recall"][tau]) for tau in TAUS)
          and 0 < rep["recall"][0.01] <= rep["recall"][0.1],
          ("GT evaluation of the from-pixels tracks", rep))
    return (evaluation_queries(r["linetracks"], 1000), evaluator.points,
            scene, runner_tracks)


# FP32 operations per unit of work of the localization kernels, counted
# from their formulas (a multiply-add as two, a sqrt, divide, sin, cos or
# atan2 as one): pose_score a point 47 and a line 124 per pose; the root
# function G 280 per evaluation, (n_grid + 1) + 3 n_roots n_bisect +
# 3 n_roots evaluations per instance; the IoU 46 per pair.
OPS_POINT, OPS_LINE, OPS_G, OPS_PAIR = 47, 124, 280, 46


def bound(ops, nbytes):
    seconds = {"operations": ops / FP32_PEAK, "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(seconds, key=seconds.get)
    return seconds[by] * 1e3, by


def pose_difference(a, b):
    """(distance between the camera centres in m, angle between the
    rotations in deg) of two poses, in f64 from their quaternions: a
    rotation matrix rounded to f32 reads any angle under ~0.03 deg as 0
    or 0.028."""
    from scipy.spatial.transform import Rotation
    ra, rb = (Rotation.from_quat(np.roll(p.qvec, -1)) for p in (a, b))
    centre = [-r.inv().apply(p.tvec) for r, p in ((ra, a), (rb, b))]
    return (float(np.linalg.norm(centre[0] - centre[1])),
            float(np.degrees((ra.inv() * rb).magnitude())))


def localization_card_vs_cpu():
    """Phase 3b: the PnPL estimator on one problem (40 points, 20 lines,
    30 % outliers, H = 256) on the card and on the CPU.  The card's
    hypotheses scored by the kernel on the card and by the plain version
    on the CPU; then both devices' whole estimate."""
    from limap_tpu_torch.base.pose import rotmat_to_quat
    from limap_tpu_torch.estimators.absolute_pose import (
        minimal_hypotheses, pl_estimate_absolute_pose)
    from limap_tpu_torch.ops.pose_score import ScoreParams, pose_score
    from limap_tpu_torch.testing.localization import synthetic_problem
    from limap_tpu_torch.util.evaluation import compute_pose_err

    cam, pose_gt, p3, p2, l3, l3_ids, l2 = synthetic_problem(
        np.random.default_rng(21))
    cfg = {"ransac": {"method": "hybrid", "thres_point": 5.0,
                      "thres_line": 5.0, "n_hypotheses": 256},
           "optimize": {"loss": "huber", "loss_scale": 2.0}}
    params = ScoreParams.from_thresholds(5.0, 5.0)

    def data(device):
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                      device=device).contiguous()
        return (t(cam.kvec()), t(p3), t(p2), t(l3[:, 0]), t(l3[:, 1]),
                t(l2[:, 0]), t(l2[:, 1]))

    hyp = {}
    for dev in ("cuda", "cpu"):
        kv, p3d, p2d, l3s, l3e, l2s, l2e = data(dev)
        hyp[dev] = minimal_hypotheses(kv, p3d, p2d, l3, l2s, l2e, 256, 0)
    Rs, ts, ok = hyp["cuda"]
    q = rotmat_to_quat(Rs).contiguous()
    scores = {}
    for dev in ("cuda", "cpu"):
        kv, p3d, p2d, l3s, l3e, l2s, l2e = data(dev)
        s_ = pose_score(q.to(dev), ts.to(dev).contiguous(), kv, p3d, p2d,
                        l3s, l3e, l2s, l2e, params)[0]
        scores[dev] = torch.where(ok.to(dev), s_,
                                  torch.full_like(s_, float("inf"))).cpu()
    sc, sp = scores["cuda"].numpy(), scores["cpu"].numpy()
    fin = np.isfinite(sp)
    check(np.array_equal(np.isfinite(sc), fin), "finite scores differ")
    rel = np.abs(sc[fin] - sp[fin]) / np.abs(sp[fin])
    check(rel.max() <= LOC_SCORE_RTOL, ("scores card vs CPU", rel.max()))
    oc = np.argsort(sc, kind="stable")
    op = np.argsort(sp, kind="stable")
    swapped = oc != op
    gaps = np.abs(sp[oc[swapped]] - sp[op[swapped]])
    check((gaps <= LOC_SCORE_RTOL * np.abs(sp[op[swapped]])).all(),
          ("score orders differ", gaps.max(initial=0.0)))
    diff = (hyp["cuda"][0].cpu() - hyp["cpu"][0]).abs().amax((1, 2))
    both = ok.cpu() & hyp["cpu"][2]
    log(f"[loc card-vs-cpu] {len(sc)} hypotheses from the same samples, "
        f"{int(both.sum())} valid on both; the card's scored on both "
        f"devices: max rel err {rel.max():.2e}, {int(swapped.sum())} order "
        f"swaps among near-ties; minimal solvers card vs CPU: "
        f"{int((diff[both] > 1e-3).sum())} hypotheses beyond 1e-3")

    poses, stats = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        poses[dev], stats[dev] = pl_estimate_absolute_pose(
            cfg, l3, l3_ids, l2, p3, p2, cam, device=dev)
        log(f"[loc card-vs-cpu] {dev}: {time.perf_counter() - t0:.3f} s, "
            f"error to GT {compute_pose_err(poses[dev], pose_gt)}, inliers "
            f"{stats[dev]['best_num_inliers']}")
    d_t, d_r = pose_difference(poses["cuda"], poses["cpu"])
    log(f"[loc card-vs-cpu] final poses card vs CPU: {d_t:.2e} m, "
        f"{d_r:.2e} deg")
    check(d_t <= LOC_POSE_TOL_M and d_r <= LOC_POSE_TOL_DEG,
          ("final pose card vs CPU", d_t, d_r))


class Recorder:
    """Wraps ``module.name`` to keep the arguments of its largest call
    (by ``size``), so the path's own inputs can be measured afterwards."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.orig = getattr(module, name)
        self.args, self.kwargs, self.best = None, None, -1

        def wrapper(*args, **kwargs):
            n = size(*args, **kwargs)
            if n > self.best:
                self.args, self.kwargs, self.best = args, kwargs, n
            return self.orig(*args, **kwargs)

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def localization_full_width(scene, tracks, workdir, card):
    """Phase 8: the queries through hybrid_localization on the card with
    phase 7's runner map, gated against the JAX package's run of the same
    queries.  Returns the path's launches and the recorded kernel
    inputs."""
    from limap_tpu_torch.ops import (epipolar_iou, lm_jointloc, pose_score,
                                     trace_roots)
    from limap_tpu_torch.testing import localization
    from limap_tpu_torch.runners import functions as runners_functions
    from limap_tpu_torch.util.config import default_localization_config
    from limap_tpu_torch.util.profiler import StageProfiler
    est = importlib.import_module("limap_tpu_torch.estimators.absolute_pose")
    pnl = importlib.import_module("limap_tpu_torch.estimators.pnl_solvers")
    runner = importlib.import_module(
        "limap_tpu_torch.runners.hybrid_localization")

    # the localization config's line2d section gives the database images
    # the detections that the map's line ids index
    det_cfg = runners_functions.setup(dict(
        default_localization_config(),
        output_dir=os.path.join(workdir, "map_check")))
    segs, _ = runners_functions.compute_2d_segs(
        det_cfg, scene[0], compute_descinfo=False, device="cuda")
    worst, n_sup = 0.0, 0
    for tr in tracks:
        for img_id, lid, l2d in zip(tr.image_id_list, tr.line_id_list,
                                    tr.line2d_list):
            check(img_id in segs and 0 <= lid < len(segs[img_id]),
                  ("track support out of range", img_id, lid))
            worst = max(worst, float(np.abs(
                np.asarray(segs[img_id][lid][:4]).reshape(2, 2)
                - np.asarray(l2d)).max()))
            n_sup += 1
    log(f"[localize] map: {len(tracks)} tracks, {n_sup} supports, every "
        f"(image, line id) in range of the localization config's "
        f"detections; stored 2D segments against them: max abs diff "
        f"{worst:.2e} px")
    check(worst <= 1e-3, ("map segments differ from the detections", worst))

    q = localization.build_queries(
        scene, LOCALIZE_QUERIES, image_dir=os.path.join(workdir, "queries"))
    cfg = default_localization_config()
    cfg["output_dir"] = os.path.join(workdir, "localization")
    recorders = {
        "pose_score": Recorder(est, "pose_score", lambda *a, **k: (
            -1 if k.get("errors") else a[0].shape[0] * (a[3].shape[0]
                                                        + a[5].shape[0]))),
        "trace_roots": Recorder(pnl, "trace_roots",
                                lambda *a, **k: a[0].shape[0]),
        "epipolar_iou_grid": Recorder(runner, "epipolar_iou_grid",
                                      lambda *a, **k: a[0].shape[0]
                                      * a[1].shape[0]),
    }
    kernels = {"pose_score": pose_score.pose_score,
               "trace_roots": trace_roots.trace_roots,
               "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid,
               "lm_jointloc": lm_jointloc.solve}
    for k in kernels.values():
        k.launches = 0
    # every LO solve's input, for kernel I's comparison with plain
    lo_calls, lo_solve = [], lm_jointloc.solve

    def recorded_lo_solve(*args, **kwargs):
        lo_calls.append((args, kwargs))
        return lo_solve(*args, **kwargs)

    lm_jointloc.solve = recorded_lo_solve
    # the LO's joint pose LM: solves, rows and synchronized seconds
    lm = {"solves": 0, "rows": 0, "iterations": 0, "s": 0.0}
    solve_batch = est.solve_jointloc_batch

    def counted_solve(*args, **kwargs):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = solve_batch(*args, **kwargs)
        torch.cuda.synchronize()
        lm["s"] += time.perf_counter() - t_start
        lm["solves"] += 1
        lm["rows"] += int(out[0].shape[0])
        lm["iterations"] += kwargs.get("num_iterations", 50)
        return out

    est.solve_jointloc_batch = counted_solve
    prof, stats = StageProfiler(device="cuda"), {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        poses = runner.hybrid_localization(
            cfg, scene[0], q["imagecols"], q["points"], tracks,
            q["retrieval"], device="cuda", prof=prof, stats=stats)
    finally:
        est.solve_jointloc_batch = solve_batch
        lm_jointloc.solve = lo_solve
        for r in recorders.values():
            r.restore()
    wall = time.perf_counter() - t0
    log(f"[localize] the LO's pose LM: {lm['solves']} batched solves "
        f"({lm['rows']} rows, {lm['iterations']} iterations) in "
        f"{lm['s']:.3f} s, {1e3 * lm['s'] / max(lm['iterations'], 1):.2f} "
        f"ms an iteration")
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[localize] {len(poses)} queries in {wall:.3f} s; stage seconds "
        f"{json.dumps(prof.times)} on {card}; kernel launches "
        f"{json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, n in launches.items():
        check(n > 0, f"the localization path did not launch {name}")

    errors = localization.pose_errors(poses, q["gt"])
    for q_id, (te, re) in errors.items():
        st = stats[q_id]
        log(f"[localize] query {q_id}: {te * 100:.2f} cm, {re:.3f} deg; "
            f"{st['n_line_matches']} line matches, "
            f"{int(st['ransac']['line_inliers'].sum())} line and "
            f"{int(st['ransac']['point_inliers'].sum())} point inliers")
    summary = localization.summarize(errors)
    ref = localization.summarize(dict(enumerate(
        REFERENCE_LOCALIZE_ERRORS[:LOCALIZE_QUERIES])))
    log(f"[localize] {json.dumps(summary)}; the JAX package's run "
        f"{json.dumps(ref)}")
    check(summary["n_under"] >= ref["n_under"] - 1,
          ("queries under 5 cm / 0.5 deg", summary, ref))
    check(summary["median_t_m"] <= 1.5 * ref["median_t_m"] + 0.002,
          ("median translation error", summary, ref))
    check(summary["median_r_deg"] <= 1.5 * ref["median_r_deg"] + 0.05,
          ("median rotation error", summary, ref))
    return launches, dict({k: (r.args, r.kwargs)
                           for k, r in recorders.items()},
                          lm_jointloc=lo_calls)


LOC_TURNS = ("plain", "kernel", "kernel", "plain")


def timed_entry(name, path, source, replaces, launches, kernel, plain, args,
                kwargs, err, bound_ms, bound_by, shape, reps):
    """A kernel's entry of the kernels line: the kernel and its plain
    version timed in turns (LOC_TURNS; ``reps`` = (kernel runs, plain
    runs) a turn) on the input it was held to the plain version on."""
    times = {"kernel": [], "plain": []}
    for which in LOC_TURNS:
        fn = kernel if which == "kernel" else plain
        n = reps[0] if which == "kernel" else reps[1]
        times[which].append(cuda_ms(lambda: fn(*args, **kwargs), n))
    log(f"[kernel] {path} {name} {json.dumps(shape)}: max abs err to plain "
        f"{err:.3e}; ms in turns {list(LOC_TURNS)}: {json.dumps(times)}; "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": name, "path": path, "route": "cuda",
            "source": "limap_tpu_torch/csrc/" + source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": float(np.mean(times["kernel"])),
            "ms_turns": times["kernel"],
            "plain_ms": float(np.mean(times["plain"])),
            "plain_ms_turns": times["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **shape}


def measure_localization_kernels(recorded, launches):
    """Each localization kernel on the largest input its path gave it:
    held to the plain version, timed against it in turns, and its bound."""
    from limap_tpu_torch.ops import epipolar_iou, pose_score, trace_roots
    from limap_tpu_torch.testing import kernel_checks
    plain = {"pose_score": pose_score.pose_score_plain,
             "trace_roots": trace_roots.trace_roots_plain,
             "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid_plain}
    kernel = {"pose_score": pose_score.pose_score,
              "trace_roots": trace_roots.trace_roots,
              "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid}
    source = {"pose_score": ("pose_score.cu",
                             "limap_tpu/estimators/absolute_pose.py:70"),
              "trace_roots": ("trace_roots.cu",
                              "limap_tpu/estimators/pnl_solvers.py:142"),
              "epipolar_iou_grid": (
                  "epipolar_iou.cu",
                  "limap_tpu/triangulation/functions.py:149")}
    entries = [measure_jointloc(recorded.pop("lm_jointloc"),
                                launches["lm_jointloc"])]
    for name, (args, kwargs) in recorded.items():
        out_k = kernel[name](*args, **kwargs)
        out_p = plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        if name == "trace_roots":
            res = kernel_checks.compare_trace_roots(
                out_k, out_p, args[6],
                kernel_checks.rank_deficient(*args[:5]), args[:5])
            log(f"[kernel] localization trace_roots against plain on the "
                f"path's input: {json.dumps(res)}")
            check(res["ok"], (name, "on the path's input", res))
            err = res["max_abs_err"]
            B, K = args[0].shape[0], args[4].shape[0]
            n_roots, n_bisect = args[6], args[5]
            evals = K + 3 * n_roots * n_bisect + 3 * n_roots
            bms, by = bound(B * evals * OPS_G,
                            B * 96 + K * 4 + B * 2 * n_roots * 37)
            shape = {"instances": B, "grid": K - 1, "n_roots": n_roots}
        elif name == "pose_score":
            res = kernel_checks.compare_pose_score(
                out_k, out_p, kernel[name](*args, errors=True),
                plain[name](*args, errors=True), args[9],
                kernel_checks.pose_score_spread(args[:9], args[9]))
            log(f"[kernel] localization pose_score against plain on the "
                f"path's input: {json.dumps(res)}")
            check(res["ok"], (name, "on the path's input", res))
            err = res["max_abs_err"]
            H, Np, Nl = args[0].shape[0], args[3].shape[0], args[5].shape[0]
            bms, by = bound(H * (Np * OPS_POINT + Nl * OPS_LINE),
                            H * 28 + 16 + Np * 20 + Nl * 40
                            + H * (4 + Np + Nl))
            shape = {"poses": H, "points": Np, "lines": Nl}
        else:
            res = kernel_checks.compare_epipolar(out_k, out_p)
            check(res["ok"], (name, "on the path's input", res))
            err = res["max_abs_err"]
            Nr, Nt = args[1].shape[0], args[0].shape[0]
            bms, by = bound(Nr * Nt * OPS_PAIR, Nt * 16 + Nr * 24 + Nr * Nt * 4)
            shape = {"rows": Nr, "cols": Nt}
        entries.append(timed_entry(
            name, "localization", *source[name], launches[name],
            kernel[name], plain[name], args, kwargs, err, bms, by, shape,
            (20, 2)))
    return entries



def fit_rows(fitted):
    """{img_id: rows of fitted (non-zero) segments}."""
    return {i: np.flatnonzero(np.abs(v).sum((1, 2)) > 0)
            for i, v in fitted.items()}


def fitnmerge_card_vs_cpu(workdir):
    """Phase 9a: line_fitnmerge on the card, then on the CPU from the
    card's detections, on 6 rendered views of 240x320 with depth; both
    draw the same RANSAC hypotheses (seed 0)."""
    from limap_tpu_torch.runners import line_fitnmerge
    from limap_tpu_torch.testing import fitnmerge

    imagecols, _, nbrs, _, depths = fitnmerge.build_scene(
        n_views=6, n_lines=30, hw=(240, 320), n_neighbors=4,
        image_dir=os.path.join(workdir, "images"))
    tracks, fitted = {}, {}
    for dev in ("cuda", "cpu"):
        cfg = fitnmerge.config(os.path.join(workdir, dev), n_neighbors=4)
        cfg["n_visible_views"] = 3
        if dev == "cpu":
            cfg.update(load_det=True, load_dir=os.path.join(workdir, "cuda"))
        tracks[dev] = line_fitnmerge(cfg, copy.deepcopy(imagecols), depths,
                                     neighbors=copy.deepcopy(nbrs),
                                     device=dev)
        fitted[dev] = np.load(os.path.join(workdir, dev,
                                           "fitted_3d_segs.npy"),
                              allow_pickle=True).item()
    rows = {dev: fit_rows(f) for dev, f in fitted.items()}
    check(all(np.array_equal(rows["cuda"][i], rows["cpu"][i])
              for i in rows["cpu"]), "card and CPU fit different segments")
    fit_err = max((endpoint_error(x, y) for i, r in rows["cpu"].items()
                   for x, y in zip(fitted["cuda"][i][r], fitted["cpu"][i][r])),
                  default=0.0)
    n_fit = sum(len(r) for r in rows["cpu"].values())
    keys = {dev: sorted(map(key, t)) for dev, t in tracks.items()}
    log(f"[fitnmerge card-vs-cpu] {n_fit} fitted segments on both devices, "
        f"endpoints {fit_err:.2e} m apart; tracks {len(tracks['cuda'])} on "
        f"the card, {len(tracks['cpu'])} on the CPU")
    check(n_fit > 100, ("too few fitted segments", n_fit))
    check(fit_err <= FIT_TOL_M, ("fitted endpoints card vs CPU", fit_err))
    check(keys["cuda"] == keys["cpu"] and len(keys["cpu"]) > 10,
          "card and CPU tracks differ")
    cpu = {key(x): x for x in tracks["cpu"]}
    line_err = max(endpoint_error(x.line, cpu[key(x)].line)
                   for x in tracks["cuda"])
    log(f"[fitnmerge card-vs-cpu] identical tracks and supports; lines "
        f"{line_err:.2e} m apart")
    check(line_err <= FNM_LINE_TOL_M, ("track lines card vs CPU", line_err))


# FP32 operations of line_ransac, counted from csrc/line_ransac.cu (a
# multiply-add as two, a sqrt as one): 17 a distance, per (segment,
# hypothesis, valid sample).
OPS_RANSAC_DIST = 17
# FP32 operations of each test of linker_edges, counted from
# csrc/linker_edges.cu for D-dimensional segments (an add, multiply,
# divide, sqrt, exp, acos, min, max, abs or compare as one); a distance's
# test includes its score (6), and in 3D the pair's uncertainty (4).
OPS_LINKER_TEST = {"angle": lambda D: 2 * D + 5,
                   "overlap": lambda D: 12 * D + 14,
                   "smartangle": lambda D: 14,
                   "perp": lambda D: 20 * D + 17 + 4 * (D == 3),
                   "innerseg": lambda D: 54 * D + 32 + 4 * (D == 3)}
PASSES = {"angle": lambda v, th: v <= th, "overlap": lambda v, th: v > th}
# a segment projected into a view (two points, 40 each, and its 2D
# direction); a line's 3D and 2D directions
OPS_PROJECT_SEG, OPS_LINE = 89, 22


def linker_work(l2d, l3d, mask, views, nbrs, nmask, cfg2d, cfg3d):
    """FP32 operations the edge test needs on this input: each test of a
    pair of valid lines counted only where the pair reaches it (a pair
    stops at its first failed test: the 3D check, then a self pair's 2D
    check, or a cross pair's two projected 2D checks), each valid line's
    directions once, and, per live neighbour slot, the projections of
    both images' valid lines.  Returns (operations, pairs per stage)."""
    from limap_tpu_torch.base import line_geometry as lg
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.testing.fitnmerge_checks import linker_tests

    reached = {}

    def run(checks, live):
        ops = 0
        for stage, (l1, l2, cfg, D, u) in enumerate(checks):
            for name, v, th in linker_tests(l1, l2, cfg, u):
                if name not in OPS_LINKER_TEST:
                    continue  # innerseg's overlap conditions, counted in it
                n = int(live.sum())
                key = f"{stage}_{D}d_{name}"
                reached[key] = reached.get(key, 0) + n
                ops += n * OPS_LINKER_TEST[name](D)
                live = live & PASSES.get(name, lambda v, th: v >= th)(v, th)
        return ops

    I, L = mask.shape
    cnt = mask.sum(1).tolist()
    u = l3d.uncertainty
    iu = torch.triu(torch.ones((L, L), dtype=torch.bool, device=mask.device),
                    diagonal=1)
    ops = OPS_LINE * sum(cnt)
    for i in range(I):
        row3 = Segments(l3d.start[i][:, None], l3d.end[i][:, None])
        row2 = Segments(l2d.start[i][:, None], l2d.end[i][:, None])
        col3 = Segments(l3d.start[i][None], l3d.end[i][None])
        col2 = Segments(l2d.start[i][None], l2d.end[i][None])
        ops += run([(row3, col3, cfg3d, 3,
                     torch.minimum(u[i][:, None], u[i][None])),
                    (row2, col2, cfg2d, 2, None)],
                   mask[i][:, None] & mask[i][None] & iu)
        js = nbrs[i][nmask[i]].long()
        if not len(js):
            continue
        col3 = Segments(l3d.start[js][:, None], l3d.end[js][:, None])
        col2 = Segments(l2d.start[js][:, None], l2d.end[js][:, None])
        vj = CameraViewsBatch(*(x[js][:, None, None] for x in views))
        vi = CameraViewsBatch(*(x[i] for x in views))
        ops += run([(row3, col3, cfg3d, 3,
                     torch.minimum(u[i][:, None], u[js][:, None])),
                    (lg.project_segments(row3, vj), col2, cfg2d, 2, None),
                    (lg.project_segments(col3, vi), row2, cfg2d, 2, None)],
                   mask[i][:, None] & mask[js][:, None])
        ops += OPS_PROJECT_SEG * sum(cnt[i] + cnt[j] for j in js.tolist())
    return ops, reached


def fitnmerge_full_width(scene, workdir, card):
    """Phase 9: line_fitnmerge on phase 7's scene with the wall's depth,
    gated against the JAX package's run; returns the kernels' launches
    and their recorded inputs."""
    from limap_tpu_torch.base.depth_reader_base import ArrayDepthReader
    from limap_tpu_torch.fitting import fitting
    from limap_tpu_torch.merging import merging
    from limap_tpu_torch.ops import line_ransac, linker_edges
    from limap_tpu_torch.testing import fitnmerge

    t0 = time.perf_counter()
    imagecols, imgs, nbrs, gt = scene
    depths = {i: ArrayDepthReader(fitnmerge.wall_depth(imagecols.camview(i)))
              for i in imagecols.get_img_ids()}
    log(f"[fitnmerge] depth maps of the wall for {len(depths)} views in "
        f"{time.perf_counter() - t0:.1f} s")
    recorders = {
        "line_ransac": Recorder(fitting, "line_ransac",
                                lambda *a, **k: a[0].shape[0]),
        "linker_edges": Recorder(merging, "linker_edges",
                                 lambda *a, **k: a[2].numel()),
    }
    kernels = {"line_ransac": line_ransac.line_ransac,
               "linker_edges": linker_edges.linker_edges}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        r = fitnmerge.run(device="cuda", workdir=workdir,
                          scene=(imagecols, imgs, nbrs, gt, depths))
    finally:
        for rec in recorders.values():
            rec.restore()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    tracks = r.pop("linetracks")
    log(f"[fitnmerge] line_fitnmerge, {len(depths)} views, {wall:.3f} s in "
        f"all; stage seconds {json.dumps(r['stages_s'])} on {card}; kernel "
        f"launches {json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[fitnmerge] avg segments per image {r['avg_segs']:.2f}; "
        f"{r['n_fitted']} fitted segments; {r['n_tracks_all']} tracks; "
        f"quality_eval {json.dumps(r['quality'])}")
    for name, n in launches.items():
        check(n > 0, f"the fit-and-merge path did not launch {name}")
    check(np.isfinite([x.line for x in tracks]).all(),
          "non-finite lines from fit and merge")
    measured = dict(r["quality"], n_tracks_all=r["n_tracks_all"],
                    avg_segs=r["avg_segs"], n_fitted=r["n_fitted"])
    hold_to_gates("fitnmerge", measured, REFERENCE_FITNMERGE,
                  FITNMERGE_GATES)
    return launches, {k: (rec.args, rec.kwargs)
                      for k, rec in recorders.items()}


def measure_fitnmerge_kernels(recorded, launches):
    """Kernels D and E on the whole inputs the fit-and-merge path gave
    them: held to the plain version, timed against it in turns, and
    their bounds."""
    from limap_tpu_torch.ops import line_ransac, linker_edges
    from limap_tpu_torch.ops.connected_components import \
        connected_components
    from limap_tpu_torch.testing import fitnmerge_checks as fc
    entries = []

    args, _ = recorded["line_ransac"]
    points, valid, th, idx_a, idx_b = args
    out_k = line_ransac.line_ransac(*args)
    out_p = line_ransac.line_ransac_plain(*args)
    res = fc.compare_line_ransac(out_k, out_p, args)
    log(f"[kernel] fitnmerge line_ransac against plain on the path's "
        f"input: {json.dumps(res)}")
    check(res["ok"] and res["rows_differ"] == 0,
          ("line_ransac", "on the path's input", res))
    N, S = valid.shape
    H = idx_a.shape[1]
    n_valid = int(valid.sum())
    bms, by = bound(n_valid * H * OPS_RANSAC_DIST,
                    N * S * 13 + N * 4 + N * H * 8 + N * S + N * 12)
    shape = {"segments": N, "samples": S, "hypotheses": H,
             "valid_samples": n_valid}
    entries.append(timed_entry(
        "line_ransac", "fitnmerge", "line_ransac.cu",
        "limap_tpu/fitting/fitting.py:73", launches["line_ransac"],
        line_ransac.line_ransac, line_ransac.line_ransac_plain, args, {},
        res["max_abs_err"], bms, by, shape, (5, 1)))

    args, _ = recorded["linker_edges"]
    l2d, l3d, mask, views, nbrs, nmask, cfg2d, cfg3d = args
    out_k = linker_edges.linker_edges(*args)
    out_p = linker_edges.linker_edges_plain(*args)
    host = lambda x: x.cpu().numpy()
    arrays = (host(l2d.start), host(l2d.end), host(l3d.start),
              host(l3d.end), host(l3d.uncertainty), host(mask),
              host(views.kvec), host(views.qvec), host(views.tvec),
              host(nbrs), host(nmask))
    from limap_tpu_torch.base.line_linker import LineLinker
    res = fc.compare_linker_edges(out_k, out_p, arrays,
                                  LineLinker(cfg2d, cfg3d))
    I, L = mask.shape
    K = nbrs.shape[1]
    labels = []
    for bits in (out_k, out_p):
        e = linker_edges.edges_from_bits(*bits, nbrs, L)
        labels.append(connected_components(
            I * L, e, torch.ones(len(e), dtype=torch.bool, device=e.device)))
    res["labels_equal"] = bool(torch.equal(labels[0], labels[1]))
    log(f"[kernel] fitnmerge linker_edges against plain on the path's input "
        f"({I} images x {L} lines x {K} neighbours): {json.dumps(res)}")
    # at full width every flip must sit within FLIP_TOL of a threshold
    check(res["ok"] and res["labels_equal"] and res["flips_in_spread"] == 0,
          ("linker_edges", "on the path's input", res))
    n_pairs = linker_edges.n_valid_pairs(mask, nbrs, nmask)
    ops, reached = linker_work(*args)
    log(f"[kernel] fitnmerge linker_edges: pairs reaching each test "
        f"(check_test): {json.dumps(reached)}; {ops} operations")
    W = linker_edges.n_words(L)
    bms, by = bound(ops, I * L * (16 + 24 + 4 + 1) + I * 44 + I * K * 5
                    + I * (K + 1) * L * W * 4)
    shape = {"images": I, "lines": L, "neighbours": K,
             "valid_pairs": n_pairs, "operations": ops}
    entries.append(timed_entry(
        "linker_edges", "fitnmerge", "linker_edges.cu",
        "limap_tpu/merging/merging.py:76", launches["linker_edges"],
        linker_edges.linker_edges, linker_edges.linker_edges_plain, args,
        {}, res["max_abs_err"], bms, by, shape, (5, 1)))
    return entries


# bytes a proposal takes in and out of kernels F and G: F writes 9 floats
# and ok (and, exhaustive, the word); G reads ok and writes the score in
# every bucket slot (SLOT_BYTES_G), and reads the 9 floats and the word
# of an ok proposal alone (OK_BYTES_G)
ROW_BYTES_F, SLOT_BYTES_G, OK_BYTES_G = 37, 5, 40
F_SOURCE, G_SOURCE = "tri_propose.cu", "tri_score.cu"
F_REPLACES = "limap_tpu/triangulation/triangulator.py:221"
# the same program's VP banks (:302-314) on the VP path
F_VP_REPLACES = "limap_tpu/triangulation/triangulator.py:221, :302"
J_SOURCE = "vp_detect.cu"
J_REPLACES = "limap_tpu/vplib/jlinkage.py:90"
G_REPLACES = "limap_tpu/triangulation/triangulator.py:342"


def triangulator_recorders():
    """Recorders of the largest inputs of kernels F and G and of the line
    BA's kernel H on a mapping path."""
    from limap_tpu_torch.ops import lm_line_ba, tri_propose, tri_score
    numel = lambda i: (lambda *a, **k: a[i].numel())
    return {"lm_line_ba": Recorder(lm_line_ba, "solve", numel(7)),
            "propose": Recorder(tri_propose, "propose", numel(5)),
            "count_exhaustive": Recorder(tri_propose, "count_exhaustive",
                                         numel(5)),
            "propose_exhaustive": Recorder(
                tri_propose, "propose_exhaustive",
                lambda *a, **k: a[5].numel() * a[6]),
            "score": Recorder(tri_score, "score", numel(7))}


def triangulator_launches():
    from limap_tpu_torch.ops import lm_line_ba, tri_propose, tri_score
    return {"tri_propose": tri_propose.propose.launches,
            "tri_score": tri_score.score.launches,
            "lm_line_ba": lm_line_ba.solve.launches}


def reset_triangulator_launches():
    """Zero F's, G's and H's counts; call it before triangulator_recorders
    wraps the functions that carry them."""
    from limap_tpu_torch.ops import lm_line_ba, tri_propose, tri_score
    tri_propose.propose.launches = 0
    tri_score.score.launches = 0
    lm_line_ba.solve.launches = 0


def measure_score(path, args, launches, kwargs=None):
    """Kernel G on a path's largest input: held to the plain version on
    the same proposals, timed in turns, and its bound.  ``kwargs`` holds
    the pack width of the VP path."""
    from limap_tpu_torch.ops import tri_score
    from limap_tpu_torch.testing import tri_checks
    kw = {"pack": (kwargs or {}).get("pack")}
    cfg, L, K, l2d, cam, words, meta, tri, ok = args
    res = tri_checks.compare_score(
        *args, tri_score.score(*args, return_scores=True, **kw),
        tri_score.score_plain(*args, return_scores=True, **kw))
    log(f"[kernel] {path} tri_score against plain on the path's input: "
        f"{json.dumps(res)}")
    check(res["ok_to_plain"], ("tri_score", path, res))
    work = tri_checks.score_work(cfg, L, K, words, meta, tri, ok)
    ops = tri_checks.operations(work, tri_checks.OPS_G)
    N, T = ok.shape
    P = T if kw["pack"] is None else kw["pack"]
    # in: l2d, cam, meta, ok of every slot, an ok proposal's row and word;
    # out: every slot's score, the floats and ints of each line
    bms, by = bound(ops, l2d.numel() * 4 + cam.numel() * 4
                    + meta.numel() * 4 + N * T * SLOT_BYTES_G
                    + int(ok.sum()) * OK_BYTES_G + N * 40
                    + N * (P + 1) * 4)
    log(f"[kernel] {path} tri_score: ordered pairs reaching each stage "
        f"{json.dumps(work)}; {ops} operations")
    shape = {"lines": N, "width": T, "neighbours": K,
             "ok_proposals": int(ok.sum()), "operations": ops, **work}
    return timed_entry("tri_score", path, G_SOURCE, G_REPLACES,
                       launches["tri_score"], tri_score.score,
                       tri_score.score_plain, args, kw, res["max_abs_err"],
                       bms, by, shape, (3, 1))


def measure_triangulator_kernels(path, recorded, launches):
    """Kernels F (form a) and G on a matcher path's largest inputs."""
    from limap_tpu_torch.ops import tri_propose
    from limap_tpu_torch.testing import tri_checks
    args, kwargs = recorded["propose"]
    check(args is not None, (path, "kernel F saw no input"))
    names = ("ranges", "vp")
    args = args[:7] + tuple(args[7 + i] if len(args) > 7 + i
                            else kwargs.get(n) for i, n in enumerate(names))
    cfg, L, K, l2d, cam, words, meta, ranges, vp = args
    out_k = tri_propose.propose(*args)
    res = tri_checks.compare_propose(*args[:7], out_k,
                                     tri_propose.propose_plain(*args), ranges,
                                     vp)
    log(f"[kernel] {path} tri_propose against plain on the path's input: "
        f"{json.dumps(res)}")
    check(res["ok_to_plain"], ("tri_propose", path, res))
    N, T = words.shape[0] * L, words.shape[-1]
    kinds = tri_propose.banks(cfg, vp)
    work = {}
    if tri_propose.BANK_ALGEBRAIC in kinds:
        work = tri_checks.words_work(*args[:7], out_k[1][:, :T], ranges)
    # every bucket slot of a VP bank writes a row
    work["vp_row"] = int((words >= 0).sum()) * sum(
        k != tri_propose.BANK_ALGEBRAIC for k in kinds)
    ops = tri_checks.operations(work, dict(tri_checks.ops_f(cfg),
                                           vp_row=tri_checks.OPS_F_VP_ROW))
    B = len(kinds)
    bms, by = bound(ops, l2d.numel() * 4 + cam.numel() * 4 + N * T * 4
                    + meta.numel() * 4 + N * B * T * ROW_BYTES_F
                    + (0 if vp is None else vp.numel() * 4))
    log(f"[kernel] {path} tri_propose: candidates reaching each stage "
        f"{json.dumps(work)}; {ops} operations")
    shape = {"lines": N, "width": T, "banks": kinds, "neighbours": K,
             "operations": ops, **work}
    entries = [timed_entry("tri_propose", path, F_SOURCE,
                           F_REPLACES if vp is None else F_VP_REPLACES,
                           launches["tri_propose"], tri_propose.propose,
                           tri_propose.propose_plain, args, {},
                           res["max_abs_err"], bms, by, shape, (3, 1))]
    args, kwargs = recorded["score"]
    entries.append(measure_score(path, args, launches, kwargs))
    entries.append(measure_line_ba(path, recorded["lm_line_ba"],
                                   launches["lm_line_ba"]))
    return entries


H_SOURCE, I_SOURCE = "lm_line_ba.cu", "lm_jointloc.cu"
# the jitted LM program both kernels replace (_build_lm_runner)
LM_REPLACES = "limap_tpu/optimize/lm.py:64"


def measure_line_ba(path, recorded, launches):
    """Kernel H on a path's whole BA input: its normal equations at the
    start and its solve held to plain row by row, timed in turns, and its
    bound."""
    from limap_tpu_torch.ops import lm_line_ba
    from limap_tpu_torch.testing import lm_checks
    args, kwargs = recorded
    check(args is not None, (path, "kernel H saw no input"))
    params0, aux, cfg = args[0], tuple(args[1:8]), args[8]
    n_iter = args[9] if len(args) > 9 else kwargs.get("num_iterations", 20)
    t0 = time.perf_counter()
    res_ne, res = lm_checks.check_line_ba(params0, aux, cfg, n_iter)
    log(f"[kernel] {path} lm_line_ba normal equations at the start against "
        f"plain: {json.dumps(res_ne)}")
    log(f"[kernel] {path} lm_line_ba solve against plain, row by row: "
        f"{json.dumps(res)} ({time.perf_counter() - t0:.1f} s)")
    check(res_ne["ok"], ("lm_line_ba normal equations", path, res_ne))
    check(res["ok"], ("lm_line_ba", path, res))
    T, S = aux[-1].shape
    active = int((aux[-1] & (aux[5] > 0)).sum())
    ops = lm_checks.ops_line_ba(active, T, n_iter, int(aux[-1].sum()))
    bms, by = bound(ops, lm_checks.bytes_line_ba(T, S))
    shape = {"tracks": T, "supports": S, "active_supports": active,
             "iterations": n_iter, "operations": ops,
             "parted_rows": res["parted"],
             "normal_equations_max_rel_err": res_ne["max_rel_err"]}
    return timed_entry(
        "lm_line_ba", path, H_SOURCE, LM_REPLACES, launches,
        lambda: lm_line_ba.solve(*args, **kwargs),
        lambda: lm_line_ba.solve_plain(params0, aux, cfg, n_iter), (), {},
        res["max_abs_err"], bms, by, shape, (5, 1))


def measure_jointloc(calls, launches):
    """Kernel I on every LO solve of phase 8: the solves of a query share
    their matches and config, so their rows go to plain together (rows
    are independent); the normal equations at the start and the solve
    held to plain row by row; the largest solve timed in turns, with its
    bound."""
    from limap_tpu_torch.ops import lm_jointloc
    from limap_tpu_torch.testing import lm_checks
    check(calls, "the localization path gave kernel I no input")
    groups = {}
    for args, kwargs in calls:
        n_iter = args[11] if len(args) > 11 else kwargs.get(
            "num_iterations", 50)
        key = (args[1].data_ptr(), args[6].data_ptr(), args[10], n_iter)
        groups.setdefault(key, []).append(args)
    t0 = time.perf_counter()
    totals = {"solves": len(calls), "groups": len(groups), "rows_held": 0,
              "parted": 0, "stalled_at_singular_point": 0, "accepted": 0}
    err = ne_err = 0.0
    for (_, _, cfg, n_iter), group in groups.items():
        params0 = torch.cat([a[0] for a in group])
        data = list(group[0][1:10])
        data[4] = torch.cat([a[5] for a in group])
        data[7] = torch.cat([a[8] for a in group])
        res_ne, res = lm_checks.check_jointloc(params0, tuple(data), cfg,
                                               n_iter)
        check(res_ne["ok"], ("lm_jointloc normal equations", res_ne))
        check(res["ok"], ("lm_jointloc", res))
        totals["rows_held"] += res["rows"]
        for k in ("parted", "stalled_at_singular_point", "accepted"):
            totals[k] += res[k]
        err = max(err, res["max_abs_err"])
        ne_err = max(ne_err, res_ne["max_rel_err"])
    log(f"[kernel] localization lm_jointloc against plain on every LO solve, "
        f"row by row: {json.dumps(totals)}; max abs err {err:.3e}; normal "
        f"equations max rel err {ne_err:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    args, kwargs = max(calls, key=lambda c: c[0][0].shape[0]
                       * (c[0][1].shape[0] + c[0][6].shape[0]))
    params0, data, cfg = args[0], args[1:10], args[10]
    n_iter = args[11] if len(args) > 11 else kwargs.get("num_iterations", 50)
    T, nl, npt = params0.shape[0], data[0].shape[0], data[5].shape[0]
    ops = lm_checks.ops_jointloc(cfg, int(data[4].sum()), int(data[7].sum()),
                                 T, n_iter)
    bms, by = bound(ops, lm_checks.bytes_jointloc(T, nl, npt))
    shape = {"rows": T, "lines": nl, "points": npt, "iterations": n_iter,
             "operations": ops, "config": [cfg.cost_function,
                                           cfg.cost_function_weight,
                                           cfg.loss], **totals,
             "normal_equations_max_rel_err": ne_err}
    return timed_entry(
        "lm_jointloc", "localization", I_SOURCE, LM_REPLACES, launches,
        lambda: lm_jointloc.solve(*args, **kwargs),
        lambda: lm_jointloc.solve_plain(params0, data, cfg, n_iter), (), {},
        err, bms, by, shape, (10, 1))


def measure_exhaustive_kernels(recorded, launches):
    """Kernels F (form b: the count and the write, timed together) and G
    on the exhaustive path's whole inputs."""
    from limap_tpu_torch.ops import tri_propose
    from limap_tpu_torch.testing import tri_checks
    cargs, _ = recorded["count_exhaustive"]
    wargs, _ = recorded["propose_exhaustive"]
    check(cargs is not None and wargs is not None,
          "the exhaustive path gave kernel F no input")
    cfg, L, K, l2d, cam, meta, ranges = cargs
    W = wargs[6]
    check(wargs[5].shape == meta.shape,
          ("the exhaustive path split its images into groups", W))
    counts_k = tri_propose.count_exhaustive(*cargs)
    counts_p = tri_propose.count_exhaustive_plain(*cargs)
    out_k = tri_propose.propose_exhaustive(*cargs[:6], W, ranges)
    out_p = tri_propose.propose_exhaustive_plain(*cargs[:6], W, ranges)
    res = tri_checks.compare_exhaustive(*cargs[:6], counts_k, counts_p,
                                        out_k, out_p, ranges)
    log(f"[kernel] exhaustive tri_propose against plain on the path's whole "
        f"input: {json.dumps(res)}")
    check(res["ok_to_plain"], ("tri_propose exhaustive", res))
    del out_p
    work = tri_checks.exhaustive_work(*cargs[:6], counts_k, ranges)
    ops = tri_checks.operations(work, tri_checks.ops_f(cfg))
    N = counts_k.shape[0]
    bms, by = bound(ops, l2d.numel() * 4 + cam.numel() * 4
                    + meta.numel() * 4 + N * 4
                    + int(counts_k.sum()) * (ROW_BYTES_F + 4))
    log(f"[kernel] exhaustive tri_propose: candidates reaching each stage "
        f"{json.dumps(work)}; {ops} operations")

    def kernel():
        return (tri_propose.count_exhaustive(*cargs),
                tri_propose.propose_exhaustive(*cargs[:6], W, ranges))

    def plain():
        return (tri_propose.count_exhaustive_plain(*cargs),
                tri_propose.propose_exhaustive_plain(*cargs[:6], W, ranges))

    shape = {"lines": N, "width": W, "neighbours": K,
             "survivors_max": res["survivors_max"], "operations": ops,
             **work}
    entries = [timed_entry("tri_propose", "exhaustive", F_SOURCE, F_REPLACES,
                           launches["tri_propose"], kernel, plain, (), {},
                           res["max_abs_err"], bms, by, shape, (1, 1))]
    words, tri, ok = out_k
    sargs = (cfg, L, K, l2d, cam, words.reshape(-1, L, W), meta, tri, ok)
    entries.append(measure_score("exhaustive", sargs, launches))
    entries.append(measure_line_ba("exhaustive", recorded["lm_line_ba"],
                                   launches["lm_line_ba"]))
    return entries


def exhaustive_card_vs_cpu(workdir):
    """Phase 10a: the exhaustive runner on the CPU, then on the card with
    the CPU's segments (phase 6 holds the detectors to each other), on 6
    rendered views of 240x320: the same tracks and supports."""
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline

    imagecols, _, nbrs, _ = pipeline.build_scene(
        n_views=6, n_lines=30, hw=(240, 320), n_neighbors=4,
        image_dir=os.path.join(workdir, "images"))
    tracks, stats = {}, {}
    for dev in ("cpu", "cuda"):
        cfg = pipeline.exhaustive_runner_config(os.path.join(workdir, dev),
                                                n_neighbors=4)
        cfg["n_visible_views"] = 3
        cfg["triangulation"]["fullscore_th"] = 0.5
        if dev == "cuda":
            cfg.update(load_det=True, load_dir=os.path.join(workdir, "cpu"))
        tracks[dev] = line_triangulation(cfg, imagecols, nbrs, device=dev)
        with open(os.path.join(workdir, dev, "metrics.json")) as f:
            stats[dev] = json.load(f)["exhaustive"]
    log(f"[exhaustive card-vs-cpu] proposals card {json.dumps(stats['cuda'])}"
        f", CPU {json.dumps(stats['cpu'])}")
    check(len(tracks["cuda"]) == len(tracks["cpu"]) > 10,
          ("exhaustive track count", len(tracks["cuda"]), len(tracks["cpu"])))
    check(sorted(map(key, tracks["cuda"])) == sorted(map(key, tracks["cpu"])),
          "card and CPU exhaustive supports differ")
    err, tied = hold_card_to_cpu(tracks["cuda"], tracks["cpu"])
    log(f"[exhaustive card-vs-cpu] {len(tracks['cuda'])} tracks, identical "
        f"supports; line error {err:.2e} m; near-tied tracks {tied}")


def exhaustive_full_width(scene, workdir, card):
    """Phase 10: the exhaustive runner on phase 7's images, gated against
    the port's CPU run; GT evaluation through nn_min_dist.  Returns the
    recorded inputs of F and G, their launches and the evaluation's
    queries and cloud."""
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.testing.synthetic import gt_point_cloud
    from limap_tpu_torch.util import io as limapio

    imagecols, _, nbrs, gt = scene
    cfg = pipeline.exhaustive_runner_config(workdir,
                                            n_neighbors=len(nbrs[0]))
    reset_triangulator_launches()
    recorders = triangulator_recorders()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tracks = line_triangulation(cfg, imagecols, nbrs, device="cuda")
    finally:
        for rec in recorders.values():
            rec.restore()
    wall = time.perf_counter() - t0
    launches = triangulator_launches()
    with open(os.path.join(workdir, "metrics.json")) as f:
        metrics = json.load(f)
    segs = limapio.read_all_segments_from_folder(os.path.join(
        workdir, "line_detections", "tpu_lsd", "segments"))
    check(not os.path.exists(os.path.join(workdir, "line_matchings")),
          "the exhaustive runner matched descriptors")
    quality = pipeline.quality_eval(tracks, gt)
    log(f"[exhaustive] line_triangulation, use_exhaustive_matcher, "
        f"{len(nbrs)} views, {wall:.3f} s in all; stage seconds "
        f"{json.dumps(metrics['stages_s'])} on {card}; kernel launches "
        f"{json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[exhaustive] proposals {json.dumps(metrics['exhaustive'])}; "
        f"overflow_edges {metrics['overflow_edges']}; {len(tracks)} tracks; "
        f"quality_eval {json.dumps(quality)}")
    for name, n in launches.items():
        check(n > 0, f"the exhaustive path did not launch {name}")
    check(metrics["overflow_edges"] == 0, "the exhaustive path dropped edges")
    check(np.isfinite([x.line for x in tracks]).all(),
          "non-finite lines from the exhaustive runner")
    measured = dict(quality, n_tracks_all=len(tracks),
                    avg_segs=float(np.mean([len(v) for v in segs.values()])))
    hold_to_gates("exhaustive", measured, REFERENCE_EXHAUSTIVE,
                  EXHAUSTIVE_GATES)
    t0 = time.perf_counter()
    evaluator = PointCloudEvaluator(gt_point_cloud(
        gt.astype(np.float32), 500), device="cuda")
    lines = np.stack([x.line for x in tracks])
    rep = report_error_to_gt(evaluator, lines, TAUS, 1000)
    torch.cuda.synchronize()
    log(f"[exhaustive] evaluation against the GT cloud "
        f"({len(lines) * 1000} queries x {evaluator.points.shape[0]} points) "
        f"in {time.perf_counter() - t0:.3f} s: recall {rep['recall']}; "
        f"precision {rep['precision']}")
    check(all(np.isfinite(rep["recall"][tau]) for tau in TAUS)
          and 0 < rep["recall"][0.01] <= rep["recall"][0.1],
          ("GT evaluation of the exhaustive tracks", rep))
    recorded = {k: (rec.args, rec.kwargs) for k, rec in recorders.items()}
    return (recorded, launches, evaluation_queries(tracks, 1000),
            evaluator.points)


def vp_direction_error(a, b):
    """Largest component difference of two VP tables [n, 3], each row
    compared up to sign."""
    if not len(a):
        return 0.0
    return float(np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1)).max())


def colmap_vp_card_vs_cpu(workdir):
    """Phase 11a: the COLMAP path with use_vp on the CPU, then on the card
    with the CPU's segments and matches, on a reduced façade (8 views of
    240x320): the same hypotheses give the same VP labels and VPs, and
    the same tracks and supports."""
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util import io as limapio
    from limap_tpu_torch.vplib import get_vp_detector

    model, image_dir, _ = pipeline.write_colmap_scene(
        workdir, n_views=8, n_lines=60, hw=(240, 320), n_points=400)
    tracks = {}
    for dev in ("cpu", "cuda"):
        cfg = pipeline.colmap_vp_config(os.path.join(workdir, dev),
                                        n_neighbors=4)
        cfg["n_visible_views"] = 3
        cfg["triangulation"]["fullscore_th"] = 0.5
        if dev == "cuda":
            cfg.update(load_det=True, load_match=True,
                       load_dir=os.path.join(workdir, "cpu"))
        tracks[dev] = line_triangulation(
            cfg, ReadInfos(model, image_dir),
            points3d=ReadPointTracks(model), device=dev)
    segs = limapio.read_all_segments_from_folder(os.path.join(
        workdir, "cpu", "line_detections", "tpu_lsd", "segments"))
    vpcfg = cfg["triangulation"]["vpdet_config"]
    res = {dev: get_vp_detector(vpcfg, device=dev).detect_vp_all_images(segs)
           for dev in ("cpu", "cuda")}
    n_vps = [res["cpu"][i].count_vps() for i in sorted(segs)]
    err = 0.0
    for i in segs:
        a, b = res["cuda"][i], res["cpu"][i]
        check(np.array_equal(a.labels, b.labels) and a.count_vps()
              == b.count_vps(), ("VP labels card vs CPU", i))
        err = max(err, vp_direction_error(a.vps, b.vps))
    check(err <= 1e-5, ("VPs card vs CPU", err))
    check(sum(n_vps) > 0, "no VP found on the reduced façade")
    check(len(tracks["cuda"]) == len(tracks["cpu"]) >= 8,
          ("colmap vp track count", len(tracks["cuda"]), len(tracks["cpu"])))
    check(sorted(map(key, tracks["cuda"])) == sorted(map(key, tracks["cpu"])),
          "card and CPU supports differ on the VP path")
    lerr, tied = hold_card_to_cpu(tracks["cuda"], tracks["cpu"])
    log(f"[colmap-vp card-vs-cpu] VPs an image {n_vps}, labels equal, VP "
        f"error {err:.2e} (up to sign); {len(tracks['cuda'])} tracks, "
        f"identical supports; line error {lerr:.2e} m; near-tied {tied}")


def colmap_vp_full_width(workdir, card):
    """Phase 11: the façade's COLMAP model read back and triangulated with
    use_vp on the card, gated against the port's CPU run.  Returns the
    recorded inputs of J, F, G and H and their launches."""
    from limap_tpu_torch.ops import vp_detect
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util import io as limapio

    t0 = time.perf_counter()
    model, image_dir, gt = pipeline.write_colmap_scene(workdir)
    imagecols = ReadInfos(model, image_dir)
    points3d = ReadPointTracks(model)
    log(f"[colmap-vp] façade scene and COLMAP model ({imagecols.NumImages()} "
        f"views, {len(points3d)} points) written and read back in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = pipeline.colmap_vp_config(os.path.join(workdir, "out"))
    reset_triangulator_launches()
    vp_detect.detect.launches = 0
    recorders = triangulator_recorders()
    recorders["vp_detect"] = Recorder(vp_detect, "detect",
                                      lambda *a, **k: a[0].numel())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tracks = line_triangulation(cfg, imagecols, points3d=points3d,
                                    device="cuda")
    finally:
        for rec in recorders.values():
            rec.restore()
    wall = time.perf_counter() - t0
    launches = dict(triangulator_launches(),
                    vp_detect=vp_detect.detect.launches)
    with open(os.path.join(cfg["dir_save"], "metrics.json")) as f:
        metrics = json.load(f)
    segs = limapio.read_all_segments_from_folder(os.path.join(
        cfg["dir_save"], "line_detections", "tpu_lsd", "segments"))
    matches_dir = os.path.join(
        cfg["dir_save"], "line_matchings", "tpu_lsd",
        "feats_patch_endpoints", "matches_nn_endpoints")
    n_matches = sum(len(m) for f in sorted(os.listdir(matches_dir))
                    for m in np.load(os.path.join(matches_dir, f),
                                     allow_pickle=True).item().values())
    quality = pipeline.quality_eval(tracks, gt)
    log(f"[colmap-vp] line_triangulation with use_vp from the COLMAP model, "
        f"{imagecols.NumImages()} views, {wall:.3f} s in all; stage seconds "
        f"{json.dumps(metrics['stages_s'])} on {card}; vp_detect stage "
        f"{metrics['stages_s']['vp_detect']:.4f} s; kernel launches "
        f"{json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, n in launches.items():
        check(n > 0, f"the COLMAP VP path did not launch {name}")
    check(launches["vp_detect"] == 1,
          ("every image's VPs in one launch", launches["vp_detect"]))
    # the VPs an image, from the path's own input (J is deterministic)
    args, _ = recorders["vp_detect"].args, recorders["vp_detect"].kwargs
    n_found = vp_detect.detect(*args)[2].cpu().numpy()
    log(f"[colmap-vp] VPs found an image: histogram "
        f"{np.bincount(n_found).tolist()} (index = VPs), "
        f"{int(n_found.sum())} in all over {len(n_found)} images")
    check(n_found.min() >= 1 and np.median(n_found) >= 2,
          ("façade images without their two VPs", n_found.tolist()))
    log(f"[colmap-vp] overflow_edges {metrics['overflow_edges']}; "
        f"{len(tracks)} tracks; quality_eval {json.dumps(quality)}")
    check(np.isfinite([x.line for x in tracks]).all(),
          "non-finite lines from the COLMAP VP runner")
    measured = dict(quality, n_tracks_all=len(tracks), n_matches=n_matches,
                    avg_segs=float(np.mean([len(v) for v in segs.values()])))
    hold_to_gates("colmap-vp", measured, REFERENCE_COLMAP_VP)
    recorded = {k: (rec.args, rec.kwargs) for k, rec in recorders.items()}
    return recorded, launches


def measure_vp_detect(recorded, launches):
    """Kernel J on the VP path's whole input: held to the plain version,
    timed in turns, and its bound."""
    from limap_tpu_torch.ops import vp_detect
    from limap_tpu_torch.testing import tri_checks, vp_checks
    args, kwargs = recorded
    check(args is not None, "the VP path gave kernel J no input")
    out_k = vp_detect.detect(*args, **kwargs)
    res = vp_checks.compare_detect(out_k, vp_detect.detect_plain(*args))
    log(f"[kernel] colmap_vp vp_detect against plain on the path's whole "
        f"input: {json.dumps(res)}")
    check(res["ok"], ("vp_detect", res))
    coords, ia, max_vps = args[0], args[5], args[7]
    work = vp_checks.detect_work(*args[:8], out_k[0], out_k[2])
    ops = tri_checks.operations(work, vp_checks.OPS_J)
    bms, by = bound(ops, vp_checks.detect_bytes(coords, ia, ia.shape[0],
                                                max_vps))
    log(f"[kernel] colmap_vp vp_detect: work {json.dumps(work)}; {ops} "
        f"operations")
    shape = {"images": int(ia.shape[0]), "lines": int(coords.shape[0]),
             "hypotheses": int(ia.shape[1]), "max_vps": int(max_vps),
             "vps_found": res["vps_found"], "operations": ops, **work,
             "library": "none: no library call runs sequential "
                        "multi-model RANSAC"}
    return timed_entry("vp_detect", "colmap_vp", J_SOURCE, J_REPLACES,
                       launches, vp_detect.detect, vp_detect.detect_plain,
                       args, {}, res["max_abs_err"], bms, by, shape, (10, 1))


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible")
        return 2
    from limap_tpu_torch.ops import cuda_build
    from limap_tpu_torch.ops import nn_distance as nnd

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("optional packages on this machine: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("yaml", "cv2", "PIL")))

    # ---- 1. build: one nvcc a source, all started together ----
    from limap_tpu_torch.ops import (epipolar_iou, line_ransac,
                                     linker_edges, lm_jointloc, lm_line_ba,
                                     pose_score, trace_roots, tri_propose,
                                     tri_score, vp_detect)
    from limap_tpu_torch.testing import (fitnmerge_checks, kernel_checks,
                                         lm_checks, tri_checks, vp_checks)
    t0 = time.perf_counter()
    libs = (nnd, trace_roots, pose_score, epipolar_iou, line_ransac,
            linker_edges, tri_propose, tri_score, lm_line_ba, lm_jointloc,
            vp_detect)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda m: m.build(), libs))
    log(f"[build] {len(libs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.2f} s")
    for stem, (secs, report) in cuda_build.BUILD_INFO.items():
        log(f"[build] {stem}: nvcc {secs:.2f} s\n{report.strip()}")
    kernels = {"nn_min_dist": nnd.nn_min_dist,
               "nn_min_dist_scalar": nnd.nn_min_dist_scalar}

    # ---- 2. kernels against plain versions ----
    rng = np.random.default_rng(0)

    def on_card(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device="cuda")

    # the raw filter values of the tensor-core kernel against the fp32
    # matrix product of the same operands, 1 km off the origin
    q = on_card(rng.uniform(-10, 10, (600, 3)) + 1000.0)
    p = on_card(rng.uniform(-10, 10, (1500, 3)) + 1000.0)
    B, centre, p_max, _ = nnd.prepare_cloud_operand(p)
    A, ss, _ = nnd.prepare_query_operand(q, centre, p_max)
    D = nnd.filter_tile_values(A, B)
    torch.cuda.synchronize()
    tile_err = (D - nnd.filter_values_plain(A, B[:nnd.CLOUD_PAD])).abs()
    # 8 addends up to (||s'|| + ||p'||)^2, each truncated at the largest
    # one's last place by the tensor cores
    tile_tol = 2.0 ** -19 * float((ss.max().sqrt() + p_max) ** 2)
    check(tile_err.max().item() <= tile_tol,
          ("filter tile vs matrix product", tile_err.max().item(), tile_tol))
    log(f"[kernel] filter tile == fp32 matrix product of its operands "
        f"(max abs err {tile_err.max().item():.3e} <= {tile_tol:.3e}, "
        f"values up to {D.abs().max().item():.1f})")

    for S, M in [(1, 5), (70, 300), (257, 1025), (513, 2049), (1000, 4097)]:
        q = on_card(rng.normal(size=(S, 3)))
        p = on_card(rng.normal(size=(M, 3)) * 2)
        for name, kernel in kernels.items():
            n0 = kernel.launches
            err = max_err_to_plain(kernel, q, p)
            check(kernel.launches == n0 + 1, f"{name}: launch not counted")
            # all fp32 difference form; only the rounding order differs
            check(err <= 1e-5, (name, "vs plain", S, M, err))
    log("[kernel] nn_min_dist, nn_min_dist_scalar == plain at ragged sizes "
        "(max abs err <= 1e-5)")
    for name, seed, res in kernel_checks.check_all():
        log(f"[kernel] {name} vs plain, seed {seed}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", seed, res))
    for name, case, res in fitnmerge_checks.check_all():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    for name, case, res in tri_checks.check_all():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok_to_plain"], (name, "vs plain", case, res))
        if name == "tri_propose exhaustive" and case.startswith("6x120"):
            # a line of more than 64 survivors, and lines of none (the
            # zero-length segment among them)
            check(res["survivors_max"] > 64 and res["lines_without"] > 0,
                  ("seeded exhaustive survivors", res))
    for name, case, res in tri_checks.check_all_vp():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok_to_plain"], (name, "vs plain", case, res))
    n0 = vp_detect.detect.launches
    for case, res in vp_checks.check_all():
        log(f"[kernel] vp_detect vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], ("vp_detect", "vs plain", case, res))
    check(vp_detect.detect.launches == n0 + 4, "vp_detect: launches not "
          "counted")
    t0 = time.perf_counter()
    for name, case, res in lm_checks.check_all():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    log(f"[kernel] lm_line_ba, lm_jointloc seeded cases took "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. card against CPU on a reduced scene ----
    # Endpoint noise (0.3 px) keeps the proposals' scores off the
    # thresholds: noise-free scores sit exactly on fullscore_th = 1.0,
    # where last-ulp differences decide the edge test and so the supports
    small = dict(n_views=16, n_lines=300, n_neighbors=6, noise=0.3,
                 points_per_segment=50, n_samples=100)
    gpu_tracks, gpu_rep, _, _, small_cloud = run_slice("cuda", **small)
    cpu_tracks, cpu_rep, _, _, _ = run_slice("cpu", **small)
    check(len(gpu_tracks) == len(cpu_tracks) > 100,
          ("track count", len(gpu_tracks), len(cpu_tracks)))
    check(sorted(map(key, gpu_tracks)) == sorted(map(key, cpu_tracks)),
          "card and CPU supports differ")
    err, tied = hold_card_to_cpu(gpu_tracks, cpu_tracks)
    for tau in TAUS:
        check(abs(gpu_rep["recall"][tau] - cpu_rep["recall"][tau])
              <= 1e-2 * cpu_rep["recall"][tau] + 1e-3,
              (tau, gpu_rep, cpu_rep))
    log(f"[card-vs-cpu] {len(gpu_tracks)} tracks, identical supports; "
        f"line error {err:.2e} m over {len(gpu_tracks) - len(tied)} "
        f"tracks; {len(tied)} tracks off only through near-tied "
        f"proposals ((line error m, best-score gap) {tied}); "
        f"recall {gpu_rep['recall']}")

    # three inputs built against the filter, from that scene's evaluation
    q = evaluation_queries(gpu_tracks, small["n_samples"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    jitter = [q + 1e-4 * torch.randn(q.shape, device="cuda", generator=gen)
              for _ in range(4)]
    adversarial = {
        "shifted by 1000 m on every axis": (q + 1000.0, small_cloud + 1000.0),
        "cloud holds the queries and duplicates": (
            q, torch.cat([small_cloud, q, q, small_cloud[:1000]])),
        "clusters within 1e-4 m of each query": (
            q, torch.cat([small_cloud] + jitter)),
    }
    for what, (qa, pa) in adversarial.items():
        for name, kernel in kernels.items():
            err = max_err_to_plain(kernel, qa.contiguous(), pa.contiguous())
            check(err <= 1e-5, (name, "vs plain", what, err))
        log(f"[kernel] {tuple(qa.shape)} x {tuple(pa.shape)}, {what}: both "
            f"kernels == plain; {int(nnd.nn_min_dist.confirms)} pairs "
            f"confirmed by nn_min_dist")

    # ---- 3b. the PnPL estimator, card against CPU ----
    localization_card_vs_cpu()

    # ---- 4. the main path at full width ----
    for kernel in kernels.values():
        kernel.launches = 0
    reset_triangulator_launches()
    recorders = triangulator_recorders()
    torch.cuda.reset_peak_memory_stats()
    try:
        tracks, rep, stages, n_queries, cloud = run_slice(
            "cuda", n_views=100, n_lines=1500, n_neighbors=20)
    finally:
        for rec in recorders.values():
            rec.restore()
    main_launches = {name: k.launches for name, k in kernels.items()}
    tri_launches = triangulator_launches()
    tri_recorded = {k: (r.args, r.kwargs) for k, r in recorders.items()}
    log(f"[full] triangulator kernel launches {json.dumps(tri_launches)}")
    for name, n in tri_launches.items():
        check(n > 0, f"the main path did not launch {name}")
    launches = main_launches["nn_min_dist"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[full] stage seconds {json.dumps(stages)}")
    log(f"[full] peak device memory {peak / 2**30:.3f} GiB")
    log(f"[full] n_tracks {len(tracks)}; recall {rep['recall']}; "
        f"precision {rep['precision']}; nn_min_dist launches {launches}")
    check(launches > 0, "the main path did not launch nn_min_dist")
    check(main_launches["nn_min_dist_scalar"] == 0,
          "the main path launched the yardstick kernel")
    check(np.isfinite([x.line for x in tracks]).all(), "non-finite lines")
    ref_n = REFERENCE["n_tracks"]
    check(abs(len(tracks) - ref_n) <= 0.01 * ref_n, (len(tracks), ref_n))
    for tau in TAUS:
        check(rep["recall"][tau] >= 0.99 * REFERENCE["recall"][tau],
              ("recall", tau))
        check(rep["precision"][tau] >= REFERENCE["precision"][tau] - 1.0,
              ("precision", tau))

    # ---- 5. kernels on the main path's whole input ----
    from limap_tpu_torch.evaluation import evaluator as evaluator_module
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    queries = evaluation_queries(tracks, 1000)
    check(queries.shape[0] == n_queries, "query count")
    entries = measure_kernels(kernels, "segments_given", queries, cloud,
                              main_launches)

    # the evaluation stage on either kernel
    lines = np.stack([x.line for x in tracks])
    evaluator = PointCloudEvaluator(cloud.cpu().numpy(), device="cuda")
    evaluate_s = {}
    for name in TURNS:
        evaluator_module.nn_min_dist = kernels[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report_error_to_gt(evaluator, lines, TAUS, 1000)
        torch.cuda.synchronize()
        evaluate_s.setdefault(name, []).append(time.perf_counter() - t0)
    evaluator_module.nn_min_dist = nnd.nn_min_dist
    log(f"[time] evaluate stage seconds by kernel {json.dumps(evaluate_s)}")
    for entry in entries:
        entry["evaluate_stage_s"] = evaluate_s[entry["name"]]
    del queries, cloud, evaluator
    entries += measure_triangulator_kernels("segments_given", tri_recorded,
                                            tri_launches)
    del tri_recorded

    # ---- 6. front end and runner, card against CPU ----
    with tempfile.TemporaryDirectory() as workdir:
        front_end_card_vs_cpu(workdir)

    # ---- 7. the pipeline from pixels at full width ----
    with tempfile.TemporaryDirectory() as workdir:
        for kernel in kernels.values():
            kernel.launches = 0
        reset_triangulator_launches()
        recorders = triangulator_recorders()
        try:
            pixel_queries, pixel_cloud, scene, runner_tracks = \
                from_pixels_full_width(card, workdir)
        finally:
            for rec in recorders.values():
                rec.restore()
        pixel_launches = {name: k.launches for name, k in kernels.items()}
        tri_launches = triangulator_launches()
        tri_recorded = {k: (r.args, r.kwargs) for k, r in recorders.items()}
        log(f"[from-pixels] triangulator kernel launches "
            f"{json.dumps(tri_launches)}")
        for name, n in tri_launches.items():
            check(n > 0, f"the from-pixels path did not launch {name}")
        check(pixel_launches["nn_min_dist"] > 0,
              "the from-pixels path did not launch nn_min_dist")
        check(pixel_launches["nn_min_dist_scalar"] == 0,
              "the from-pixels path launched the yardstick kernel")
        entries += measure_kernels(kernels, "from_pixels", pixel_queries,
                                   pixel_cloud, pixel_launches)
        entries += measure_triangulator_kernels("from_pixels", tri_recorded,
                                                tri_launches)
        del pixel_queries, pixel_cloud, tri_recorded

        # ---- 8. localization at full width on phase 7's map ----
        t0 = time.perf_counter()
        loc_launches, recorded = localization_full_width(
            scene, runner_tracks, workdir, card)
        log(f"[localize] phase 8 took {time.perf_counter() - t0:.1f} s")
        entries += measure_localization_kernels(recorded, loc_launches)
        del recorded

        # ---- 9a. fit and merge, card against CPU ----
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            fitnmerge_card_vs_cpu(small)
        log(f"[fitnmerge card-vs-cpu] phase 9a took "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 9. fit and merge at full width on phase 7's images ----
        t0 = time.perf_counter()
        fnm_launches, recorded = fitnmerge_full_width(
            scene, os.path.join(workdir, "fitnmerge"), card)
        entries += measure_fitnmerge_kernels(recorded, fnm_launches)
        log(f"[fitnmerge] phase 9 took {time.perf_counter() - t0:.1f} s")
        del recorded

        # ---- 10a. the exhaustive matcher, card against CPU ----
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            exhaustive_card_vs_cpu(small)
        log(f"[exhaustive card-vs-cpu] phase 10a took "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 10. the exhaustive matcher at full width ----
        t0 = time.perf_counter()
        for kernel in kernels.values():
            kernel.launches = 0
        recorded, ex_launches, ex_queries, ex_cloud = exhaustive_full_width(
            scene, os.path.join(workdir, "exhaustive"), card)
        nn_launches = {name: k.launches for name, k in kernels.items()}
        check(nn_launches["nn_min_dist"] > 0,
              "the exhaustive path did not launch nn_min_dist")
        check(nn_launches["nn_min_dist_scalar"] == 0,
              "the exhaustive path launched the yardstick kernel")
        entries += measure_kernels(kernels, "exhaustive", ex_queries,
                                   ex_cloud, nn_launches)
        del ex_queries, ex_cloud
        entries += measure_exhaustive_kernels(recorded, ex_launches)
        log(f"[exhaustive] phase 10 took {time.perf_counter() - t0:.1f} s")

    # ---- 11a. the COLMAP path with VPs, card against CPU ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as small:
        colmap_vp_card_vs_cpu(small)
    log(f"[colmap-vp card-vs-cpu] phase 11a took "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 11. the COLMAP entry point with VPs at full width ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        recorded, vp_launches = colmap_vp_full_width(workdir, card)
    entries.append(measure_vp_detect(recorded["vp_detect"],
                                     vp_launches["vp_detect"]))
    entries += measure_triangulator_kernels("colmap_vp", recorded,
                                            vp_launches)
    del recorded
    log(f"[colmap-vp] phase 11 took {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
