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
     polish), with quality gates, the PnPL stages printed; then the four
     localization kernels held to their plain versions and timed on that
     path's own inputs; I (every LO solve, with the first design's team)
     and B (every launch's input) also held bit for bit to their first
     designs (lm_jointloc_scan, trace_roots_scan: the yardsticks, never
     on the path), their device time summed over the path's launches for
     both, I's team choices and the chains' active matches, and each
     timed in turns with its first design.  With ``--save-loc-inputs
     FILE`` the inputs of every LO solve and of every launch of B are
     saved there, for testing/lo_wall.py to time another checkout's
     kernels on them.
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
     their plain versions and timed on that path's whole input; F's
     exhaustive passes (a table launch, then tiles staged in shared
     memory, survivors triangulated warp-dense) also held bit for bit to
     their first design (propose_exhaustive_scan, the yardstick, never on
     the path) and timed in turns with it, the count and the write each
     alone, beside the candidates reaching each cull.
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
 12. refinement and point-line association at full width on phase 11's
     map (its tracks, segments and views): a second COLMAP model of the
     façade with 4,000 points on the GT lines and every point's 2D
     observations, then limap_tpu_torch/testing/pointline.py::run: the
     refinement CLI's path (line_refinement with use_vp: kernel J, then
     K), the refinement with the heatmap and feature-consistency terms
     from GradientFeatureExtractor on the rendered images (kernel K), and
     pointline_association (kernels J, L and M), with quality gates from
     the port's own CPU run and at most 2 tracks taken off their heatmap
     patches, each within 1.5 m of the GT lines; then K, L and M held to
     their plain versions (K also refusing planted faults; the parted
     rows' end distances to plain's lines reported) and timed on the
     path's largest solves.
     Phase 12a, before it, runs that path on the CPU and then on the card
     on a reduced façade (8 views, the CPU's map) and holds the tracks,
     points and VPs card to CPU, the pixel refinement a track at a time.
 13. the GT evaluation of phase 7's card tracks (from the second pass,
     500 samples a track) at full width: MeshEvaluator against the
     scene's wall tessellated on a 4 cm grid (135,000 triangles, inner
     vertices jittered in the plane; kernel N, mesh_min_dist), held to the
     wall's analytic distance and to PointCloudEvaluator on the GT cloud
     on the wall (the mesh is never farther, its recall never lower);
     RefLineEvaluator with the GT lines as reference, held to a float64
     computation; then N held bit for bit to its plain version on the
     whole input and timed in turns beside the plain scan and beside its
     first design (mesh_min_dist_scan, every pair), with the pairs it
     evaluated, the clusters it scanned and the always list's size.
 14. the joint SfM refinement at full width: phase 11's façade (100
     views of 800x600) written as a COLMAP model with 4,000 wall points
     and their 2D observations on poses perturbed by refine_sfm's rule,
     then runners/hypersim/refine_sfm.py::run_refine_sfm through the
     COLMAP branch (a line map from the .npy pixels, then the hybrid
     bundle adjustment of poses, points and lines on kernels O, P and Q,
     hybrid_terms, hybrid_apply and hybrid_cost), gated: both median pose
     errors fall, and they and the track count stay within gates of the
     port's CPU run; the same BA with CG agrees with the dense solve;
     then the line half at a real map's size: the GT-pose line map (212
     tracks; the noisy poses leave 2) through the same BA on the noisy
     poses, dense and CG, gated the same way; O, P and Q held to their
     plain versions on the first steps and timed in turns, with the
     dense solve's time, their launches counted by kind and mode in the
     runs (a product's in the CG runs); O with its index built once a
     solve (the supports' pair lists), its time split (the index build,
     stage 1, stage 2 on the pairs, the first design's stage 2) and O
     timed in turns with its first design (hybrid_terms_scan, the
     yardstick, never on the path, its assembly held to float64 too) as
     that design's path ran it, the supports' grouping built every call,
     and once with the grouping prebuilt; P's back-substitution and CG's
     product of both kinds in one launch (hybrid_apply_both, prepared
     once a solve as the path calls it) held bit for bit to P's first
     design (hybrid_apply_scan, the yardstick, never on the path), split
     into its parts (the launch, stage 1, the barrier, stage 2; the
     wrapper's host time) and timed in turns with it, on the refine
     path's and the GT-pose map's first steps; then the CLIs in process:
     visualsfm_triangulation (the GT model converted by convert_model)
     and bundler_triangulation (a Bundler model) against the direct call
     (cameras read back within 1e-6, the phase-7 gates), and, right after
     phase 8, the localization CLI on phase 8's map and queries (the
     phase-8 pose tolerances).  Phase 14a, before it, runs run_refine_sfm
     on a reduced façade (8 views) on the CPU and then on the card (the
     CPU's segments and matches) and holds the line map, the costs, the
     poses, the points and the lines card to CPU.
 15. the learned front end at full width, from random weights that the
     script writes in the published layouts (superpoint_v1.pth,
     superglue_outdoor.pth, sold2_wireframe.tar) and loads through
     weight_path: SuperPoint and SuperGlue on two of phase 7's views
     (2,048 keypoints each, 18 GNN layers, 100 Sinkhorn iterations on
     kernel R, descriptors on kernel S), card against CPU; the
     from-pixels runner with the weight-free sinkhorn_endpoints matcher
     (one launch of R a pair) on the first 16 views of phase 7's scene,
     with quality gates from the JAX package's run; right after phase 8,
     the localization runner with superglue_endpoints on phase 8's map
     and queries (pose errors logged; descriptors and matches card
     against CPU); SOLD2 detect, describe and Wunsch match on two views
     at 600 x 800 (300 junctions: kernels T and U at full size, line
     descriptors on S), then SOLD2's detector on heatmaps rendered from
     the GT lines' projections into 4 views, its recall gated against
     the JAX package's; then R, S, T and U held to their plain versions
     on those inputs and timed in turns; R (the coupling in shared
     memory in row bands, a CTA an SM, its plan printed) also bit for
     bit on a repeat, split into its parts, and timed in turns with its
     first design (log_sinkhorn_scan, the yardstick, never on the path);
     R's launches on the Sinkhorn runner, the localization and GlueStick
     (phase 16) printed by shape.  Phase 15a, after phase 6, holds
     R, S, T and U to their plain versions on seeded inputs (ragged
     Sinkhorn problems, R's band cases: rows past shared memory, v past
     it, -inf rows, columns and bands, M = 0, N = 0; points at the
     border, ties at detect_thresh,
     integer junctions) and SuperPoint (120 x 160), SuperGlue (64 x 80
     keypoints) and SOLD2 (128 x 128: forward, junctions, T and U on the
     CPU's junctions, line descriptors, Wunsch matches) card to CPU.
 16. the rest of the learned zoo at full width (random weights written
     where the loaders of a weights directory look): DeepLSD's, TP-LSD's
     and HAWPv3's forwards on a view of phase 7's scene, card against
     CPU, then each decoding (TP-LSD's on kernel X) on fields built from
     the projected GT segments of 4 views, recall gated against the JAX
     package's; the from-pixels runner with lbd / lbd (kernel V) and
     with dense_naive / dense_ncc (kernel W) on the first 16 views,
     gated on tracks and precision or matches against the JAX package's
     runs; L2D2 (patches on kernel Y), LineTR and GlueStick (OT on
     kernel R) against a shuffled copy of a view's lines (every match
     the copy), then each in the runner on 4 views (GlueStick with each
     view's nearest neighbour alone), CPU and card on the CPU's
     segments; S2DNet's features at 600 x 800 and phase 12a's
     façade refined with them, card against CPU; the dense runner again
     with W's first design (ncc_argmax_rowscan, a launch a direction) in
     W's place and then with W; then V, W, X and Y held to their plain
     versions on those paths' inputs and timed in turns (W, both
     directions in one pass, in both directions and beside its first
     design and one f1 @ f2.T with both max reductions).
     Phase 16a, before it, holds V, W, X and Y to their plain versions
     on seeded inputs (ties, clipped samples, crops outside the warped
     image) and the zoo's networks at 128 x 128 card to CPU.
 17. the multi-card form (parallel/mesh.py, parallel/distributed.py) on
     the one card: (a) phase 14's hybrid BA, 20 steps, over make_mesh()
     of one NCCL rank in this process, bit-equal to the one-card call;
     (b) two gloo ranks sharing the card (testing/multirank.py, spawned),
     each launching F and G, and O, P and Q, on its block:
     triangulate_all_mesh on phase 4's protocol scene against
     triangulate_all here (node tables, tracks and supports),
     run_distributed_mapping with shard_image_ids and
     all_gather_host_dicts against the one-rank tracks, and phase 14's BA
     with the dense solver and with CG, 20 steps each, against the
     one-card runs (costs rtol 5e-3 with atol 1e-5 of the first, poses
     1e-4 (CG's: or the one-card CG run's own distance from the dense
     solve, where larger), lines 1e-3, the median pose errors inside
     phase 14's gates), both ranks' results identical; each sub-step's
     seconds, a BA step's collectives, their bytes and the share of the
     step spent in them.
Phase 2 also holds kernels O, P and Q to their plain versions on seeded
inputs (lines and points, optimize_focal on and off, each constancy flag,
ragged slots of weight 0, one track, one support), O's matrix within
its float64 recomputation and the same bits on a repeat, and P (each
kind, and both kinds in one launch) bit for bit to its first design.
Phase 2 also holds kernel N (mesh_min_dist) bit for bit to its plain
version on seeded inputs (degenerate triangles, points in each of a
triangle's seven regions, ragged sizes), its counts to the cull's replay
in torch (ops/mesh_distance.py::mesh_min_dist_culled), and its first
design (mesh_min_dist_scan) to the plain version.
Phase 2 also holds the triangulator's kernels (tri_propose, F, in both
input forms and with the VP banks, and tri_score, G) and the VP
detector (vp_detect, J) to their plain versions on seeded inputs, and
F's exhaustive passes bit for bit to their first design
(propose_exhaustive_scan: counts, words, rows and ok, with endpoint
triangulation, ranges and neighbours of -1);
phases 4 and 7 hold F and G to them on their paths' whole inputs; phase
10a, before phase 10, runs the exhaustive runner on the card and on the
CPU on a reduced rendered scene (the same segments) and requires the same
tracks and supports.
Phase 2 also holds the localization kernels (trace_roots, pose_score,
epipolar_iou_grid), the fit-and-merge kernels (line_ransac,
linker_edges) and the LM kernels (lm_line_ba, H; lm_jointloc, I, under
every cost function, weight and loss; lm_line_refine, K, with each term
alone and all four; lm_assoc_lines, L, with and without VPs;
lm_assoc_points, M, with empty, seeded and full association slots) to
their plain versions on seeded inputs; phases 4, 7 and 10 hold H to its plain version on their paths'
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

import argparse
import collections
import copy
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
    runner's tracks (phase 8's map) and the second pass's lines (phase
    13's map)."""
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
            scene, runner_tracks, lines)


# FP32 operations per unit of work of the localization kernels, counted
# from their formulas (a multiply-add as two, a sqrt, divide, sin, cos or
# atan2 as one): pose_score a point 47 and a line 124 per pose; the root
# function G 280 per evaluation, (n_grid + 1) + 3 n_roots n_bisect +
# 3 n_roots evaluations per instance; the IoU 46 per pair.
OPS_POINT, OPS_LINE, OPS_G, OPS_PAIR = 47, 124, 280, 46


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# the card's SMs and highest SM clock (set by main), for kernel R's bound:
# its exps at 16 a clock an SM
SMS, SM_CLOCK_HZ = 0, 0.0


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
    (by ``size``), so the path's own inputs can be measured afterwards;
    with ``keep_all`` every call's (``calls``)."""

    def __init__(self, module, name, size, keep_all=False):
        self.module, self.name, self.size = module, name, size
        self.orig = getattr(module, name)
        self.args, self.kwargs, self.best = None, None, -1
        self.calls = [] if keep_all else None

        def wrapper(*args, **kwargs):
            n = size(*args, **kwargs)
            if n > self.best:
                self.args, self.kwargs, self.best = args, kwargs, n
            if self.calls is not None:
                self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


class ShapeCounter:
    """Wraps ``module.name`` (a call of kernel R) to count its calls on
    the card by the coupling's shape and iterations."""

    def __init__(self, module, name, counts):
        self.module, self.name = module, name
        self.orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            if args[0].is_cuda:
                M, N = args[0].shape
                iters = args[2] if len(args) > 2 else kwargs.get("iters", 50)
                counts[(M, N, iters)] += 1
            return self.orig(*args, **kwargs)

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def log_r_shapes(what, counts):
    """Kernel R's launches on a path by shape, with each shape's CTAs and
    rows a band."""
    from limap_tpu_torch.ops import log_sinkhorn as R
    rows = []
    for (M, N, iters), n in sorted(counts.items()):
        plan = R.plan(M, N)
        rows.append({"coupling": f"{M + 1}x{N + 1}", "iters": iters,
                     "launches": n, "ctas": plan["ctas"],
                     "rows_a_band": plan["rows_a_band"]})
    log(f"[kernel] log_sinkhorn on {what}: {sum(counts.values())} launches; "
        f"by shape {json.dumps(rows)}")


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
                                lambda *a, **k: a[0].shape[0],
                                keep_all=True),
        "epipolar_iou_grid": Recorder(runner, "epipolar_iou_grid",
                                      lambda *a, **k: a[0].shape[0]
                                      * a[1].shape[0]),
    }
    kernels = {"pose_score": pose_score.pose_score,
               "trace_roots": trace_roots.trace_roots,
               "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid,
               "lm_jointloc": lm_jointloc.solve}
    for k in list(kernels.values()) + [lm_jointloc.solve_scan,
                                       trace_roots.trace_roots_scan]:
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
    check(lm_jointloc.solve_scan.launches == 0
          and trace_roots.trace_roots_scan.launches == 0,
          "the localization path launched a first design")
    log(f"[localize] PnPL stages summed over the {len(poses)} queries: "
        f"pnpl_sample_solve {prof.times.get('pnpl_sample_solve', 0.0):.4f} "
        f"s (kernel B's {launches['trace_roots']} launches), pnpl_lo_polish "
        f"{prof.times.get('pnpl_lo_polish', 0.0):.4f} s (kernel I's "
        f"{launches['lm_jointloc']} solves) on {card}")

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
                          lm_jointloc=lo_calls,
                          trace_roots_calls=recorders["trace_roots"].calls), \
        {"q": q, "cfg": cfg, "poses": poses}


# The kernel twice around one plain run: the plain versions run 10-10^4x
# longer than the kernels (phase 10's exhaustive F ~35 s a run), so a
# second plain turn and its warm-up would buy no resolution and cost the
# script's time limit; the plain version has run just before, in the
# comparison, and needs no warm-up.
LOC_TURNS = ("kernel", "plain", "kernel")


def timed_entry(name, path, source, replaces, launches, kernel, plain, args,
                kwargs, err, bound_ms, bound_by, shape, reps, plain_ms=None):
    """A kernel's entry of the kernels line: the kernel and its plain
    version timed in turns (LOC_TURNS; ``reps`` = (kernel runs, plain
    runs) a turn) on the input it was held to the plain version on; with
    ``plain_ms`` the plain version's time is that of the run it was held
    to (one run, CUDA events), and only the kernel's turns run here."""
    times = {"kernel": [], "plain": [] if plain_ms is None else [plain_ms]}
    for which in LOC_TURNS:
        if which == "plain" and plain_ms is not None:
            continue
        fn = kernel if which == "kernel" else plain
        n = reps[0] if which == "kernel" else reps[1]
        times[which].append(cuda_ms(lambda: fn(*args, **kwargs), n,
                                    warmup=which == "kernel"))
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
    held to the plain version, timed against it in turns, and its bound;
    I and B also held to their first designs and timed with them."""
    from limap_tpu_torch.ops import epipolar_iou, pose_score
    from limap_tpu_torch.testing import kernel_checks
    plain = {"pose_score": pose_score.pose_score_plain,
             "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid_plain}
    kernel = {"pose_score": pose_score.pose_score,
              "epipolar_iou_grid": epipolar_iou.epipolar_iou_grid}
    source = {"pose_score": ("pose_score.cu",
                             "limap_tpu/estimators/absolute_pose.py:70"),
              "epipolar_iou_grid": (
                  "epipolar_iou.cu",
                  "limap_tpu/triangulation/functions.py:149")}
    entries = measure_jointloc(recorded.pop("lm_jointloc"),
                               launches["lm_jointloc"])
    entries += measure_trace_roots(recorded.pop("trace_roots"),
                                   recorded.pop("trace_roots_calls"),
                                   launches["trace_roots"])
    for name, (args, kwargs) in recorded.items():
        out_k = kernel[name](*args, **kwargs)
        out_p = plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        if name == "pose_score":
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


def measure_trace_roots(largest, calls, launches):
    """Kernel B on the path's inputs: every launch's input held to the
    first design (trace_roots_scan) bit for bit, the device time of all
    launches summed for both, the largest input held to plain, and the
    kernel and the first design timed in turns there (the plan sweep is
    testing/loc_kernels.py's)."""
    from limap_tpu_torch.ops import trace_roots as B
    from limap_tpu_torch.testing import kernel_checks, loc_kernels
    args, kwargs = largest
    check(args is not None and calls, "the localization path gave kernel "
          "B no input")
    n_bisect = args[5] if len(args) > 5 else kwargs.get("n_bisect", 48)
    n_roots = args[6] if len(args) > 6 else kwargs.get("n_roots", 8)
    bits = {"launches": len(calls), "instances": 0, "slots_differing": 0,
            "ok_differing": 0}
    totals = {"kernel": 0.0, "first design": 0.0}
    for a, k in calls:
        res = loc_kernels.trace_roots_bits(
            list(a[:5]), a[5] if len(a) > 5 else k.get("n_bisect", 48),
            a[6] if len(a) > 6 else k.get("n_roots", 8))
        bits["instances"] += res["instances"]
        bits["slots_differing"] += res["slots_differing"]
        bits["ok_differing"] += int(not res["ok_equal"])
        totals["kernel"] += loc_kernels.cuda_ms(
            lambda: B.trace_roots(*a, **k), 3)
        totals["first design"] += loc_kernels.cuda_ms(
            lambda: B.trace_roots_scan(*a, **k), 2)
    bits["ok"] = bits["slots_differing"] == 0 and bits["ok_differing"] == 0
    log(f"[kernel] localization trace_roots against its first design, bit "
        f"for bit, on every launch's input: {json.dumps(bits)}; device ms "
        f"summed over the {len(calls)} launches (CUDA events; the first "
        f"design is rebuilt on the shared __noinline__ G): "
        f"{json.dumps(totals)}")
    check(bits["ok"], ("trace_roots against its first design", bits))
    plan = B.plan(n_roots, n_bisect)
    out_k = B.trace_roots(*args, **kwargs)
    out_s = B.trace_roots_scan(*args, **kwargs)
    out_p = B.trace_roots_plain(*args[:5], n_bisect, n_roots)
    deficient = kernel_checks.rank_deficient(*args[:5])
    res = kernel_checks.compare_trace_roots(out_k, out_p, n_roots, deficient,
                                            list(args[:5]))
    res_s = kernel_checks.compare_trace_roots(out_s, out_p, n_roots,
                                              deficient, list(args[:5]))
    log(f"[kernel] localization trace_roots against plain on the path's "
        f"input: {json.dumps(res)}")
    check(res["ok"], ("trace_roots", "on the path's input", res))
    Bn, K = args[0].shape[0], args[4].shape[0]
    evals = K + 3 * n_roots * n_bisect + 3 * n_roots
    bms, by = bound(Bn * evals * OPS_G,
                    Bn * 96 + K * 4 + Bn * 2 * n_roots * 37)
    shape = {"instances": Bn, "grid": K - 1, "n_roots": n_roots,
             "plan": plan, "launches_summed_ms": totals, "bits": bits}
    return yard_entries(
        "trace_roots", "trace_roots_scan", "localization", "trace_roots.cu",
        "limap_tpu/estimators/pnl_solvers.py:142", launches,
        lambda: B.trace_roots(*args, **kwargs),
        lambda: B.trace_roots_scan(*args, **kwargs),
        lambda: B.trace_roots_plain(*args[:5], n_bisect, n_roots),
        res["max_abs_err"], res_s["max_abs_err"], bms, by, shape, 20,
        "the first design, a thread an instance (rebuilt on the shared "
        "__noinline__ G); the yardstick, never on the path")


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


def parted_end(res):
    """How far the parted rows of a line kernel end from plain's lines,
    in metres (testing/lm_checks.py::line_end_distance)."""
    return {k: res[k] for k in ("parted_end_dist_max_m",
                                "parted_end_dist_median_m") if k in res}


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
             "parted_rows": res["parted"], **parted_end(res),
             "normal_equations_max_rel_err": res_ne["max_rel_err"]}
    return timed_entry(
        "lm_line_ba", path, H_SOURCE, LM_REPLACES, launches,
        lambda: lm_line_ba.solve(*args, **kwargs),
        lambda: lm_line_ba.solve_plain(params0, aux, cfg, n_iter), (), {},
        res["max_abs_err"], bms, by, shape, (5, 1))


def jointloc_call(call):
    """(params0, data, cfg, n_iter) of a recorded lm_jointloc.solve call."""
    args, kwargs = call
    n_iter = args[11] if len(args) > 11 else kwargs.get("num_iterations", 50)
    return args[0], tuple(args[1:10]), args[10], n_iter


def active_spread(calls):
    """Quantiles (0, 10, 50, 90, 100 %) of the active lines, points and
    matches of every chain of the recorded solves."""
    lines = torch.cat([c[0][5].sum(1) for c in calls]).cpu().numpy()
    points = torch.cat([c[0][8].sum(1) for c in calls]).cpu().numpy()
    q = (0, 10, 50, 90, 100)
    return {"chains": int(len(lines)),
            **{k: [int(x) for x in np.percentile(v, q, method="nearest")]
               for k, v in (("lines", lines), ("points", points),
                            ("matches", lines + points))}}


def measure_jointloc(calls, launches):
    """Kernel I on every LO solve of phase 8: the solves of a query share
    their matches and config, so their rows go to plain together (rows
    are independent); the normal equations at the start and the solve
    held to plain row by row; every solve also with the first design's
    team bit for bit against the first design (lm_jointloc_scan); the
    device time of every solve summed for both; the team choices and the
    chains' active matches; the largest solve timed in turns with the
    first design, with its bound (the splits of an iteration are
    testing/loc_kernels.py's)."""
    from limap_tpu_torch.ops import lm_jointloc as I
    from limap_tpu_torch.testing import lm_checks, loc_kernels
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
    largest = max(calls, key=lambda c: c[0][0].shape[0]
                  * (c[0][1].shape[0] + c[0][6].shape[0]))
    scan_err = None
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
        if any(a is largest[0] for a in group):
            # the first design's error to plain, on the largest's group
            _, res_s = lm_checks.check_jointloc(params0, tuple(data), cfg,
                                                n_iter, solve=I.solve_scan)
            check(res_s["ok"], ("lm_jointloc_scan", res_s))
            scan_err = res_s["max_abs_err"]
    log(f"[kernel] localization lm_jointloc against plain on every LO solve, "
        f"row by row: {json.dumps(totals)}; max abs err {err:.3e}; normal "
        f"equations max rel err {ne_err:.3e}; the first design on the "
        f"largest solve's group {scan_err:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    # bit for bit with the first design's team; the device time of every
    # solve for both (the card alone: the host work prepared once)
    bits = {"solves": len(calls), "rows": 0, "rows_differing": 0,
            "solves_differing": 0}
    summed = {"kernel": 0.0, "first design": 0.0}
    teams = collections.Counter()
    for call in calls:
        params0, data, cfg, n_iter = jointloc_call(call)
        res = loc_kernels.jointloc_bits(params0, data, cfg, n_iter)
        bits["rows"] += res["rows"]
        bits["rows_differing"] += res["rows_differing"]
        bits["solves_differing"] += int(not res["ok"])
        _, team, go = I.prepared(params0, data, cfg, n_iter)
        summed["kernel"] += loc_kernels.cuda_ms(go, 3)
        teams.update(team["chain_warps"].tolist())
        summed["first design"] += loc_kernels.cuda_ms(
            I.prepared(params0, data, cfg, n_iter, scan=True)[2], 3)
    bits["ok"] = bits["solves_differing"] == 0
    spread = active_spread(calls)
    log(f"[kernel] localization lm_jointloc with the first design's team "
        f"{list(I.FIRST_DESIGN_TEAM)} against the first design, bit for bit "
        f"(trace, params, costs, accepts): {json.dumps(bits)}")
    log(f"[kernel] localization lm_jointloc team choices (warps: chains) "
        f"{json.dumps(dict(sorted(teams.items())))}; the chains' active "
        f"matches (quantiles 0/10/50/90/100 %) {json.dumps(spread)}; device "
        f"ms summed over the {len(calls)} solves (CUDA events, the host "
        f"work prepared once; the first design is rebuilt "
        f"without contraction) {json.dumps(summed)}")
    check(bits["ok"], ("lm_jointloc against its first design", bits))
    args, kwargs = largest
    params0, data, cfg, n_iter = jointloc_call(largest)
    T, nl, npt = params0.shape[0], data[0].shape[0], data[5].shape[0]
    ops = lm_checks.ops_jointloc(cfg, int(data[4].sum()), int(data[7].sum()),
                                 T, n_iter)
    bms, by = bound(ops, lm_checks.bytes_jointloc(T, nl, npt))
    shape = {"rows": T, "lines": nl, "points": npt, "iterations": n_iter,
             "operations": ops, "config": [cfg.cost_function,
                                           cfg.cost_function_weight,
                                           cfg.loss], **totals,
             "normal_equations_max_rel_err": ne_err,
             "team_warps": I.chain_warps(data[4], data[7]),
             "teams": dict(teams),
             "active": spread, "launches_summed_ms": summed, "bits": bits,
             "device_ms": {
                 "kernel": loc_kernels.cuda_ms(
                     I.prepared(params0, data, cfg, n_iter)[2], 10),
                 "first design": loc_kernels.cuda_ms(
                     I.prepared(params0, data, cfg, n_iter, scan=True)[2],
                     10)},
             "ms_are": "a call of the wrapper, as the path makes it"}
    return yard_entries(
        "lm_jointloc", "lm_jointloc_scan", "localization", I_SOURCE,
        LM_REPLACES, launches, lambda: I.solve(*args, **kwargs),
        lambda: I.solve_scan(*args, **kwargs),
        lambda: I.solve_plain(params0, data, cfg, n_iter), err, scan_err,
        bms, by, shape, 10,
        "the first design, a block of 256 threads a chain, two passes and "
        "two block sums an iteration over every match (rebuilt "
        "without contraction); the yardstick, never on the path")


# F's exhaustive passes and their first design in turns
EXHAUSTIVE_TURNS = ("scan", "kernel", "kernel", "scan")


def events_ms(fn):
    """(fn's result, its ms by CUDA events) of one run, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def measure_exhaustive_kernels(recorded, launches, path_launches):
    """Kernels F (form b: its tables, the count and the write, timed
    together) and G on the exhaustive path's whole inputs; F also bit for
    bit against its first design (propose_exhaustive_scan), the two timed
    in turns and each pass alone.  ``path_launches``: the path's launches
    of F's table kernel and of the yardstick."""
    from limap_tpu_torch.ops import tri_propose
    from limap_tpu_torch.testing import tri_checks
    cargs, _ = recorded["count_exhaustive"]
    wargs, _ = recorded["propose_exhaustive"]
    check(cargs is not None and wargs is not None,
          "the exhaustive path gave kernel F no input")
    cfg, L, K, l2d, cam, meta, ranges = cargs[:7]
    W = wargs[6]
    check(wargs[5].shape == meta.shape,
          ("the exhaustive path split its images into groups", W))
    tables = tri_propose.exhaustive_tables(L, l2d, cam)
    slot_counts = tri_propose.count_exhaustive(*cargs[:7], per_slot=True,
                                               tables=tables)
    counts_k = tri_propose.slot_offsets(slot_counts)[1]
    out_k = tri_propose.propose_exhaustive(*cargs[:6], W, ranges,
                                           slot_counts=slot_counts,
                                           tables=tables)
    # the plain version's one run, held to and timed (30 s at full width)
    (counts_p, out_p), plain_ms = events_ms(lambda: (
        tri_propose.count_exhaustive_plain(*cargs[:7]),
        tri_propose.propose_exhaustive_plain(*cargs[:6], W, ranges)))
    res = tri_checks.compare_exhaustive(*cargs[:6], counts_k, counts_p,
                                        out_k, out_p, ranges)
    log(f"[kernel] exhaustive tri_propose against plain on the path's whole "
        f"input: {json.dumps(res)}")
    check(res["ok_to_plain"], ("tri_propose exhaustive", res))
    del out_p
    same = tri_checks.compare_to_scan(*cargs[:7])
    log(f"[kernel] exhaustive tri_propose against its first design on the "
        f"path's whole input: {json.dumps(same)}")
    check(same["bit_equal"] and same["width"] == W,
          ("tri_propose exhaustive vs scan", same))
    work = tri_checks.exhaustive_work(*cargs[:6], counts_k, ranges)
    ops = tri_checks.operations(work, tri_checks.ops_f(cfg))
    N = counts_k.shape[0]
    bms, by = bound(ops, l2d.numel() * 4 + cam.numel() * 4
                    + meta.numel() * 4 + N * 4
                    + int(counts_k.sum()) * (ROW_BYTES_F + 4))
    log(f"[kernel] exhaustive tri_propose: candidates reaching each stage "
        f"{json.dumps(work)}; {ops} operations")

    def kernel():
        tb = tri_propose.exhaustive_tables(L, l2d, cam)
        sc = tri_propose.count_exhaustive(*cargs[:7], per_slot=True,
                                          tables=tb)
        return sc, tri_propose.propose_exhaustive(
            *cargs[:6], W, ranges, slot_counts=sc, tables=tb)

    def scan():
        return (tri_propose.count_exhaustive_scan(*cargs[:7]),
                tri_propose.propose_exhaustive_scan(*cargs[:6], W, ranges))

    fns = {"kernel": kernel, "scan": scan,
           "tables": lambda: tri_propose.exhaustive_tables(L, l2d, cam),
           "count": lambda: tri_propose.count_exhaustive(
               *cargs[:7], per_slot=True, tables=tables),
           "write": lambda: tri_propose.propose_exhaustive(
               *cargs[:6], W, ranges, slot_counts=slot_counts, tables=tables),
           "count_scan": lambda: tri_propose.count_exhaustive_scan(
               *cargs[:7]),
           "write_scan": lambda: tri_propose.propose_exhaustive_scan(
               *cargs[:6], W, ranges)}
    yard = {k: [] for k in fns}
    for which in EXHAUSTIVE_TURNS + ("tables", "count", "write",
                                     "count_scan", "write_scan"):
        yard[which].append(cuda_ms(fns[which], 3))
    log(f"[kernel] exhaustive tri_propose in turns with its first design, "
        f"then each pass alone (ms): {json.dumps(yard)}")
    shape = {"lines": N, "width": W, "neighbours": K,
             "survivors_max": res["survivors_max"], "operations": ops,
             "table_launches": path_launches["exhaustive_tables"],
             "bit_equal_to_scan": same["bit_equal"],
             "ms_turns_with_scan": yard["kernel"],
             "scan_ms": float(np.mean(yard["scan"])),
             "scan_ms_turns": yard["scan"],
             "tables_ms": yard["tables"][0],
             "count_ms": yard["count"][0], "write_ms": yard["write"][0],
             "count_scan_ms": yard["count_scan"][0],
             "write_scan_ms": yard["write_scan"][0], **work}
    entry = timed_entry("tri_propose", "exhaustive", F_SOURCE, F_REPLACES,
                        launches["tri_propose"], kernel, None, (), {},
                        res["max_abs_err"], bms, by, shape, (3, 1),
                        plain_ms=plain_ms)
    # the first design, a yardstick the path never launches
    yardstick = dict(entry, name="propose_exhaustive_scan",
                     launches=path_launches["propose_exhaustive_scan"],
                     ms=shape["scan_ms"], ms_turns=yard["scan"],
                     role="yardstick: F's first design, bit-equal to its "
                          "exhaustive passes")
    entries = [entry, yardstick]
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

    from limap_tpu_torch.ops import tri_propose

    imagecols, _, nbrs, gt = scene
    cfg = pipeline.exhaustive_runner_config(workdir,
                                            n_neighbors=len(nbrs[0]))
    reset_triangulator_launches()
    tri_propose.propose_exhaustive_scan.launches = 0
    tri_propose.exhaustive_tables.launches = 0
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
    path_launches = {
        "exhaustive_tables": tri_propose.exhaustive_tables.launches,
        "propose_exhaustive_scan": tri_propose.propose_exhaustive_scan.launches}
    check(path_launches["propose_exhaustive_scan"] == 0,
          "the exhaustive path launched the yardstick propose_exhaustive_scan")
    # one table launch serves both passes
    check(path_launches["exhaustive_tables"] == 1,
          ("F's table launches on the exhaustive path", path_launches))
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
        f"{json.dumps(launches)}, {json.dumps(path_launches)}; peak device "
        f"memory "
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
    return (recorded, launches, path_launches,
            evaluation_queries(tracks, 1000), evaluator.points)


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
    recorded inputs of J, F, G and H, their launches, and the map
    (tracks, views, segments, GT) for phase 12."""
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
    return recorded, launches, (tracks, imagecols, segs, gt)


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


K_SOURCE, KLM_SOURCE = "lm_line_refine.cu", "lm_assoc.cu"
K_REPLACES = "limap_tpu/optimize/line_refinement.py:406"
L_REPLACES = "limap_tpu/optimize/global_pl_association.py:249"
M_REPLACES = "limap_tpu/optimize/global_pl_association.py:260"

# Card against CPU on refinement and association (phase 12a), the same
# map, points and segments: LM accept tests flip under rounding once a
# cost is flat (as LINE_TOL), lines and points within 1 cm at ~10 m.  The
# pixel refinement is held a track at a time: its heatmaps and features
# are computed on each device, so their inputs differ by rounding; a
# track whose pixel solve took the same accepts on both devices within
# 1 cm and its final cost within PL_PIXEL_COST_RTOL, one whose accepts
# part (a valid float32 run elsewhere, each parting witnessed by phases 2
# and 12 on one input) counted and reported.  The first costs of all
# rows within PL_PIXEL_COST_RTOL of their sum (a heatmap term off by 5 %
# moves it by 4 % on this scene), the accepted steps within
# PL_PIXEL_ACCEPT_SHARE of the CPU's (a solve that refines nothing
# accepts none), the tracks taken off their patches within one.  The VPs
# within 1e-3 (up to sign): each is a float64 principal direction of the
# refined lines.
PL_LINE_TOL = 1e-2
PL_PIXEL_COST_RTOL = 1e-3
PL_PIXEL_ACCEPT_SHARE = 0.2
PL_VP_TOL = 1e-3
# A track that the pixel refinement takes off its heatmap patches is held
# by the robust geometric term alone: at most this many on phase 12, and
# each at most PL_LEFT_PATCHES_DIST_MAX_M from the GT lines.  The pixel
# solve of phase 12's input, run again in float64 by the plain version
# (testing/pointline.py::float64_ends), ends its one such track 0.8776 m
# from the GT lines, where the card ends it (0.8775 m); on the port's CPU
# input float64 ends its two at 0.0814 m and 4.4 mm, where the CPU's
# float32 run took the second 685.6 m away (mean distance 2.52 m).  The
# bound allows 1.7x the float64 end and refuses a float32 run-away.
PL_LEFT_PATCHES_MAX = 2
PL_LEFT_PATCHES_DIST_MAX_M = 1.5


# The PORT's CPU run of phase 12's path on its own CPU map of the façade
# (tests/torch_port_reference_gates.py --pointline 100; the path 36.6 s
# on the CPU).  JAX's refinement and association on the same map, the
# port's VPs replayed, beside it: refined median 0.03110 m, recall
# 167.27 m; associated median 0.01918 m, recall 179.76 m, precision
# 96.15 %; 2 VPs 73.8 deg apart (its undamped VP step, ROADMAP.md
# section 3).
REFERENCE_POINTLINE = {
 "input": {
  "n_tracks": 281,
  "dist_median_m": 0.031098112654651625,
  "recall_0.05": 167.1927736518379,
  "precision_0.05": 87.98076923076923
 },
 "refined": {
  "dist_median_m": 0.031097383283018042,
  "recall_0.05": 167.27412728005964,
  "precision_0.05": 87.98076923076923
 },
 "refined_px": {
  "dist_median_m": 0.03295057736742667,
  "recall_0.05": 163.75290340092727,
  "precision_0.05": 89.90384615384616
 },
 "associated": {
  "dist_median_m": 0.017578657222371417,
  "recall_0.05": 181.12525474803806,
  "precision_0.05": 94.71153846153845
 },
 "points": {
  "line_points_dist_after_m": 0.006270109939334213
 },
 "associations": {
  "hard": 3238
 },
 "vps": {
  "n_vps": 2,
  "worst_orthogonal_deg": 0.2911773784111489
 }
}
# (section, key, "relative" share or an absolute slack in the key's unit):
# the map under phase 12 is the card's phase-11 map, itself within phase
# 11's gates of the CPU's (2 % of the tracks, 3 % of the recall, 2.5
# points of precision), so these allow as much, 5 mm on the median
# distances, 3 mm on the line points, and a little more for the pixel
# terms' flat valleys.
POINTLINE_GATES = (
    ("input", "n_tracks", "relative", 0.02),
    ("refined", "recall_0.05", "relative", 0.03),
    ("refined", "precision_0.05", "points", 2.5),
    ("refined", "dist_median_m", "m", 0.005),
    ("refined_px", "recall_0.05", "relative", 0.05),
    ("refined_px", "precision_0.05", "points", 3.0),
    ("refined_px", "dist_median_m", "m", 0.005),
    ("associated", "recall_0.05", "relative", 0.03),
    ("associated", "precision_0.05", "points", 2.5),
    ("associated", "dist_median_m", "m", 0.005),
    ("points", "line_points_dist_after_m", "m", 0.003),
    ("associations", "hard", "relative", 0.05),
    ("vps", "n_vps", "count", 0),
    ("vps", "worst_orthogonal_deg", "deg", 0.5),
)


def hold_pointline_gates(summ):
    for section, name, unit, slack in POINTLINE_GATES:
        got = summ[section][name]
        ref = REFERENCE_POINTLINE[section][name]
        margin = ref * slack if unit == "relative" else slack
        log(f"[pointline] gate {section}.{name}: {got:.4f} against the "
            f"reference's {ref:.4f} ({unit} {slack})")
        check(abs(got - ref) <= margin,
              ("pointline", "gate", section, name, got, ref))


def track_line_error(a, b):
    """Largest endpoint difference of two track lists of the same order."""
    check(len(a) == len(b), ("track counts", len(a), len(b)))
    if not a:
        return 0.0
    return float(np.abs(np.stack([t.line for t in a])
                        - np.stack([t.line for t in b])).max())


def pointline_card_vs_cpu(workdir):
    """Phase 12a: the refinement and association path on the CPU and then
    on the card with the same inputs, on a reduced façade (8 views of
    240x320, 120 GT lines, the CPU's map, 800 points on the GT lines)."""
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline, pointline
    from limap_tpu_torch.util import io as limapio
    small = dict(n_views=8, hw=(240, 320), n_points=400)
    model, image_dir, gt = pipeline.write_colmap_scene(workdir, **small)
    cfg = pipeline.colmap_vp_config(os.path.join(workdir, "map"))
    cols = ReadInfos(model, image_dir)
    tracks = line_triangulation(cfg, cols, points3d=ReadPointTracks(model),
                                device="cpu")
    segs = limapio.read_all_segments_from_folder(os.path.join(
        workdir, "map", "line_detections", "tpu_lsd", "segments"))
    model2, _, _ = pipeline.write_colmap_scene(
        os.path.join(workdir, "points"), n_line_points=800, **small)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = pointline.run(tracks, cols, segs, model2, gt,
                                 os.path.join(workdir, dev), dev,
                                 n_wall_points=400)
    (c, sc), (g, sg) = out["cpu"], out["cuda"]
    err = {k: track_line_error(g[k], c[k])
           for k in ("refined", "associated")}
    err["points"] = float(np.abs(g["points"] - c["points"]).max())
    err["vps"] = vp_direction_error(np.asarray(g["vps"]),
                                    np.asarray(c["vps"]))
    log(f"[pointline card-vs-cpu] {len(tracks)} tracks, "
        f"{len(c['points'])} points, {len(c['vps'])} VPs; card against "
        f"CPU: {json.dumps(err)}; hard associations "
        f"{sg['associations']['hard']} / {sc['associations']['hard']}; "
        f"CPU summary {json.dumps(sc)}")
    check(len(tracks) >= 8 and len(c["vps"]) >= 1,
          ("reduced façade map", len(tracks), len(c["vps"])))
    check(len(g["vps"]) == len(c["vps"]), "VP counts card vs CPU")
    check(err["refined"] <= PL_LINE_TOL, ("refined lines", err))
    check(err["associated"] <= PL_LINE_TOL, ("associated lines", err))
    check(err["points"] <= PL_LINE_TOL, ("associated points", err))
    pixel_card_vs_cpu(c, g, sc["refined_px"], sg["refined_px"])
    check(err["vps"] <= PL_VP_TOL, ("VPs", err))
    check(abs(sg["associations"]["hard"] - sc["associations"]["hard"])
          <= 0.01 * sc["associations"]["hard"] + 1, "hard associations")


def pixel_card_vs_cpu(c, g, sc, sg):
    """Phase 12a's pixel refinement, card against CPU a track at a time:
    each device's solve run again with its trace on its own input."""
    from limap_tpu_torch.ops import lm_line_refine
    from limap_tpu_torch.testing import lm_checks
    runs = []
    for out in (c, g):
        params0, data, terms = out["pixel_solve"]
        res, tr = lm_line_refine.solve(params0, data, terms, trace=True)
        runs.append((res.cost.double().cpu(),
                     lm_checks.accepts(tr.detach().cpu())))
    (cost_c, acc_c), (cost_g, acc_g) = runs
    n = len(c["refined_px"])
    check(n == len(g["refined_px"]), "pixel refinement track counts")
    same = (acc_c == acc_g).all(1)[:n].numpy()
    line_err = np.array([np.abs(np.asarray(a.line) - np.asarray(b.line))
                         .max() for a, b in zip(c["refined_px"],
                                                g["refined_px"])])
    cost_err = ((cost_g - cost_c).abs() / torch.clamp(cost_c.abs(), min=1e-6)
                ).numpy()[:n]
    rel0 = abs(sg["pixel_cost0"] - sc["pixel_cost0"]) / sc["pixel_cost0"]
    rep = {"tracks": n, "same_accepts": int(same.sum()),
           "same_max_line_err_m": float(line_err[same].max(initial=0.0)),
           "same_max_cost_rel_err": float(cost_err[same].max(initial=0.0)),
           "parted": int((~same).sum()),
           "parted_max_line_err_m": float(line_err[~same].max(initial=0.0)),
           "cost0_rel_err": rel0, "accepted": [sg["n_accepted"],
                                               sc["n_accepted"]],
           "left_patches": [sg["n_left_patches"], sc["n_left_patches"]]}
    log(f"[pointline card-vs-cpu] pixel refinement a track at a time, "
        f"card against CPU: {json.dumps(rep)}")
    check(same.any(), ("pixel refinement: no track kept its accepts", rep))
    check(rep["same_max_line_err_m"] <= PL_LINE_TOL, ("pixel lines", rep))
    check(rep["same_max_cost_rel_err"] <= PL_PIXEL_COST_RTOL,
          ("pixel costs", rep))
    check(rel0 <= PL_PIXEL_COST_RTOL, ("pixel first costs", rep))
    check(abs(sg["n_accepted"] - sc["n_accepted"])
          <= PL_PIXEL_ACCEPT_SHARE * sc["n_accepted"], ("pixel accepts", rep))
    check(abs(sg["n_left_patches"] - sc["n_left_patches"]) <= 1,
          ("tracks off their patches", rep))


def klm_recorders():
    """Recorders of K's, L's and M's largest calls (by rows x items)."""
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine

    def k_size(p, d, terms, *a, **kw):
        n = d.weights.shape[1] * (1 + d.hm_patch.shape[2]
                                  * terms.use_heatmap)
        return p.shape[0] * (n + d.fc_w.shape[1] * terms.use_fconsis
                             * d.fc_ref_patch.shape[-1])

    return {"lm_line_refine": Recorder(lm_line_refine, "solve", k_size),
            "lm_assoc_lines": Recorder(
                lm_assoc, "solve_lines", lambda p, d, *a, **k: p.shape[0]
                * (d.weights.shape[1] + 2 * d.pt_w.shape[1])),
            "lm_assoc_points": Recorder(
                lm_assoc, "solve_points", lambda p, d, *a, **k: p.shape[0]
                * (d.mask.shape[1] + d.ln_w.shape[1]))}


def klm_launches():
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine
    return {"lm_line_refine": lm_line_refine.solve.launches,
            "lm_assoc_lines": lm_assoc.solve_lines.launches,
            "lm_assoc_points": lm_assoc.solve_points.launches}


def pointline_full_width(workdir, tracks, imagecols, segs, gt, card):
    """Phase 12: refinement and association on phase 11's map on the
    card, gated against the port's CPU run.  Returns the recorded inputs
    of K, L and M and the path's launches."""
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine, vp_detect
    from limap_tpu_torch.testing import pipeline, pointline
    t0 = time.perf_counter()
    model2, _, _ = pipeline.write_colmap_scene(
        os.path.join(workdir, "points"), n_line_points=4000)
    log(f"[pointline] second COLMAP model (2,000 wall points, 4,000 on the "
        f"GT lines, 2D observations) written in "
        f"{time.perf_counter() - t0:.2f} s")
    lm_line_refine.solve.launches = 0
    lm_assoc.solve_lines.launches = lm_assoc.solve_points.launches = 0
    vp_detect.detect.launches = 0
    recorders = klm_recorders()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out, summ = pointline.run(tracks, imagecols, segs, model2, gt,
                                  os.path.join(workdir, "pointline"),
                                  "cuda")
    finally:
        for rec in recorders.values():
            rec.restore()
    wall = time.perf_counter() - t0
    launches = dict(klm_launches(), vp_detect=vp_detect.detect.launches)
    log(f"[pointline] refinement and association on phase 11's map "
        f"({len(tracks)} tracks), {wall:.3f} s in all on {card}; kernel "
        f"launches {json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[pointline] summary {json.dumps(summ)}")
    for name, n in launches.items():
        check(n > 0, f"the pointline path did not launch {name}")
    for k in ("refined", "refined_px", "associated"):
        check(np.isfinite([t.line for t in out[k]]).all(),
              ("non-finite lines", k))
    check(np.isfinite(out["points"]).all(), "non-finite points")
    hold_pointline_gates(summ)
    left = summ["refined_px"]["n_left_patches"]
    far = summ["refined_px"]["left_patches_dist_m"]
    log(f"[pointline] gate: {left} tracks taken off their heatmap patches "
        f"by the pixel refinement (at most {PL_LEFT_PATCHES_MAX}), at "
        f"{far} m from the GT lines (each at most "
        f"{PL_LEFT_PATCHES_DIST_MAX_M} m; their pixel solve run again in "
        f"float64 ends them at "
        f"{summ['refined_px']['left_patches_dist_f64_m']} m); mean distance "
        f"to GT {summ['refined_px']['dist_mean_m']:.4f} m")
    check(left <= PL_LEFT_PATCHES_MAX, ("tracks off their patches", left))
    check(max(far, default=0.0) <= PL_LEFT_PATCHES_DIST_MAX_M,
          ("tracks off their patches run far", far))
    recorded = {k: (rec.args, rec.kwargs) for k, rec in recorders.items()}
    return recorded, launches, wall


def measure_klm(recorded, launches):
    """K, L and M on the pointline path's largest solves: the normal
    equations at the start and the solve held to plain row by row, timed
    in turns, and their bounds."""
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine
    from limap_tpu_torch.testing import lm_checks
    specs = {
        "lm_line_refine": (lm_line_refine.solve, lm_line_refine.solve_plain,
                           lm_checks.check_refine, K_SOURCE, K_REPLACES, 20),
        "lm_assoc_lines": (lm_assoc.solve_lines, lm_assoc.solve_lines_plain,
                           lm_checks.check_assoc_lines, KLM_SOURCE,
                           L_REPLACES, 10),
        "lm_assoc_points": (lm_assoc.solve_points,
                            lm_assoc.solve_points_plain,
                            lm_checks.check_assoc_points, KLM_SOURCE,
                            M_REPLACES, 10)}
    entries = []
    for name, (kernel, plain, held, source, replaces, n_def) in specs.items():
        args, kwargs = recorded[name]
        check(args is not None, (name, "saw no input on the pointline path"))
        params0, data, terms = args[:3]
        n_iter = args[3] if len(args) > 3 else kwargs.get("num_iterations",
                                                          n_def)
        t0 = time.perf_counter()
        res_ne, res = held(params0, data, terms, n_iter)
        log(f"[kernel] pointline {name} normal equations at the start "
            f"against plain: {json.dumps(res_ne)}")
        log(f"[kernel] pointline {name} solve against plain, row by row: "
            f"{json.dumps(res)} ({time.perf_counter() - t0:.1f} s)")
        check(res_ne["ok"], (name, "normal equations", res_ne))
        check(res["ok"], (name, res))
        R = params0.shape[0]
        if name == "lm_line_refine":
            counts = lm_checks.refine_counts(data, terms)
            ops = lm_checks.ops_line_refine(counts, R, n_iter,
                                            data.fc_ref_patch.shape[-1])
            nbytes = lm_checks.bytes_line_refine(params0, data, terms)
        elif name == "lm_assoc_lines":
            counts = lm_checks.assoc_line_counts(data, terms)
            ops = lm_checks.ops_assoc_lines(counts, R, n_iter)
            nbytes = lm_checks.bytes_assoc_lines(data, terms)
        else:
            counts = lm_checks.assoc_point_counts(data)
            ops = lm_checks.ops_assoc_points(counts, R, n_iter)
            nbytes = lm_checks.bytes_assoc_points(data)
        bms, by = bound(ops, nbytes)
        shape = {"rows": R, "iterations": n_iter, "operations": ops,
                 "bytes": nbytes, **counts, "parted_rows": res["parted"],
                 **parted_end(res),
                 "normal_equations_max_rel_err": res_ne["max_rel_err"],
                 "library": "none: no library call runs a whole LM solve"}
        entries.append(timed_entry(
            name, "pointline", source, replaces, launches[name],
            lambda: kernel(*args, **kwargs),
            lambda: plain(params0, data, terms, n_iter), (), {},
            res["max_abs_err"], bms, by, shape, (5, 1)))
    return entries


N_SOURCE = "mesh_min_dist.cu"
N_REPLACES = "limap_tpu/evaluation/mesh_evaluator.py:79"
# Kernel N against its plain version and the wall's analytic distance:
# both compute each pair by the same correctly rounded fp32 operations
# (bit-equal on the card), and the analytic truth holds to the rounding
# of the foot's coordinates (~1e-6 m at 12 m); 1e-5 m either way.
MESH_TOL = 1e-5
# RefLineEvaluator (fp32 on the card) against a float64 numpy computation
# of the same quantity: a sample within fp32 rounding of tau may fall on
# the other side, moving the recall by 1e-3 of a line's length at most.
REFLINE_RTOL = 1e-3
# Samples a track in phase 13 (500: the plain scan, timed twice, takes
# ~27 s a turn on an NVIDIA H100 80GB HBM3 at 700 W; 1000 took twice that)
EVAL_SAMPLES = 500


def mesh_seeded_cases():
    """Kernel N against its plain version on the seeded cases of
    testing/evaluation.py (degenerate triangles, the seven regions, ragged
    sizes), bit for bit, its counts against the cull's replay in torch on
    the same prepared mesh, the scan yardstick against plain, and the
    empty inputs."""
    from limap_tpu_torch.ops import mesh_distance as md
    from limap_tpu_torch.testing.evaluation import mesh_cases
    for name, p, t in mesh_cases():
        pc = torch.as_tensor(p, device="cuda")
        tc = torch.as_tensor(t, device="cuda")
        mesh = md.prepare_mesh(tc)
        n0 = md.mesh_min_dist.launches
        k = md.mesh_min_dist(pc, mesh)
        counts = md.mesh_min_dist.counts.tolist()
        pl = md.mesh_min_dist_plain(pc, tc)
        sc = md.mesh_min_dist_scan(pc, tc)
        # the replay on the CPU, on the card's own prepared arrays
        _, replay = md.mesh_min_dist_culled(
            pc.cpu(), md.PreparedMesh(*(x.cpu() for x in mesh)))
        torch.cuda.synchronize()
        err = float((k - pl).abs().max())
        log(f"[kernel] mesh_min_dist vs plain, case {name} ({len(p)} x "
            f"{len(t)}): bit-equal {torch.equal(k, pl)}, max abs err "
            f"{err:.3e}; counts {counts} (replay {json.dumps(replay)}); "
            f"always {len(mesh.always)}, clusters {len(mesh.clusters)}; "
            f"scan bit-equal {torch.equal(sc, pl)}")
        check(md.mesh_min_dist.launches == n0 + 1, "N: launch not counted")
        check(torch.equal(k, pl), ("mesh_min_dist vs plain", name, err))
        check(torch.equal(sc, pl), ("mesh_min_dist_scan vs plain", name))
        check(counts == [replay[k] for k in md.COUNTS],
              ("mesh_min_dist counts vs the replay", name, counts, replay))
    n0 = md.mesh_min_dist.launches
    empty = md.mesh_min_dist(pc, tc[:0])
    none = md.mesh_min_dist(pc[:0], tc)
    check(bool(torch.isinf(empty).all()) and none.shape == (0,)
          and md.mesh_min_dist.launches == n0,
          "mesh_min_dist: M = 0 gives inf and P = 0 nothing, no launch")


def evaluation_full_width(lines, gt, card):
    """Phase 13: the GT evaluation of phase 7's card tracks against the
    wall's mesh (MeshEvaluator, kernel N), the GT cloud on the wall
    (PointCloudEvaluator) and the GT lines (RefLineEvaluator), each
    checked against a truth independent of the kernel; then N held to its
    plain version on the whole input and timed in turns."""
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.evaluation import (MeshEvaluator,
                                            PointCloudEvaluator,
                                            RefLineEvaluator,
                                            sample_points_on_segments)
    from limap_tpu_torch.ops import mesh_distance as md
    from limap_tpu_torch.testing import evaluation as ev
    from limap_tpu_torch.testing.synthetic import gt_point_cloud

    verts, faces = ev.wall_mesh()
    cloud = ev.on_wall(gt_point_cloud(gt.astype(np.float32), 500))
    t = torch.as_tensor(lines, dtype=torch.float32, device="cuda")
    seg = Segments(t[:, 0], t[:, 1])
    lengths = seg.length()
    md.mesh_min_dist.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = MeshEvaluator(verts, faces, device="cuda")
    d_mesh = mesh.ComputeDistsLine(seg, EVAL_SAMPLES)
    recall = {tau: float(torch.sum(mesh.ComputeInlierRatio(
        seg, tau, EVAL_SAMPLES) * lengths)) for tau in TAUS}
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = md.mesh_min_dist.launches
    t0 = time.perf_counter()
    ref = RefLineEvaluator(gt, device="cuda")
    ref_len = ref.SumLength()
    ref_recall = {tau: ref.ComputeRecallRef(lines, tau, EVAL_SAMPLES)
                  for tau in TAUS}
    ref_s = time.perf_counter() - t0
    pc = PointCloudEvaluator(cloud, device="cuda")
    d_cloud = pc.ComputeDistsLine(seg, EVAL_SAMPLES)
    cloud_recall = {tau: float(torch.sum(torch.mean(
        (d_cloud <= tau).float(), 1) * lengths)) for tau in TAUS}
    log(f"[evaluation] {len(lines)} tracks x {EVAL_SAMPLES} samples against "
        f"the wall "
        f"mesh ({faces.shape[0]} triangles, {verts.shape[0]} vertices): "
        f"{mesh_s:.3f} s for ComputeDistsLine and the {len(TAUS)} inlier "
        f"ratios, {launches} launches of mesh_min_dist; length recall "
        f"{recall}; against the GT cloud on the wall ({len(cloud)} points) "
        f"{cloud_recall}; reference lines: {len(gt)} of {ref_len:.4f} m, "
        f"recall {ref_recall} ({ref_s:.3f} s) on {card}")
    check(launches > 0, "the evaluation path did not launch mesh_min_dist")

    # the mesh distance against the wall's analytic distance (float64)
    queries = sample_points_on_segments(seg, EVAL_SAMPLES).reshape(-1, 3) \
        .contiguous()
    d = d_mesh.reshape(-1).double().cpu().numpy()
    inside, dz = ev.wall_distance(queries.cpu().numpy())
    err_in = float(np.abs(d[inside] - dz[inside]).max(initial=0.0))
    short = float((dz[~inside] - d[~inside]).max(initial=-np.inf))
    log(f"[evaluation] mesh distance against the wall's analytic distance: "
        f"{int(inside.sum())} samples over the wall within {err_in:.3e} m, "
        f"{int((~inside).sum())} beside it, none nearer than the plane by "
        f"more than {max(short, 0.0):.3e} m")
    check(np.isfinite(d).all() and d.shape == (len(lines) * EVAL_SAMPLES,),
          "mesh distances finite, one a sample")
    check(inside.any() and err_in <= MESH_TOL, ("analytic wall", err_in))
    check(short <= MESH_TOL, ("samples beside the wall", short))

    # the cloud lies on the mesh: no sample is farther from the mesh
    over = float((d_mesh - d_cloud).max())
    check(over <= MESH_TOL, ("mesh distance above the cloud's", over))
    for tau in TAUS:
        near = (d_cloud <= tau) & (d_mesh > tau)
        slack = float(torch.sum(near.float().mean(1) * lengths))
        check(recall[tau] + slack >= cloud_recall[tau] - 1e-6,
              ("mesh recall below the cloud's", tau, recall, cloud_recall))
    log(f"[evaluation] mesh distance <= cloud distance + {over:.3e} m on "
        f"every sample; mesh recall >= cloud recall at every tau")

    # RefLineEvaluator against float64
    len64, rec64 = ev.refline_f64(gt, lines, TAUS, EVAL_SAMPLES)
    rel = {tau: abs(ref_recall[tau] - rec64[tau]) / max(rec64[tau], 1e-12)
           for tau in TAUS}
    log(f"[evaluation] RefLineEvaluator against float64: length "
        f"{ref_len:.6f} / {len64:.6f} m, recall {rec64}, relative "
        f"differences {rel}")
    check(abs(ref_len - len64) <= REFLINE_RTOL * len64, "SumLength")
    for tau in TAUS:
        check(rel[tau] <= REFLINE_RTOL, ("ComputeRecallRef", tau, rel))
    return measure_mesh(queries, mesh.mesh, launches)


MESH_TURNS = ("plain", "kernel", "scan", "kernel", "scan")


def measure_mesh(queries, mesh, launches):
    """Kernel N on the evaluation's whole input: held bit for bit to the
    plain version (its first turn), timed in turns with the plain scan
    and the first design (every pair), its counts, and two bounds: the
    work of the pairs and box tests it did, and every pair's."""
    from limap_tpu_torch.ops import mesh_distance as md
    P, M = queries.shape[0], mesh.tris.shape[0]
    fns = {"kernel": md.mesh_min_dist, "plain": md.mesh_min_dist_plain,
           "scan": md.mesh_min_dist_scan}
    times = {k: [] for k in fns}
    out = {}
    for which in MESH_TURNS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        d = fns[which](queries, mesh.tris if which == "plain" else mesh)
        end.record()
        torch.cuda.synchronize()
        times[which].append(start.elapsed_time(end))
        out.setdefault(which, d)
    n0 = md.mesh_min_dist.launches
    md.mesh_min_dist(queries, mesh)
    c = dict(zip(md.COUNTS, md.mesh_min_dist.counts.tolist()))
    check(md.mesh_min_dist.launches == n0 + 1, "N: launch not counted")
    err = float((out["kernel"] - out["plain"]).abs().max())
    equal = torch.equal(out["kernel"], out["plain"])
    check(equal, ("mesh_min_dist vs plain on the whole input", err))
    check(torch.equal(out["scan"], out["plain"]),
          "mesh_min_dist_scan vs plain on the whole input")
    pairs = P * M
    nbytes = P * 12 + M * 36 + P * 4
    C = mesh.clusters.shape[0]
    ops = md.cull_work(c)
    bms, by = bound(ops, nbytes)
    all_ms, all_by = bound(pairs * md.OPS_PAIR, nbytes)
    shape = {"queries": P, "triangles": M, "pairs": pairs,
             "pairs_evaluated": c["pairs"],
             "pairs_evaluated_share": c["pairs"] / pairs,
             "clusters": C, "clusters_scanned": c["scanned"],
             "lane_box_tests": c["tests"], "sweep_tests": c["sweep_tests"],
             "seed_tests": c["seed_tests"], "groups": len(mesh.groups),
             "always": len(mesh.always),
             "warps": (P + 31) // 32, "ops_per_pair": md.OPS_PAIR,
             "ops_per_box_test": md.OPS_BOX, "operations": ops,
             "bit_equal_to_plain": equal,
             "scan_ms": float(np.mean(times["scan"])),
             "scan_ms_turns": times["scan"],
             "bound_all_pairs_ms": all_ms, "bound_all_pairs_by": all_by,
             "library": "none (no PyTorch call computes a point-to-triangle "
                        "distance)"}
    log(f"[kernel] evaluation mesh_min_dist {json.dumps(shape)}: max abs err "
        f"to plain {err:.3e} on the whole input; ms in turns "
        f"{list(MESH_TURNS)}: {json.dumps(times)}; bound {bms:.4f} ms ({by}) "
        f"on the work done, {all_ms:.4f} ms on every pair")
    return {"name": "mesh_min_dist", "path": "evaluation", "route": "cuda",
            "source": "limap_tpu_torch/csrc/" + N_SOURCE,
            "replaces": N_REPLACES, "launches": launches, "max_abs_err": err,
            "ms": float(np.mean(times["kernel"])),
            "ms_turns": times["kernel"],
            "plain_ms": float(np.mean(times["plain"])),
            "plain_ms_turns": times["plain"], "bound_ms": bms,
            "bound_by": by, "library_ms": None, **shape}


# ---------------------------------------------------------------- phase 14
O_SOURCE = "hybrid_ba.cu"
O_REPLACES = "limap_tpu/parallel/sharded_ba.py:303"
P_REPLACES = "limap_tpu/parallel/sharded_ba.py:233, :375"
Q_REPLACES = "limap_tpu/parallel/sharded_ba.py:407"
# The PORT's CPU run of phase 14's path (tests/torch_port_reference_gates.py
# --refine-sfm 100, 647 s): median pose errors before and after the BA
# (m, deg, in float64 from the quaternions), the line map's tracks, the
# BA's costs and accepts.
REFERENCE_REFINE = {
    "trans_before": 0.023613074445552287, "rot_before": 0.42919357448270107,
    "trans_after": 0.007199142538723216, "rot_after": 0.027871723311361014,
    "n_tracks": 2, "n_points": 3986, "n_point_obs": 120621,
    "cost_first": 6867.83447265625, "cost_last": 1396.63037109375,
    "n_accepted": 10}
# The noisy-pose line map is a few tracks, one of which may fall either
# way of a filter (one track of slack); the errors after the BA within a
# quarter of the reference's (a track more or less moves them); the
# costs within 1e-4 (the same observations; the decisions near the
# float32 floor may differ, as the accepts did: 11 on an H100, 10 here).
REFINE_GATES = (("n_tracks", "points", 1),
                ("n_point_obs", "points", 0),
                ("trans_after", "relative", 0.25),
                ("rot_after", "relative", 0.25),
                ("cost_first", "relative", 1e-5),
                ("cost_last", "relative", 1e-4))
# The PORT's CPU run of phase 14's line half
# (python -m limap_tpu_torch.testing.refine 100 cpu --gt-map; 573 s on
# the 8 host cores of an H100 machine): the façade's line map on its GT
# poses through the hybrid BA on the noisy poses and points, 20 steps
# (testing/refine.py::run_map_ba).
REFERENCE_REFINE_GT_MAP = {
    "trans_before": 0.023613074445552287, "rot_before": 0.42919357448270107,
    "trans_after": 0.007077141190147794, "rot_after": 0.035823920032890824,
    "n_tracks_in": 213, "n_tracks": 213,
    "line_dist_before": 0.03478383331513145,
    "line_dist_after": 0.033773304172170254,
    "cost_first": 6959.50439453125, "cost_last": 1427.1903076171875,
    "n_accepted": 20}
# The card's map may differ from the CPU's by a track or two (phase 7's
# 1 % on the track count), which moves the costs by about the share of
# a few tracks' supports: the costs within 2 %; the errors after the BA
# within a quarter of the reference's, as REFINE_GATES.
REFINE_GT_MAP_GATES = (("n_tracks_in", "relative", 0.01),
                       ("n_tracks", "relative", 0.02),
                       ("trans_after", "relative", 0.25),
                       ("rot_after", "relative", 0.25),
                       ("line_dist_after", "relative", 0.25),
                       ("cost_first", "relative", 0.02),
                       ("cost_last", "relative", 0.02))
# CG against the dense solve (64 CG iterations a step, 20 steps), as
# tests/test_sharded_ba.py:128 holds them: the final costs agree within
# CG_COST_RTOL.  The poses are weakly determined along a near-gauge
# direction (on an H100 the two runs' final costs differed by 4e-6 while
# the median image's pose differed by 3.8 mm of the 16.4 mm the BA took
# out), so the median image's poses agree within half the median error
# taken out.
CG_COST_RTOL = 1e-4
CG_POSE_SHARE = 0.5
# Card against CPU on the reduced façade (phase 14a): the same line map
# (the card's run reads the CPU's segments and matches), then the BA in
# float32 on both: the costs within COST_RTOL_14A at every step where
# both took the same decision, the poses, points and lines within these.
COST_RTOL_14A = 1e-3
# refine_sfm's pose noise (0.01) leaves the reduced façade no line track;
# a third of it leaves two
REFINE_14A_POSE_NOISE = 0.003
POSE_TOL_14A_M = 1e-3
POSE_TOL_14A_DEG = 1e-2
POINT_TOL_14A_M = 1e-2
LINE_TOL_14A_M = 1e-2


def hybrid_seeded_cases():
    """Kernels O, P and Q against their plain versions on the seeded cases
    of testing/hybrid_checks.py."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.testing import hybrid_checks
    t0 = time.perf_counter()
    n0 = (O.hybrid_terms.launches, O.hybrid_apply.launches,
          O.hybrid_cost.launches)
    for name, case, res in hybrid_checks.check_all():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    n1 = (O.hybrid_terms.launches, O.hybrid_apply.launches,
          O.hybrid_cost.launches)
    check(all(b > a for a, b in zip(n0, n1)), ("O, P, Q launches", n0, n1))
    for case, res in hybrid_checks.check_all_scan():
        log(f"[kernel] hybrid_apply and hybrid_apply_both vs the first "
            f"design (hybrid_apply_scan), case {case}: {json.dumps(res)}")
        check(res["ok"], ("P vs its first design", case, res))
    log(f"[kernel] hybrid_terms, hybrid_apply, hybrid_cost seeded cases "
        f"took {time.perf_counter() - t0:.1f} s")


def pose_errors_between(a, b):
    """Largest (centre distance m, angle deg) between two collections'
    poses of the same images."""
    from limap_tpu_torch.testing.refine import pose_errors64
    te, re = pose_errors64(a, b)
    return max(te), max(re)


def track_line_distance(a, b):
    """Largest endpoint difference of two track lists, track by track."""
    return max((endpoint_error(np.asarray(x.line), np.asarray(y.line))
                for x, y in zip(a, b)), default=0.0)


def refine_card_vs_cpu(workdir):
    """Phase 14a: run_refine_sfm on a reduced façade (8 views) on the CPU,
    then on the card with the CPU's segments and matches: the same line
    map, then the hybrid BA held card to CPU (costs, poses, points,
    lines)."""
    from limap_tpu_torch.testing import refine
    scene = refine.write_refine_scene(workdir, 8, n_lines=60,
                                      hw=(480, 640), n_points=800,
                                      pose_noise=REFINE_14A_POSE_NOISE)
    outs = {}
    for dev in ("cpu", "cuda"):
        cfg = refine.refine_config(os.path.join(workdir, dev), n_neighbors=4)
        cfg["n_visible_views"] = 3
        cfg["triangulation"]["fullscore_th"] = 0.5
        if dev == "cuda":
            cfg.update(load_det=True, load_match=True,
                       load_dir=os.path.join(workdir, "cpu"))
        outs[dev] = refine.run(scene, os.path.join(workdir, dev), dev,
                               cfg)
    (c, _, sc), (g, secs, sg) = outs["cpu"], outs["cuda"]
    check(len(g["linetracks_in"]) == len(c["linetracks_in"])
          and sorted(map(key, g["linetracks_in"]))
          == sorted(map(key, c["linetracks_in"])),
          ("refine line map card vs CPU", len(g["linetracks_in"]),
           len(c["linetracks_in"])))
    cc, gc = c["costs"], g["costs"]
    parted = None
    for i in range(len(cc)):
        check(abs(gc[i] - cc[i]) <= COST_RTOL_14A * cc[i],
              ("refine costs card vs CPU", i, gc, cc))
        if i and (gc[i] < gc[i - 1]) != (cc[i] < cc[i - 1]):
            parted = i
            break
    dt, dr = pose_errors_between(g["imagecols"], c["imagecols"])
    dp = float(np.abs(g["points"] - c["points"]).max())
    dl = track_line_distance(g["linetracks"], c["linetracks"])
    log(f"[refine card-vs-cpu] {len(g['linetracks_in'])} tracks, identical "
        f"supports; costs {gc[0]:.6f} -> {gc[-1]:.6f} (CPU {cc[0]:.6f} -> "
        f"{cc[-1]:.6f}), decisions part at {parted}; poses within "
        f"{dt:.2e} m, {dr:.2e} deg; points {dp:.2e} m; lines {dl:.2e} m; "
        f"card {json.dumps(sg)} in {secs:.2f} s; CPU {json.dumps(sc)}")
    check(parted is None, ("refine decisions card vs CPU", gc, cc))
    check(dt <= POSE_TOL_14A_M and dr <= POSE_TOL_14A_DEG,
          ("refine poses card vs CPU", dt, dr))
    check(dp <= POINT_TOL_14A_M, ("refine points card vs CPU", dp))
    check(dl <= LINE_TOL_14A_M, ("refine lines card vs CPU", dl))


class FirstCalls:
    """Wraps ``module.name`` to keep the arguments of its first call of
    each kind (``kind_of``)."""

    def __init__(self, module, name, kind_of):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = {}

        def wrapper(*args, **kwargs):
            self.calls.setdefault(kind_of(*args, **kwargs), (args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def refine_full_width(workdir, card):
    """Phase 14: the façade (100 views of 800x600) with 4,000 wall points
    and their 2D observations as a COLMAP model on noisy poses, through
    run_refine_sfm (line map from the .npy pixels, then the hybrid BA on
    kernels O, P and Q), gated against the port's CPU run; then the same
    BA with CG against the dense solve.  Returns the recorded kernel
    inputs, the launches and the scene."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import (HybridBAOptions,
                                          solve_hybrid_bundle_adjustment)
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    from limap_tpu_torch.testing import refine

    t0 = time.perf_counter()
    scene = refine.write_refine_scene(workdir)
    n_obs = sum(len(v["image_ids"]) for v in scene["points3d"].values())
    log(f"[refine] façade written as COLMAP models ({len(scene['points3d'])} "
        f"wall points, {n_obs} observations) in "
        f"{time.perf_counter() - t0:.2f} s")
    O.reset_counts()
    rec = {"terms": FirstCalls(O, "hybrid_terms", lambda *a, **k: a[0]),
           "cost": FirstCalls(O, "hybrid_cost", lambda *a, **k: 0)}
    torch.cuda.reset_peak_memory_stats()
    try:
        out, secs, summ = refine.run(scene, os.path.join(workdir, "out"),
                                     "cuda")
    finally:
        for r in rec.values():
            r.restore()
    launches = hybrid_launches()
    log(f"[refine] run_refine_sfm through the COLMAP branch in {secs:.3f} s "
        f"(stage seconds {json.dumps(out['seconds'])}) on {card}; "
        f"{json.dumps(summ)}; kernel launches {json.dumps(launches)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check_hybrid_launches("the refine path", launches, product=False)
    check(summ["trans_after"] < summ["trans_before"]
          and summ["rot_after"] < summ["rot_before"],
          ("the hybrid BA did not lower the median pose errors", summ))
    check(np.isfinite(out["points"]).all()
          and np.isfinite([t.line for t in out["linetracks"]]).all(),
          "non-finite BA output")
    hold_to_gates("refine", summ, REFERENCE_REFINE, REFINE_GATES)

    # the same BA with CG (ITERATIVE_SCHUR) against the dense solve
    imagecols, pointtracks = read_colmap_inputs(scene["model"],
                                                scene["image_dir"])
    O.reset_counts()
    t0 = time.perf_counter()
    cg = solve_hybrid_bundle_adjustment(
        imagecols, pointtracks, out["linetracks_in"],
        HybridBAOptions(n_fixed_poses=2, solver="cg"),
        n_iterations=len(out["costs"]) - 1, device="cuda")
    cg_s = time.perf_counter() - t0
    cg_launches = hybrid_launches()
    check_hybrid_launches("the refine path's CG run", cg_launches,
                          product=True)
    launches["hybrid_apply"].update(
        {k: n for k, n in cg_launches["hybrid_apply"].items()
         if k.endswith("apply")})
    hold_cg_to_dense("refine", cg, cg_s, out["imagecols"], out["costs"],
                     summ, refine.imagecols_gt_read(scene))
    recorded = {"terms": rec["terms"].calls, "cost": rec["cost"].calls[0]}
    return recorded, launches, scene, out


def hybrid_launches():
    """O's and P's launches by kind and mode, Q's in all, and O's and P's
    first designs' (the yardsticks), since the last ``reset_counts``."""
    from limap_tpu_torch.ops import hybrid_ba as O
    return {"hybrid_terms": dict(O.hybrid_terms.counts),
            "hybrid_apply": dict(O.hybrid_apply.counts),
            "hybrid_cost": O.hybrid_cost.launches,
            "hybrid_terms_scan": O.hybrid_terms_scan.launches,
            "hybrid_apply_scan": O.hybrid_apply_scan.launches}




def check_hybrid_launches(what, launches, product):
    """Every kind went through O and P's back-substitution, and Q ran;
    with ``product`` (the CG runs) CG's product took both kinds in one
    launch of P, never one kind alone; no yardstick ran."""
    for kind in ("line", "point"):
        check(launches["hybrid_terms"].get(kind, 0) > 0,
              f"{what} did not launch hybrid_terms on the {kind}s")
        check(launches["hybrid_apply"].get(f"{kind}, backsub", 0) > 0,
              f"{what} did not launch hybrid_apply (backsub) on the "
              f"{kind}s")
        check(launches["hybrid_apply"].get(f"{kind}, apply", 0) == 0,
              f"{what} launched CG's product on the {kind}s alone")
    both = launches["hybrid_apply"].get("line+point, apply", 0)
    check(both > 0 if product else both == 0,
          f"{what}: CG's product of both kinds launched {both} times")
    check(launches["hybrid_cost"] > 0, f"{what} did not launch hybrid_cost")
    check(launches["hybrid_terms_scan"] == 0
          and launches["hybrid_apply_scan"] == 0,
          f"{what} launched a yardstick")


def hold_cg_to_dense(what, cg, cg_s, dense_cols, dense_costs, summ, gt):
    """The same BA with CG against the dense solve: the final costs
    within CG_COST_RTOL, the median image's pose within CG_POSE_SHARE of
    the median error the dense BA took out."""
    from limap_tpu_torch.testing import refine
    diffs = np.asarray(refine.pose_errors64(cg[0], dense_cols)).T
    dt, dr = np.median(diffs, 0)
    te, re = refine.pose_errors64(cg[0], gt)
    log(f"[{what}] CG: {cg_s:.3f} s, costs {cg[3][0]:.4f} -> "
        f"{cg[3][-1]:.4f} (dense {dense_costs[-1]:.4f}); median errors "
        f"{np.median(te):.5f} m, {np.median(re):.5f} deg; poses from the "
        f"dense run's: median {dt:.2e} m, {dr:.2e} deg, largest "
        f"{diffs[:, 0].max():.2e} m, {diffs[:, 1].max():.2e} deg")
    noise_m = summ["trans_before"] - summ["trans_after"]
    noise_deg = summ["rot_before"] - summ["rot_after"]
    check(abs(cg[3][-1] - dense_costs[-1]) <= CG_COST_RTOL * dense_costs[-1],
          (what, "CG cost against the dense solve", cg[3][-1],
           dense_costs[-1]))
    check(dt <= CG_POSE_SHARE * noise_m and dr <= CG_POSE_SHARE * noise_deg,
          (what, "CG poses against the dense solve", dt, dr, noise_m,
           noise_deg))


def refine_gt_map(scene, card):
    """Phase 14's line half: the façade's line map on its GT poses (the
    direct call of phase 14's CLIs; 212 tracks, where refine_sfm's noisy
    poses leave 2) through the hybrid BA on the noisy poses and points
    for 20 steps, dense and then CG: both median pose errors must fall;
    the errors, the lines' median distance to the GT lines (triangulated
    on the GT poses, they start near their best), the tracks and the
    costs are gated against the port's CPU run (REFERENCE_REFINE_GT_MAP);
    CG is held to the dense run.
    Returns the map, O's first call of each kind and the run's
    launches."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.testing import refine
    direct = refine.gt_line_map(
        scene, os.path.join(scene["image_dir"], "..", "direct"), "cuda")
    O.reset_counts()
    rec = FirstCalls(O, "hybrid_terms", lambda *a, **k: a[0])
    try:
        out, secs, summ = refine.run_map_ba(scene, direct, "cuda")
    finally:
        rec.restore()
    launches = hybrid_launches()
    log(f"[refine gt-map] the GT-pose line map ({len(direct)} tracks) "
        f"through the hybrid BA on the noisy poses in {secs:.3f} s on "
        f"{card}: {json.dumps(summ)}; kernel launches "
        f"{json.dumps(launches)}")
    check_hybrid_launches("the GT-pose map's BA", launches, product=False)
    check(summ["trans_after"] < summ["trans_before"]
          and summ["rot_after"] < summ["rot_before"],
          ("the hybrid BA on the GT-pose map did not lower the median "
           "pose errors", summ))
    check(np.isfinite(out[1]).all()
          and np.isfinite([t.line for t in out[2]]).all(),
          "non-finite BA output on the GT-pose map")
    hold_to_gates("refine gt-map", summ, REFERENCE_REFINE_GT_MAP,
                  REFINE_GT_MAP_GATES)
    O.reset_counts()
    cg, cg_s, _ = refine.run_map_ba(scene, direct, "cuda", solver="cg")
    cg_launches = hybrid_launches()
    check_hybrid_launches("the GT-pose map's CG run", cg_launches,
                          product=True)
    launches["hybrid_apply"].update(
        {k: n for k, n in cg_launches["hybrid_apply"].items()
         if k.endswith("apply")})
    hold_cg_to_dense("refine gt-map", cg, cg_s, out[0], out[3], summ,
                     refine.imagecols_gt_read(scene))
    return direct, rec.calls, launches


def measure_hybrid(recorded, launches, gt_calls=None, gt_launches=None):
    """O, P and Q on the BA's first step of phase 14: held to their plain
    versions (testing/hybrid_checks.py), timed in turns (plain, kernel,
    kernel, plain) beside their bounds; with ``gt_calls`` (O's first call
    of each kind) also O and P on the first step of the GT-pose line map's
    BA (``gt_launches`` its run's launches); and the dense solve's
    torch.linalg.solve on the path's reduced system.  P's back-
    substitution and CG's product of both kinds are held to P's first
    design bit for bit and timed in turns with it; the product's launches
    are its CG run's."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.testing import hybrid_checks as HC
    entries, errs = [], {}
    terms = {}
    calls = dict(recorded["terms"])
    runs = {label: launches for label in calls}
    if gt_calls is not None:
        calls["line, GT-pose map"] = gt_calls["line"]
        runs["line, GT-pose map"] = gt_launches
    for label, (args, kwargs) in calls.items():
        kind = args[0]
        (kind_, land, pose, fxfy, kvec, cam, img, obs, w, opts, lam, I, C,
         dense) = args
        from limap_tpu_torch.parallel.sharded_ba import HybridBAState
        state = HybridBAState(land if kind == "line" else None,
                              land if kind == "point" else None, pose, fxfy)
        data = (kvec, cam, img) + tuple(obs) + (w,)
        t0 = time.perf_counter()
        res, k = HC.check_terms(kind, state, data, opts, lam, I, C, dense)
        log(f"[kernel] refine hybrid_terms + hybrid_apply, {label}, on the "
            f"first step's input ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(res)}")
        check(res["ok"], ("O, P vs plain on phase 14's input", label, res))
        terms[label] = (args, k)
        errs[label] = res
    D = O.dims(I, C, opts.optimize_focal)
    Dc = 8 if opts.optimize_focal else 6
    # O, with the index built once (as the path does), beside its split
    # and its first design
    for label, (args, k) in terms.items():
        kind = args[0]
        L = O.LAND[kind]
        w = args[8]
        ops, nbytes = HC.terms_work(kind, w, args[6], args[5], L, Dc, D,
                                    args[13], O.PARAMS[kind], O.OBS[kind])
        bms, by = bound(ops, nbytes)
        res = errs[label]
        split = HC.terms_split(args)
        log(f"[kernel] refine hybrid_terms, {label}: time split (ms) "
            f"{json.dumps(split)}")
        index = O.build_index(args[6], args[5], w, args[11], args[12],
                              args[9].optimize_focal, args[13])
        # the yardstick shares stage 1 with O (held above); its stage 2
        # is held to the float64 recomputation from its own terms
        scan_res = HC.check_assembly(HC.weighted_only(
            O.hybrid_terms_scan(*args, index=index)))
        log(f"[kernel] refine hybrid_terms_scan (the first design), {label}, "
            f"its assembly against float64: {json.dumps(scan_res)}")
        check(scan_res["ok"], ("the first design of O's assembly", label))
        # the yardstick as its path ran it: the grouping built every call
        # (all its stage 2 reads); and once with the grouping prebuilt
        grouping = O.grouping_index(args[6], args[5], w, args[11], args[12],
                                    args[9].optimize_focal, args[13])
        fns = {"kernel": lambda: O.hybrid_terms(*args, index=index),
               "scan": lambda: O.hybrid_terms_scan(*args),
               "scan, grouping prebuilt": lambda: O.hybrid_terms_scan(
                   *args, index=grouping)}
        yard = {k: [] for k in fns}
        for which in ("scan", "kernel", "kernel", "scan",
                      "scan, grouping prebuilt"):
            yard[which].append(cuda_ms(fns[which], 5))
        log(f"[kernel] refine hybrid_terms, {label}, in turns with its first "
            f"design (ms): {json.dumps(yard)}")
        shape = {"kind": label, "tracks": int(w.shape[0]),
                 "slots": int(w.shape[1]), "weighted": int((w > 0).sum()),
                 "D": D, "dense": bool(args[13]), "operations": ops,
                 "bytes": nbytes, "split_ms": split,
                 "ms_turns_with_scan": yard["kernel"],
                 "library": "none (no PyTorch call builds a Schur system)"}
        err = max(res[n][0] for n in ("g", "diag0", "Hp") if n in res)
        entry = timed_entry(
            f"hybrid_terms ({label})", "refine", O_SOURCE, O_REPLACES,
            runs[label]["hybrid_terms"][kind],
            lambda *a: O.hybrid_terms(*a, index=index), O.hybrid_terms_plain,
            args, {}, err, bms, by, shape, (5, 1))
        scan_err = max(v[0] for n, v in scan_res.items() if n != "ok")
        entries += [entry, dict(
            entry, name=f"hybrid_terms_scan ({label})",
            launches=runs[label]["hybrid_terms_scan"], max_abs_err=scan_err,
            ms=float(np.mean(yard["scan"])), ms_turns=yard["scan"],
            grouping_prebuilt_ms=yard["scan, grouping prebuilt"][0],
            role="yardstick: O's first design, its supports' grouping "
                 "built every call as its path did")]
    # P: each kind's back-substitution, and CG's product of both kinds in
    # one launch (prepared once a solve, as the path calls it), on each
    # system's first-step terms
    systems = {"refine": (terms["line"][1], terms["point"][1], launches)}
    if gt_calls is not None:
        (pargs, pkw) = gt_calls["point"]
        systems["GT-pose map"] = (terms["line, GT-pose map"][1],
                                  HC.weighted_only(O.hybrid_terms(*pargs,
                                                                  **pkw)),
                                  gt_launches)
    for system, (tl, tp, run) in systems.items():
        entries += measure_apply(system, tl, tp, run, D, Dc,
                                 errs if system == "refine" else {
                                     "line": errs["line, GT-pose map"]})
    # Q
    (cargs, _) = recorded["cost"]
    state, ld, pd, opts_c = cargs
    res = HC.check_cost(state, ld, pd, opts_c)
    log(f"[kernel] refine hybrid_cost on the first state: {json.dumps(res)}")
    check(res["ok"], ("Q vs plain on phase 14's input", res))
    ops, nbytes = HC.cost_work(
        {"line": (ld[-1], ld[2], ld[1], O.PARAMS["line"], O.OBS["line"]),
         "point": (pd[-1], pd[2], pd[1], O.PARAMS["point"],
                   O.OBS["point"])})
    bms, by = bound(ops, nbytes)
    entries.append(timed_entry(
        "hybrid_cost", "refine", O_SOURCE, Q_REPLACES,
        launches["hybrid_cost"], O.hybrid_cost, O.hybrid_cost_plain,
        cargs, {}, res["abs_err"], bms, by,
        {"line_slots": int(ld[-1].numel()), "point_slots": int(pd[-1].numel()),
         "operations": ops, "bytes": nbytes, "library": "none"}, (20, 5)))
    # the dense solve beside them: the first step's damped reduced system
    tl, tp = terms["line"][1], terms["point"][1]
    Hp = tl.Hp + tp.Hp
    A = Hp + 1e-3 * torch.diag(torch.clamp(torch.diagonal(Hp), min=1e-8)) \
        + 1e-8 * torch.eye(D, device="cuda")
    g = tl.g + tp.g
    solve_ms = cuda_ms(lambda: torch.linalg.solve(A, g), 20)
    log(f"[kernel] refine torch.linalg.solve of the {D} x {D} reduced "
        f"system: {solve_ms:.4f} ms")
    for e in entries:
        e["dense_solve_ms"] = solve_ms
    return entries


YARD_TURNS = ("scan", "kernel", "kernel", "scan")


def yard_entries(name, yard_name, path, source, replaces, launches, kernel,
                 scan, plain, err, scan_err, bound_ms, bound_by, shape, reps,
                 role):
    """A kernel's entry of the kernels line and its first design's (the
    yardstick, no launches on the path): the two timed in turns
    (YARD_TURNS, ``reps`` runs a turn, CUDA events), the plain version
    once on the same input."""
    times = {"kernel": [], "scan": []}
    for which in YARD_TURNS:
        times[which].append(cuda_ms(kernel if which == "kernel" else scan,
                                    reps))
    plain_ms = cuda_ms(plain, 1)
    log(f"[kernel] {path} {name} {json.dumps(shape)}: max abs err to plain "
        f"{err:.3e} (first design {scan_err:.3e}); ms in turns "
        f"{list(YARD_TURNS)}: {json.dumps(times)}; plain {plain_ms:.4f}; "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    entry = {"name": name, "path": path, "route": "cuda",
             "source": "limap_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches, "max_abs_err": err,
             "ms": float(np.mean(times["kernel"])),
             "ms_turns": times["kernel"], "plain_ms": plain_ms,
             "plain_ms_turns": [plain_ms], "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None, **shape}
    return [entry, dict(entry, name=yard_name, launches=0,
                        max_abs_err=scan_err,
                        ms=float(np.mean(times["scan"])),
                        ms_turns=times["scan"], role=role)]


def measure_apply(system, tl, tp, run, D, Dc, errs):
    """P on one system's first-step terms (``tl``, ``tp``): each kind's
    back-substitution and CG's product of both kinds, held to the first
    design bit for bit and to plain, split into its parts, and timed in
    turns with the first design; ``run`` the launches of the system's
    runs, ``errs`` check_terms' results by kind (the back-substitution's
    error to plain)."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.testing import hybrid_checks as HC
    gen = torch.Generator().manual_seed(1)
    v = torch.randn(D, generator=gen).to("cuda")
    res = HC.check_apply_scan(tl, tp, v)
    log(f"[kernel] refine hybrid_apply, {system}: bit for bit against the "
        f"first design (hybrid_apply_scan): {json.dumps(res)}")
    check(res["ok"], ("P vs its first design", system, res))
    split = {"points": HC.apply_split((tp,), v),
             "lines": HC.apply_split((tl,), v),
             "both": HC.apply_split((tl, tp), v),
             "points, first design": HC.apply_split((tp,), v, scan=True),
             "lines, first design": HC.apply_split((tl,), v, scan=True)}
    log(f"[kernel] refine hybrid_apply, {system}: time split (ms, device "
        f"time queued behind a sleep; the wrapper's host time a call): "
        f"{json.dumps(split)}")
    entries = []
    work = {k.kind: HC.apply_work(k.weight, k.img, k.cam, O.LAND[k.kind],
                                  Dc, D, False) for k in (tl, tp)}
    for k in (tl, tp):
        if k.kind not in errs:
            continue
        ops, nbytes = HC.apply_work(k.weight, k.img, k.cam, O.LAND[k.kind],
                                    Dc, D, True)
        bms, by = bound(ops, nbytes)
        label = k.kind if system == "refine" else f"{k.kind}, {system}"
        entries += yard_entries(
            f"hybrid_apply ({label}, backsub)",
            f"hybrid_apply_scan ({label}, backsub)", "refine", O_SOURCE,
            P_REPLACES, run["hybrid_apply"].get(f"{k.kind}, backsub", 0),
            lambda k=k: O.hybrid_apply(k, v, True),
            lambda k=k: O.hybrid_apply_scan(k, v, True),
            lambda k=k: O.hybrid_apply_plain(k, v, True),
            errs[k.kind]["backsub"][0], errs[k.kind]["backsub"][0], bms, by,
            {"kind": label, "backsub": True, "operations": ops,
             "bytes": nbytes, "bit_equal_to_first_design": True,
             "launches_from": "the dense run", "library": "none"}, 20,
            "yardstick: P's first design")
    # one product over both kinds: v read once and the output written once
    ops = work["line"][0] + work["point"][0]
    nbytes = work["line"][1] + work["point"][1] - 8 * D
    bms, by = bound(ops, nbytes)
    product = O.product_fn(tl, tp, "cuda")
    both = product(v)
    # against the plain product in float64 on the same terms, as
    # check_terms holds each kind's
    ref = O.hybrid_apply_both_plain(HC._to64(tl), HC._to64(tp), v.double())
    err = float((both.double() - ref).abs().max())
    entries += yard_entries(
        f"hybrid_apply_both ({system}, CG's product)",
        f"hybrid_apply_scan ({system}, CG's product: a launch a kind)",
        "refine", O_SOURCE, P_REPLACES,
        run["hybrid_apply"].get("line+point, apply", 0),
        lambda: product(v),
        lambda: O.hybrid_apply_scan(tl, v) + O.hybrid_apply_scan(tp, v),
        lambda: O.hybrid_apply_both_plain(tl, tp, v), err, err, bms, by,
        {"kind": system, "line_tracks": int(tl.img.shape[0]),
         "point_tracks": int(tp.img.shape[0]),
         "weighted": int((tl.weight > 0).sum() + (tp.weight > 0).sum()),
         "operations": ops, "bytes": nbytes, "split_ms": split,
         "bit_equal_to_first_design": True, "launches_from": "the CG run",
         "max_abs_err_against": "the plain product in float64",
         "product_max_abs": float(ref.abs().max()), "library": "none"}, 20,
        "yardstick: P's first design, one launch a kind "
        "and the sum in torch")
    return entries


def refine_ba_inputs(scene, out):
    """Phase 14's BA inputs, kept for phase 17: the noisy collection, the
    point tracks, the line map and the GT collection."""
    from limap_tpu_torch.runners.hypersim.refine_sfm import \
        read_colmap_inputs
    from limap_tpu_torch.testing import refine
    imagecols, pointtracks = read_colmap_inputs(scene["model"],
                                                scene["image_dir"])
    return (imagecols, pointtracks, out["linetracks_in"],
            refine.imagecols_gt_read(scene))


def refine_clis(scene, direct, workdir, card):
    """Phase 14's CLIs in process on the façade: visualsfm_triangulation
    on the GT model converted by scripts/convert_model.py and
    bundler_triangulation on a Bundler model written by
    testing/refine.py::write_bundler, each against the direct call of
    line_triangulation on the GT model (the phase-7 gates), with the
    cameras read back within 1e-6 of the written ones."""
    from limap_tpu_torch.pointsfm import ReadInfos
    from limap_tpu_torch.pointsfm.readers import (ReadModelBundler,
                                                  ReadModelVisualSfM,
                                                  fill_principal_points)
    from limap_tpu_torch.runners import (bundler_triangulation,
                                         visualsfm_triangulation)
    from limap_tpu_torch.scripts import convert_model
    from limap_tpu_torch.testing import pipeline, refine

    gt_cols = refine.imagecols_gt_read(scene)
    ref = pipeline.quality_eval(direct, scene["gt"])
    ref["n_tracks_all"] = len(direct)
    log(f"[refine cli] direct line_triangulation on the GT model: "
        f"{len(direct)} tracks; {json.dumps(ref)}")

    def cameras_agree(cols, what):
        worst = 0.0
        for i in gt_cols.get_img_ids():
            a, b = cols.camview(i), gt_cols.camview(i)
            for x, y in ((a.cam.kvec(), b.cam.kvec()),
                         (a.pose.qvec * np.sign(a.pose.qvec[0]),
                          b.pose.qvec * np.sign(b.pose.qvec[0])),
                         (a.pose.tvec, b.pose.tvec)):
                worst = max(worst, float(np.abs(np.asarray(x) - y).max()
                                         / max(np.abs(y).max(), 1.0)))
        log(f"[refine cli] {what}: cameras read back within {worst:.2e} "
            f"(relative) of the written ones")
        check(worst <= 1e-6, (what, "cameras read back", worst))

    def run_cli(what, module, argv):
        cfg_file = os.path.join(workdir, f"{what}.json")
        with open(cfg_file, "w") as f:
            json.dump(pipeline.runner_config(os.path.join(workdir, what)), f)
        t0 = time.perf_counter()
        tracks = module.main(argv + ["-c", cfg_file, "--device", "cuda"])
        q = pipeline.quality_eval(tracks, scene["gt"])
        q["n_tracks_all"] = len(tracks)
        log(f"[refine cli] {what}: {len(tracks)} tracks in "
            f"{time.perf_counter() - t0:.2f} s; {json.dumps(q)}")
        check(np.isfinite([t.line for t in tracks]).all(), (what, "finite"))
        hold_to_gates(f"refine cli {what}", q, ref, CLI_GATES)

    # VisualSfM: the GT model converted into the image folder
    convert_model.main(["-i", scene["model_gt"], "-o", scene["image_dir"],
                        "--type", "colmap2vsfm"])
    cols, _ = ReadModelVisualSfM(scene["image_dir"])
    fill_principal_points(cols)
    cameras_agree(cols, "visualsfm")
    run_cli("visualsfm", visualsfm_triangulation,
            ["-a", scene["image_dir"]])
    # Bundler
    refine.write_bundler(scene["image_dir"],
                         ReadInfos(scene["model_gt"]), scene["points3d"])
    cols, _ = ReadModelBundler(scene["image_dir"], "bundle.list.txt",
                               "bundle.out")
    fill_principal_points(cols)
    cameras_agree(cols, "bundler")
    run_cli("bundler", bundler_triangulation,
            ["-a", scene["image_dir"], "-l", "bundle.list.txt", "-m",
             "bundle.out"])


# the CLIs read the same cameras (within 1e-6) and points as the direct
# call: the phase-7 gates against the direct call's quality
CLI_GATES = FROM_PIXELS_GATES[2:]


def localization_cli(scene, tracks, direct, workdir, card):
    """Phase 14's localization CLI in process on phase 8's map and
    queries, written as the CLI's files (COLMAP models of the database
    and the queries with their priors, the map's folder, the point
    correspondences, the retrieval): each pose against phase 8's direct
    call within the phase-8 tolerances."""
    from limap_tpu_torch.pointsfm import write_model_txt
    from limap_tpu_torch.runners import localization
    from limap_tpu_torch.util import io as limapio
    q, cfg, poses = direct["q"], direct["cfg"], direct["poses"]
    folder = os.path.join(workdir, "loc_cli")
    write_model_txt(os.path.join(folder, "db"), scene[0])
    write_model_txt(os.path.join(folder, "query"), q["imagecols"])
    limapio.save_folder_linetracks_with_info(os.path.join(folder, "map"),
                                             tracks)
    np.savez(os.path.join(folder, "corresp.npz"),
             **{f"{k}_{qid}": v for qid, (p3, p2) in q["points"].items()
                for k, v in (("p3ds", p3), ("p2ds", p2))})
    with open(os.path.join(folder, "retrieval.txt"), "w") as f:
        for qid, ids in q["retrieval"].items():
            f.write(" ".join(map(str, [qid] + list(ids))) + "\n")
    cfg_file = os.path.join(folder, "cfg.json")
    with open(cfg_file, "w") as f:
        json.dump(dict(cfg, output_dir=os.path.join(folder, "out")), f)
    t0 = time.perf_counter()
    cli = localization.main([
        "--db_model", os.path.join(folder, "db"),
        "--query_model", os.path.join(folder, "query"),
        "--linemap", os.path.join(folder, "map"),
        "--point_corresp", os.path.join(folder, "corresp.npz"),
        "--retrieval", os.path.join(folder, "retrieval.txt"),
        "--results_path", os.path.join(folder, "results.txt"),
        "-c", cfg_file, "--device", "cuda"])
    secs = time.perf_counter() - t0
    diffs = {qid: pose_difference(cli[qid], poses[qid]) for qid in poses}
    worst = (max(d[0] for d in diffs.values()),
             max(d[1] for d in diffs.values()))
    log(f"[refine cli] localization: {len(cli)} queries in {secs:.2f} s on "
        f"{card}; poses from phase 8's direct call within {worst[0]:.2e} m, "
        f"{worst[1]:.2e} deg")
    check(sorted(cli) == sorted(poses), ("localization CLI queries",
                                         sorted(cli), sorted(poses)))
    check(worst[0] <= LOC_POSE_TOL_M and worst[1] <= LOC_POSE_TOL_DEG,
          ("localization CLI poses against the direct call", worst))


# ---------------------------------------------------------------- phase 15
R_SOURCE = "log_sinkhorn.cu"
R_REPLACES = "limap_tpu/point2d/matching.py:19"
S_SOURCE = "sample_descriptors.cu"
S_REPLACES = ("limap_tpu/point2d/superpoint.py:90; "
              "limap_tpu/line2d/sold2/sold2.py:182")
TU_SOURCE = "sold2_lines.cu"
T_REPLACES = "limap_tpu/line2d/sold2/detection.py:155 (with :278, :241)"
U_REPLACES = "limap_tpu/line2d/sold2/detection.py:301"
# The JAX package's CPU run of the Sinkhorn runner on the first 16 views of
# phase 7's scene (tests/torch_port_reference_gates.py --sinkhorn 16), and
# of SOLD2's detector on the GT heatmaps of its first 4 views (--sold2-gt
# 4): chip_smoke phase 15's quality floors.
SINKHORN_VIEWS = 16
REFERENCE_SINKHORN = {
    "n_tracks_all": 234, "n_matches": 27554, "n_tracks": 199,
    "recall_0.05": 134.72836224550758, "precision_0.05": 98.99497487437185,
    "gt_coverage_0.05": 50.26047503722941}
# the from-pixels gates (the port's CPU run of this path lands within
# them: 236 tracks, 27,559 matches, 200 of >= 4 images, recall 134.19,
# precision 99.0, coverage 50.06)
SINKHORN_GATES = tuple(g for g in FROM_PIXELS_GATES if g[0] != "avg_segs")
SOLD2_GT_VIEWS = 4
REFERENCE_SOLD2_GT_RECALL = [0.6881720430107527, 0.6923076923076923,
                             0.6956521739130435, 0.6923076923076923]
# The port's detector repeats the reference's float64 arithmetic, so its
# recall on a view may fall below the reference's only by a segment or
# two whose suppression test sits within rounding of its tolerance.
SOLD2_GT_SLACK = 0.02
# Card against CPU on the learned front end.  The networks' fp32
# convolutions and products round differently on the two devices (TF32
# off): maps within LEARNED_MAP_RTOL of their largest value; a keypoint on
# one device only must be a near tie (its score within KP_TIE_EPS of a
# neighbour's in the NMS window, of the threshold or of the top-k cut); a
# match on one device only must be a near tie of the optimal transport
# (its row's two best entries within OT_TIE_EPS in the log domain, or its
# probability within OT_TIE_EPS of the threshold).
LEARNED_MAP_RTOL = 1e-4
KP_TIE_EPS = 1e-6
OT_TIE_EPS = 1e-3
LEARNED_DESC_TOL = 1e-4


def learned_kernels():
    from limap_tpu_torch.ops import log_sinkhorn, sample_descriptors
    from limap_tpu_torch.ops import sold2_lines
    return {"log_sinkhorn": log_sinkhorn.log_sinkhorn,
            "sample_descriptors": sample_descriptors.sample_descriptors,
            "sold2_candidates": sold2_lines.sold2_candidates,
            "sold2_refine_junctions": sold2_lines.sold2_refine_junctions}


def reset_learned_launches():
    for k in learned_kernels().values():
        k.launches = 0


def learned_launches():
    return {name: k.launches for name, k in learned_kernels().items()}


def keypoint_differences(a, b, heat_a, heat_b, threshold, radius, cut):
    """(keypoints of ``a`` [N, 2] missing from ``b``, of them not a near
    tie): a tie where, on either device's score map, the keypoint's score
    is within KP_TIE_EPS of another in its NMS window, of ``threshold`` or
    of the top-k ``cut``."""
    sb = set(map(tuple, np.asarray(b, np.int64).tolist()))
    missing = [p for p in np.asarray(a, np.int64).tolist()
               if tuple(p) not in sb]
    bad = []
    for x, y in missing:
        tie = False
        for heat in (heat_a, heat_b):
            v = heat[y, x]
            win = heat[max(y - radius, 0):y + radius + 1,
                       max(x - radius, 0):x + radius + 1].copy()
            win[min(y, radius), min(x, radius)] = -np.inf
            tie |= (win.max() >= v - KP_TIE_EPS
                    or abs(v - threshold) <= KP_TIE_EPS
                    or abs(v - cut) <= KP_TIE_EPS)
        if not tie:
            bad.append((x, y))
    return missing, bad


def ot_match_differences(Za, Zb, ma, mb, threshold):
    """Rows whose match differs between two OT results (m0 of
    superglue.get_matches), and of them those that are not a near tie in
    either assignment."""
    rows = np.nonzero(ma != mb)[0]
    bad = []
    for i in rows:
        tie = False
        for Z in (Za, Zb):
            r = np.sort(Z[i, :-1])
            tie |= len(r) > 1 and r[-1] - r[-2] <= OT_TIE_EPS
            tie |= abs(np.exp(r[-1]) - threshold) <= OT_TIE_EPS
            col = [m for m in (ma[i], mb[i]) if m >= 0]
            tie |= any(abs(Z[i, c] - r[-1]) <= OT_TIE_EPS for c in col)
            tie |= any(np.sort(Z[:-1, c])[-1] - Z[i, c] <= OT_TIE_EPS
                       for c in col)
        if not tie:
            bad.append(int(i))
    return rows, bad


def hold_superglue(what, sg_card, sg_cpu, data, threshold=None):
    """SuperGlue card against CPU on one pair: raw scores, the OT and the
    matches at ``threshold`` (the model's by default).  Returns (raw, Z)
    on the card."""
    from limap_tpu_torch.point2d.superglue import get_matches
    if threshold is None:
        threshold = sg_card.match_threshold
    raw_g = sg_card.scores(data)
    raw_c = sg_cpu.scores(data)
    err = float((raw_g.cpu() - raw_c).abs().max())
    scale = float(raw_c.abs().max())
    Zg = sg_card.solve_optimal_transport(raw_g)
    Zc = sg_cpu.solve_optimal_transport(raw_c)
    mg, mc = get_matches(Zg, threshold)[0], get_matches(Zc, threshold)[0]
    rows, bad = ot_match_differences(Zg.cpu().numpy(), Zc.cpu().numpy(),
                                     mg, mc, threshold)
    log(f"[learned card-vs-cpu] {what}: {raw_g.shape[0]} x {raw_g.shape[1]}"
        f" keypoints, raw scores max abs err {err:.3e} (of {scale:.3e}); "
        f"OT max abs err {float((Zg.cpu() - Zc).abs().max()):.3e}; "
        f"{int((mg >= 0).sum())} and {int((mc >= 0).sum())} matches, "
        f"{len(rows)} rows differ, {len(bad)} not a near tie")
    zerr = float((Zg.cpu() - Zc).abs().max())
    check(err <= LEARNED_MAP_RTOL * scale, (what, "raw scores", err, scale))
    # the OT moves by no more than its scores and its own rounding
    check(zerr <= 2 * LEARNED_MAP_RTOL * scale + 1e-4, (what, "OT", zerr))
    check(not bad, (what, "matches differ", bad[:10]))
    return raw_g, Zg


def superpoint_card_vs_cpu(what, sp_card, sp_cpu, img):
    """SuperPoint card against CPU on one image: the score map, the
    descriptor grid, the keypoints as sets (near ties excused) and the
    common keypoints' descriptors."""
    fg, fc = sp_card(img), sp_cpu(img)
    hg, dg = (t.cpu().numpy() for t in sp_card._forward(img))
    hc, dc = (t.cpu().numpy() for t in sp_cpu._forward(img))
    herr = float(np.abs(hg - hc).max())
    derr = float(np.abs(dg - dc).max())
    cut = float(fc["scores"][-1]) if len(fc["scores"]) \
        >= sp_cpu.max_keypoints else -1.0
    miss_g, bad_g = keypoint_differences(fc["keypoints"], fg["keypoints"],
                                         hc, hg, sp_cpu.keypoint_threshold,
                                         sp_cpu.nms_radius, cut)
    miss_c, bad_c = keypoint_differences(fg["keypoints"], fc["keypoints"],
                                         hg, hc, sp_cpu.keypoint_threshold,
                                         sp_cpu.nms_radius, cut)
    common = {tuple(p): i for i, p in enumerate(
        np.asarray(fc["keypoints"], np.int64).tolist())}
    pairs = [(i, common[tuple(p)]) for i, p in enumerate(
        np.asarray(fg["keypoints"], np.int64).tolist()) if tuple(p) in common]
    kerr = float(np.abs(fg["descriptors"][[i for i, _ in pairs]]
                        - fc["descriptors"][[j for _, j in pairs]]).max()) \
        if pairs else 0.0
    log(f"[learned card-vs-cpu] {what}: score map max abs err {herr:.3e}, "
        f"descriptor grid {derr:.3e}; {len(fg['keypoints'])} and "
        f"{len(fc['keypoints'])} keypoints, {len(miss_g)} missing on the "
        f"card and {len(miss_c)} on the CPU ({len(bad_g) + len(bad_c)} not "
        f"a near tie); common keypoints' descriptors {kerr:.3e}")
    check(herr <= LEARNED_MAP_RTOL * float(np.abs(hc).max()),
          (what, "score map", herr))
    check(derr <= LEARNED_DESC_TOL, (what, "descriptor grid", derr))
    check(not bad_g and not bad_c, (what, "keypoints", bad_g[:5], bad_c[:5]))
    check(kerr <= LEARNED_DESC_TOL, (what, "keypoint descriptors", kerr))
    return fg


def shuffled_pair(fa, fb, n, n_copy, n_other, seed=0):
    """Two keypoint sets that SuperGlue can match on random weights:
    the first ``n`` of ``fa`` with random unit descriptors, against a
    shuffled copy of ``n_copy`` of them and the first ``n_other`` of
    ``fb`` with descriptors of their own (random SuperPoint descriptors
    are all alike, and a pair of them would match nothing).  Returns
    (f0, f1, expected m0: a row's copy in f1, or -1)."""
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(n + n_other, 256))
    desc = (desc / np.linalg.norm(desc, axis=1, keepdims=True)).astype(
        np.float32)
    perm = rng.permutation(n)[:n_copy]
    f0 = {k: v[:n] for k, v in fa.items()}
    f0["descriptors"] = desc[:n]
    f1 = {k: np.concatenate([v[:n][perm], fb[k][:n_other]])
          for k, v in fa.items()}
    f1["descriptors"] = np.concatenate([desc[:n][perm], desc[n:]])
    expected = np.full(n, -1, np.int64)
    expected[perm] = np.arange(n_copy)
    return f0, f1, expected


def shuffled_lines(info, seed=0):
    """An endpoint descinfo with random unit descriptors, and a copy of it
    with its lines in a shuffled order (each line's two endpoints kept
    together); returns (descinfo, copy, expected: a line's copy)."""
    rng = np.random.default_rng(seed)
    n = len(info["lines_score"])
    desc = rng.normal(size=(256, 2 * n))
    desc = (desc / np.linalg.norm(desc, axis=0, keepdims=True)).astype(
        np.float32)
    perm = rng.permutation(n)
    cols = (2 * perm[:, None] + np.arange(2)).reshape(-1)
    lines = np.asarray(info["lines"], np.float32)
    a = dict(info, endpoints_desc=desc)
    b = dict(info, lines=lines[cols], endpoints_desc=desc[:, cols],
             lines_score=np.asarray(info["lines_score"])[perm])
    expected = np.empty(n, np.int64)
    expected[perm] = np.arange(n)
    return a, b, expected


def check_recovered(what, m0, expected, floor):
    """At least ``floor`` rows matched to their own copy, no row with a
    copy matched elsewhere and no copy taken by another row (a row
    without a copy may match one of the other view's keypoints)."""
    copies = int((expected >= 0).sum())
    got = m0 >= 0
    right = int((got & (m0 == expected)).sum())
    wrong = int((got & (m0 != expected)
                 & ((expected >= 0) | (m0 < copies))).sum())
    log(f"[learned card-vs-cpu] {what}: {int(got.sum())} matches, {right} "
        f"of {copies} copies recovered, {wrong} wrong")
    check(right >= floor and wrong == 0,
          (what, "the shuffled copy not recovered", right, wrong))


def pair_data(f0, f1, shape):
    return {"image_shape0": shape, "image_shape1": shape,
            "keypoints0": f0["keypoints"], "keypoints1": f1["keypoints"],
            "scores0": f0["scores"], "scores1": f1["scores"],
            "descriptors0": f0["descriptors"].T,
            "descriptors1": f1["descriptors"].T}


def sold2_card_vs_cpu(imgs):
    """Phase 15a's SOLD2 part at 128 x 128: the forward pass card against
    CPU, the junctions, then the detector of both devices on the CPU's
    junctions and heatmap (T's flags; U on the first REFINE_SUBSET
    segments, bit for bit), the line descriptors and Wunsch matching."""
    from limap_tpu_torch.line2d.sold2 import detection as det_mod
    from limap_tpu_torch.line2d.sold2.sold2 import SOLD2Engine
    from limap_tpu_torch.ops import sold2_lines as TU
    from limap_tpu_torch.testing import learned_checks
    eng_g = SOLD2Engine(seed=0, device="cuda")
    eng_c = SOLD2Engine(seed=0, device="cpu")
    descinfos = {}
    for k, img in imgs.items():
        og, _ = eng_g.forward(img)
        oc, _ = eng_c.forward(img)
        errs = {m: float(np.abs(og[m] - oc[m]).max() / np.abs(oc[m]).max())
                for m in og}
        jg = det_mod.junctions_from_predictions(og["junctions"])
        jc = det_mod.junctions_from_predictions(oc["junctions"])
        same_j = np.array_equal(jg, jc)
        check(max(errs.values()) <= LEARNED_MAP_RTOL,
              ("SOLD2 forward card vs CPU", errs))
        heat = eng_c.line_detector.refined_heatmap(
            det_mod.heatmap_from_logits(oc["heatmap"]))
        si, ei = np.triu_indices(len(jc), 1)
        prm = eng_c.line_detector.candidate_params()
        args = (torch.as_tensor(jc), torch.as_tensor(si.astype(np.int32)),
                torch.as_tensor(ei.astype(np.int32)))
        tc = TU.sold2_candidates(torch.as_tensor(heat), *args, 64, prm)
        tg = TU.sold2_candidates(torch.as_tensor(heat, device="cuda"),
                                 *(a.cuda() for a in args), 64, prm)
        res = learned_checks.compare_candidates(tg, tc, prm.detect_thresh)
        check(res["ok"], ("T card vs CPU", res))
        keep = tc[0].numpy()
        segs = np.stack([jc[si[keep]], jc[ei[keep]]], 1)
        sub = torch.as_tensor(segs[:REFINE_SUBSET])
        ug = TU.sold2_refine_junctions(sub.cuda(), torch.as_tensor(
            heat, device="cuda")).cpu()
        uc = TU.sold2_refine_junctions(sub, torch.as_tensor(heat))
        check(torch.equal(ug, uc), ("U card vs CPU", float(
            (ug - uc).abs().max())))
        full = eng_g.line_detector.detect(jc, det_mod.heatmap_from_logits(
            oc["heatmap"]))
        dg = eng_g.matcher.compute_descriptors(full, og["descriptors"])
        dc = eng_c.matcher.compute_descriptors(full, oc["descriptors"])
        derr = float(np.abs(dg[0] - dc[0]).max()) if len(full) else 0.0
        check(derr <= LEARNED_DESC_TOL, ("SOLD2 line descriptors", derr))
        descinfos[k] = (dc, full)
        log(f"[learned card-vs-cpu] SOLD2 view {k} at {img.shape}: forward "
            f"relative errors {json.dumps(errs)}; junctions {len(jg)} and "
            f"{len(jc)} (equal {same_j}); T on the CPU's {len(si)} "
            f"candidates {json.dumps(res)}; U on {len(sub)} of "
            f"{len(segs)} segments bit-equal; the card's detector on the "
            f"CPU's junctions: {len(full)} segments; line descriptors "
            f"{derr:.3e}")
    (d0, s0), (d1, s1) = descinfos[0], descinfos[1]
    if len(s0) and len(s1):
        mg = eng_g.matcher.compute_matches(d0, d1)
        mc = eng_c.matcher.compute_matches(d0, d1)
        agree = float((mg == mc).mean())
        log(f"[learned card-vs-cpu] Wunsch matching {len(s0)} x {len(s1)} "
            f"lines: {int((mg >= 0).sum())} and {int((mc >= 0).sum())} "
            f"matches, equal on a share {agree:.4f}")
        check(agree >= 1.0 - MATCH_DIFF_SHARE - 1e-9,
              ("Wunsch matches card vs CPU", agree))


REFINE_SUBSET = 32
# Phase 15's shuffled copy: 1,792 of view 0's 2,048 keypoints.  On the
# random checkpoint the OT spreads a row's mass over the 2,048 columns, so
# that hardly a row's best probability reaches the published 0.2:
# get_matches decides at SHUFFLED_THRESHOLD, which keeps about two thirds
# of the copies (hold_superglue logs both devices' counts), and the check
# asks for SHUFFLED_FLOOR of them, each its own copy.
SHUFFLED_COPIES = 1792
SHUFFLED_THRESHOLD = 0.01
SHUFFLED_FLOOR = 1000


def learned_card_vs_cpu():
    """Phase 15a: R, S, T and U against their plain versions on seeded
    inputs; SuperPoint at 120 x 160, SuperGlue on 64 x 80 keypoints and
    SOLD2 at 128 x 128 on the card against the CPU."""
    from limap_tpu_torch.point2d.superglue import SuperGlue, get_matches
    from limap_tpu_torch.point2d.superpoint import SuperPoint
    from limap_tpu_torch.testing import learned, learned_checks, pipeline
    t0 = time.perf_counter()
    n0 = learned_launches()
    for name, case, res in learned_checks.check_all():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    n1 = learned_launches()
    check(all(n1[k] > n0[k] for k in n0), ("R, S, T, U launches counted",
                                          n0, n1))
    scene = pipeline.build_scene(n_views=2, hw=(120, 160))
    sp_g, sp_c = SuperPoint(device="cuda"), SuperPoint(device="cpu")
    feats = [superpoint_card_vs_cpu(f"SuperPoint view {k} at 120 x 160",
                                    sp_g, sp_c, scene[1][k])
             for k in (0, 1)]
    sd = learned.superglue_random_state_dict(0)
    sg_g, sg_c = SuperGlue(device="cuda"), SuperGlue(device="cpu")
    from limap_tpu_torch.point2d.superglue import params_from_state_dict
    sg_g.params = params_from_state_dict(sd, "cuda")
    sg_c.params = params_from_state_dict(sd, "cpu")
    # the first view's 64 strongest keypoints against a shuffled copy of
    # them and 16 of the second view's
    f0, f1, expected = shuffled_pair(feats[0], feats[1], 64, 64, 16)
    check(len(f0["keypoints"]) == 64 and len(f1["keypoints"]) == 80,
          ("SuperGlue keypoints", len(f0["keypoints"]),
           len(f1["keypoints"])))
    _, Z = hold_superglue("SuperGlue 64 x 80", sg_g, sg_c,
                          pair_data(f0, f1, (120, 160)))
    check_recovered("SuperGlue 64 x 80", get_matches(Z)[0], expected, 10)
    scene = pipeline.build_scene(n_views=2, hw=(128, 128))
    sold2_card_vs_cpu({k: scene[1][k] for k in (0, 1)})
    log(f"[learned card-vs-cpu] phase 15a took "
        f"{time.perf_counter() - t0:.1f} s")


def learned_points_full_width(scene, ckpt, card):
    """Phase 15's first path: SuperPoint and SuperGlue from the random
    checkpoints on two of phase 7's views at 600 x 800 (at most 2,048
    keypoints, 18 GNN layers, 100 Sinkhorn iterations), card against CPU.
    Returns the launches and the recorded inputs of R and S."""
    from limap_tpu_torch.point2d import superglue as sgm
    from limap_tpu_torch.point2d import superpoint as spm
    from limap_tpu_torch.point2d.superpoint import SuperPoint
    imgs = scene[1]
    sp_g = SuperPoint(weight_path=ckpt["superpoint"], device="cuda")
    sg_g = sgm.SuperGlue(weight_path=ckpt["superglue"], device="cuda")
    rec_s = Recorder(spm, "_sample_descriptors", lambda g, p, *a, **k:
                     p.shape[0])
    sp_g(imgs[0])                       # warm-up of the libraries
    reset_learned_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        f0, f1 = sp_g(imgs[0]), sp_g(imgs[1])
        torch.cuda.synchronize()
        t_sp = time.perf_counter() - t0
        data = pair_data(f0, f1, imgs[0].shape)
        out = sg_g(data)
        torch.cuda.synchronize()
    finally:
        rec_s.restore()
    wall = time.perf_counter() - t0
    launches = learned_launches()
    log(f"[learned] SuperPoint + SuperGlue on views 0 and 1 at "
        f"{imgs[0].shape}: {len(f0['keypoints'])} and "
        f"{len(f1['keypoints'])} keypoints, "
        f"{int((out['matches0'] >= 0).sum())} matches; {wall:.3f} s "
        f"({t_sp:.3f} s the two SuperPoint passes) on {card}; launches "
        f"{json.dumps(launches)}")
    check(len(f0["keypoints"]) == len(f1["keypoints"]) == 2048,
          ("SuperPoint keypoints at full width", len(f0["keypoints"])))
    check(launches["log_sinkhorn"] > 0 and
          launches["sample_descriptors"] > 0,
          ("the SuperPoint + SuperGlue path did not launch R and S",
           launches))
    sp_c = SuperPoint(weight_path=ckpt["superpoint"], device="cpu")
    superpoint_card_vs_cpu("SuperPoint view 0 at 600 x 800", sp_g, sp_c,
                           imgs[0])
    sg_c = sgm.SuperGlue(weight_path=ckpt["superglue"], device="cpu")
    raw, _ = hold_superglue("SuperGlue 2048 x 2048", sg_g, sg_c, data)
    # the random weights match nothing on the two views, so 15a's shuffled
    # copy at full width: view 0's 2,048 keypoints against 1,792 of them
    # shuffled and 256 of view 1's, where get_matches decides matches
    s0, s1, expected = shuffled_pair(f0, f1, 2048, SHUFFLED_COPIES,
                                     2048 - SHUFFLED_COPIES)
    _, Zs = hold_superglue("SuperGlue 2048 x 2048 on a shuffled copy", sg_g,
                           sg_c, pair_data(s0, s1, imgs[0].shape),
                           SHUFFLED_THRESHOLD)
    check_recovered("SuperGlue 2048 x 2048 on a shuffled copy",
                    sgm.get_matches(Zs, SHUFFLED_THRESHOLD)[0], expected,
                    SHUFFLED_FLOOR)
    bin_score = float(sg_g.params["bin_score"])
    return [("log_sinkhorn", "superglue", (raw, bin_score,
                                           sg_g.sinkhorn_iterations),
             launches["log_sinkhorn"]),
            ("sample_descriptors", "superpoint", rec_s.args,
             launches["sample_descriptors"])]


def sinkhorn_runner_full_width(workdir, card):
    """Phase 15's second path: the from-pixels runner with tpu_lsd,
    patch_endpoints and the weight-free sinkhorn_endpoints matcher (every
    pair through kernel R) on the first SINKHORN_VIEWS views of phase 7's
    scene, gated on quality against the JAX package's run."""
    from limap_tpu_torch.point2d import matching
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import learned, pipeline
    from limap_tpu_torch.util import io as limapio
    imagecols, _, nbrs, gt = pipeline.build_scene(
        SINKHORN_VIEWS, image_dir=os.path.join(workdir, "images"))
    cfg = learned.sinkhorn_runner_config(os.path.join(workdir, "out"),
                                         n_neighbors=len(nbrs[0]))
    rec = Recorder(matching, "_log_sinkhorn",
                   lambda s, *a, **k: s.numel())
    shapes = Counter()
    counter = ShapeCounter(matching, "_log_sinkhorn", shapes)
    reset_learned_launches()
    t0 = time.perf_counter()
    try:
        tracks = line_triangulation(cfg, imagecols, nbrs, device="cuda")
    finally:
        counter.restore()
        rec.restore()
    wall = time.perf_counter() - t0
    launches = learned_launches()
    log_r_shapes("the Sinkhorn runner", shapes)
    out = cfg["dir_save"]
    with open(os.path.join(out, "metrics.json")) as f:
        stages = json.load(f)["stages_s"]
    segs = limapio.read_all_segments_from_folder(os.path.join(
        out, "line_detections", "tpu_lsd", "segments"))
    matches_dir = os.path.join(out, "line_matchings", "tpu_lsd",
                               "feats_patch_endpoints",
                               "matches_sinkhorn_endpoints")
    n_matches = sum(len(m) for i in nbrs for m in np.load(
        os.path.join(matches_dir, f"matches_{i}.npy"),
        allow_pickle=True).item().values())
    quality = pipeline.quality_eval(tracks, gt)
    measured = dict(quality, n_tracks_all=len(tracks), n_matches=n_matches,
                    avg_segs=float(np.mean([len(v) for v in segs.values()])))
    log(f"[sinkhorn runner] {SINKHORN_VIEWS} views, {wall:.3f} s; stage "
        f"seconds {json.dumps(stages)} on {card}; launches "
        f"{json.dumps(launches)}; {n_matches} matches, {len(tracks)} "
        f"tracks; quality_eval {json.dumps(quality)}")
    n_pairs = sum(len(v) for v in nbrs.values())
    check(launches["log_sinkhorn"] == n_pairs,
          ("one Sinkhorn launch a pair", launches, n_pairs))
    check(np.isfinite([x.line for x in tracks]).all(),
          "non-finite lines from the Sinkhorn runner")
    hold_to_gates("sinkhorn runner", measured, REFERENCE_SINKHORN,
                  SINKHORN_GATES)
    return [("log_sinkhorn", "sinkhorn_runner", rec.args,
             launches["log_sinkhorn"])]


def learned_localization(scene, tracks, q, ckpt, workdir, card):
    """Phase 15's third path: the localization runner with the
    superglue_endpoints matcher (SuperPoint endpoints, SuperGlue, OT on
    the line scores) on phase 8's map and queries; the pose errors
    logged; descinfos, line scores, OT and matches of the first queries'
    pairs and of a query against a shuffled copy of its lines card
    against CPU."""
    from limap_tpu_torch.line2d import get_extractor, get_matcher
    from limap_tpu_torch.line2d.endpoints import _endpoint_line_scores
    from limap_tpu_torch.point2d.superglue import get_matches
    from limap_tpu_torch.testing import localization
    from limap_tpu_torch.util.config import default_localization_config
    from limap_tpu_torch.util.profiler import StageProfiler
    runner = importlib.import_module(
        "limap_tpu_torch.runners.hybrid_localization")
    cfg = default_localization_config()
    cfg["output_dir"] = os.path.join(workdir, "localization_superglue")
    cfg["weight_path"] = ckpt["superpoint"]
    cfg.setdefault("localization", {}).update({
        "2d_matcher": "superglue_endpoints",
        "matcher_options": {"superglue_weight_path": ckpt["superglue"],
                            "topk": 0}})
    from limap_tpu_torch.point2d import matching
    from limap_tpu_torch.point2d import superglue as sgm
    reset_learned_launches()
    prof, stats = StageProfiler(device="cuda"), {}
    shapes = Counter()
    counters = [ShapeCounter(matching, "_log_sinkhorn", shapes),
                ShapeCounter(sgm, "log_sinkhorn", shapes)]
    t0 = time.perf_counter()
    try:
        poses = runner.hybrid_localization(
            cfg, scene[0], q["imagecols"], q["points"], tracks,
            q["retrieval"], device="cuda", prof=prof, stats=stats)
    finally:
        for c in counters[::-1]:
            c.restore()
    wall = time.perf_counter() - t0
    launches = learned_launches()
    log_r_shapes("the superglue_endpoints localization", shapes)
    check(sum(shapes.values()) == launches["log_sinkhorn"],
          ("R's launches by shape", dict(shapes), launches))
    errors = localization.pose_errors(poses, q["gt"])
    log(f"[learned localize] superglue_endpoints: {len(poses)} queries in "
        f"{wall:.3f} s; stage seconds {json.dumps(prof.times)} on {card}; "
        f"launches {json.dumps(launches)}; line matches "
        f"{[stats[i]['n_line_matches'] for i in sorted(stats)]}; "
        f"{json.dumps(localization.summarize(errors))}")
    check(launches["log_sinkhorn"] > 0 and launches["sample_descriptors"] > 0,
          ("the superglue_endpoints localization did not launch R and S",
           launches))
    check(len(poses) == len(q["gt"]), ("queries localized", len(poses)))
    # card against CPU on the first queries' first retrieved views
    ex = {d: get_extractor({"method": "superpoint_endpoints"},
                           weight_path=ckpt["superpoint"], device=d)
          for d in ("cuda", "cpu")}
    mt = {d: get_matcher({"method": "superglue_endpoints", "topk": 0,
                          "superglue_weight_path": ckpt["superglue"]},
                         ex[d], device=d) for d in ("cuda", "cpu")}
    seg_cfg = runner.runners.setup(dict(cfg, output_dir=os.path.join(
        workdir, "localization_superglue_check")))
    views = {}
    for q_id in sorted(q["retrieval"])[:2]:
        for db_id in [q_id] + list(q["retrieval"][q_id][:2]):
            views[db_id] = q["imagecols"] if db_id == q_id else scene[0]
    segs = {}
    for ic in (scene[0], q["imagecols"]):
        sub_ids = [i for i in views if i in ic.get_img_ids()]
        got, _ = runner.runners.compute_2d_segs(
            seg_cfg, ic.subset_by_image_ids(sub_ids), compute_descinfo=False,
            device="cuda")
        segs.update(got)
    desc = {d: {i: ex[d].extract(views[i].camview(i), segs[i])
                for i in views} for d in ("cuda", "cpu")}
    derr = max(float(np.abs(desc["cuda"][i]["endpoints_desc"]
                            - desc["cpu"][i]["endpoints_desc"]).max())
               for i in views)
    check(derr <= LEARNED_DESC_TOL, ("endpoint descriptors card vs CPU",
                                     derr))

    def line_ot(d1, d2, d):
        data = {"image_shape0": d1["image_shape"],
                "image_shape1": d2["image_shape"],
                "keypoints0": np.asarray(d1["lines"], np.float32),
                "keypoints1": np.asarray(d2["lines"], np.float32),
                "scores0": np.repeat(d1["lines_score"], 2),
                "scores1": np.repeat(d2["lines_score"], 2),
                "descriptors0": d1["endpoints_desc"],
                "descriptors1": d2["endpoints_desc"]}
        n1 = d1["endpoints_desc"].shape[1] // 2
        n2 = d2["endpoints_desc"].shape[1] // 2
        ls = _endpoint_line_scores(mt[d].sg.scores(data), n1, n2)
        return ls.cpu().numpy(), \
            mt[d].sg.solve_optimal_transport(ls).cpu().numpy()

    # the same (card) descinfos through both devices' matcher: four
    # query-database pairs, on which the random weights match nothing,
    # and the first query against a shuffled copy of its lines with
    # random unit descriptors, where the OT decides matches
    first = sorted(q["retrieval"])[0]
    shuf0, shuf1, expected = shuffled_lines(desc["cuda"][first])
    pairs = [(f"{q_id}-{db_id}", desc["cuda"][q_id], desc["cuda"][db_id])
             for q_id in sorted(q["retrieval"])[:2]
             for db_id in q["retrieval"][q_id][:2]]
    pairs.append((f"{first} and its shuffled copy", shuf0, shuf1))
    thr = mt["cpu"].sg.match_threshold
    n_rows = n_bad = 0
    for what, d1, d2 in pairs:
        (ls_g, Z_g), (ls_c, Z_c) = (line_ot(d1, d2, d)
                                    for d in ("cuda", "cpu"))
        m_g, m_c = get_matches(Z_g, thr)[0], get_matches(Z_c, thr)[0]
        scale = float(np.abs(ls_c).max())
        lerr = float(np.abs(ls_g - ls_c).max())
        zerr = float(np.abs(Z_g - Z_c).max())
        rows, bad = ot_match_differences(Z_g, Z_c, m_g, m_c, thr)
        log(f"[learned localize] line OT card vs CPU, pair {what}: "
            f"{ls_c.shape[0]} x {ls_c.shape[1]} lines, line scores max abs "
            f"err {lerr:.3e} (of {scale:.3e}), OT {zerr:.3e}; "
            f"{int((m_g >= 0).sum())} and {int((m_c >= 0).sum())} matches, "
            f"{len(rows)} rows differ, {len(bad)} not a near tie")
        check(lerr <= LEARNED_MAP_RTOL * scale, (what, "line scores", lerr))
        check(zerr <= 2 * LEARNED_MAP_RTOL * scale + 1e-4,
              (what, "line OT", zerr))
        n_rows += len(rows)
        n_bad += len(bad)
    log(f"[learned localize] card vs CPU on {len(views)} images' endpoint "
        f"descriptors (max abs err {derr:.3e}) and {len(pairs)} pairs' line "
        f"matches: {n_rows} rows differ, {n_bad} not a near tie")
    check(n_bad == 0, ("superglue_endpoints matches card vs CPU", n_bad))
    # the matcher's own entry point on the card, on the shuffled copy
    pm = mt["cuda"].match_pair(shuf0, shuf1)
    m0 = np.full(len(expected), -1, np.int64)
    m0[pm[:, 0]] = pm[:, 1]
    check_recovered(f"superglue_endpoints on query {first}'s shuffled "
                    f"copy", m0, expected, 10)
    return launches


def sold2_full_width(scene, ckpt, card):
    """Phase 15's fourth path: SOLD2 detect, describe and match on two of
    phase 7's views at 600 x 800 from the random checkpoint (300
    junctions: T and U at full size); then the detector on GT heatmaps of
    SOLD2_GT_VIEWS views, gated on recall against the JAX package's."""
    from limap_tpu_torch.line2d import get_detector, get_extractor, \
        get_matcher
    from limap_tpu_torch.line2d.sold2 import detection as det_mod
    from limap_tpu_torch.testing import learned
    imgs = scene[1]
    det = get_detector({"method": "sold2"}, weight_path=ckpt["sold2"],
                       device="cuda")
    ext = get_extractor({"method": "sold2"}, weight_path=ckpt["sold2"],
                        device="cuda")
    mat = get_matcher({"method": "sold2", "topk": 0}, ext, device="cuda")
    rec_t = Recorder(det_mod, "sold2_candidates",
                     lambda h, j, si, *a, **k: si.shape[0])
    rec_u = Recorder(det_mod, "sold2_refine_junctions",
                     lambda s, *a, **k: s.shape[0])
    eng = importlib.import_module("limap_tpu_torch.line2d.sold2.sold2")
    rec_s = Recorder(eng, "sample_descriptors",
                     lambda g, p, *a, **k: p.shape[0])
    junctions = []
    jf = det_mod.junctions_from_predictions

    def counted(*a, **k):
        out = jf(*a, **k)
        junctions.append(len(out))
        return out

    eng.junctions_from_predictions = counted
    reset_learned_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        views = {}
        for k in (0, 1):
            t1 = time.perf_counter()
            segs, descinfo = det.detect_and_extract(
                _ArrayView(imgs[k]))
            torch.cuda.synchronize()
            views[k] = (segs, descinfo, time.perf_counter() - t1)
        matches = mat.match_pair(views[0][1], views[1][1])
        torch.cuda.synchronize()
    finally:
        for rec in (rec_t, rec_u, rec_s):
            rec.restore()
        eng.junctions_from_predictions = jf
    wall = time.perf_counter() - t0
    launches = learned_launches()
    log(f"[sold2] detect + describe on views 0 and 1 at {imgs[0].shape}: "
        f"{junctions} junctions, {[len(v[0]) for v in views.values()]} "
        f"segments in {[round(v[2], 3) for v in views.values()]} s; "
        f"{len(matches)} Wunsch matches; {wall:.3f} s in all on {card}; "
        f"launches {json.dumps(launches)}")
    check(min(junctions) == 300, ("SOLD2 junctions at full width",
                                  junctions))
    for name in ("sold2_candidates", "sold2_refine_junctions",
                 "sample_descriptors"):
        check(launches[name] > 0, f"the SOLD2 path did not launch {name}")
    check(all(np.isfinite(v[0]).all() and v[0].shape[1] == 5
              for v in views.values()), "SOLD2 segments")
    # the detector on the GT heatmaps
    lsd = det_mod.LineSegmentDetector(device="cuda")
    recalls = []
    for i, (heat, junc, segs) in learned.gt_heatmap_views(
            scene, range(SOLD2_GT_VIEWS)).items():
        found = lsd.detect(junc, heat)
        recalls.append(learned.segment_recall(found, segs))
        log(f"[sold2] GT heatmap of view {i}: {len(segs)} visible GT "
            f"segments, {len(junc)} junctions, {len(found)} detected, "
            f"recall {recalls[-1]:.4f} (the JAX package's "
            f"{REFERENCE_SOLD2_GT_RECALL[i]:.4f})")
        check(recalls[-1] >= REFERENCE_SOLD2_GT_RECALL[i] - SOLD2_GT_SLACK,
              ("SOLD2 recall on the GT heatmap", i, recalls[-1]))
    return [(name, "sold2", rec.args, launches[name]) for name, rec in (
        ("sold2_candidates", rec_t), ("sold2_refine_junctions", rec_u),
        ("sample_descriptors", rec_s))]


class _ArrayView:
    """A camview whose image is an array."""

    def __init__(self, img):
        self.img = img

    def read_image(self, set_gray=True):
        return self.img


def measure_learned(items):
    """R, S, T and U on their phase-15 inputs, ``items`` [(kernel, path,
    args, launches on the path)]: each held to its plain version and
    timed in turns with its bound; S also beside grid_sample (the
    sampling alone)."""
    import torch.nn.functional as F
    from limap_tpu_torch.ops import log_sinkhorn as R
    from limap_tpu_torch.ops import sample_descriptors as S
    from limap_tpu_torch.ops import sold2_lines as TU
    from limap_tpu_torch.testing import learned_checks
    entries = []
    for name, path, args, launches in items:
        if name == "log_sinkhorn":
            scores, b, iters = args
            M, N = scores.shape
            zp = R.log_sinkhorn_plain(scores, b, iters)
            z1, z2 = (R.log_sinkhorn(scores, b, iters) for _ in range(2))
            err, tol, same = learned_checks.compare_z(z1, zp)
            scan_err, _, _ = learned_checks.compare_z(
                R.log_sinkhorn_scan(scores, b, iters), zp)
            check(err <= tol and same and torch.equal(z1, z2),
                  ("R vs plain on the path's input, and on a repeat", path,
                   err, tol))
            plan = R.plan(M, N)
            split = learned_checks.sinkhorn_split(scores, b, iters)
            log(f"[kernel] {path} log_sinkhorn {M + 1} x {N + 1}, {iters} "
                f"iterations: plan {json.dumps(plan)}; time split (ms) "
                f"{json.dumps(split)}")
            ops, nbytes, exps = R.work(M, N, iters)
            ops_ms, by = bound(ops, nbytes)
            exp_ms = R.exp_ms(exps, SMS, SM_CLOCK_HZ)
            entries += yard_entries(
                name, "log_sinkhorn_scan", path, R_SOURCE, R_REPLACES,
                launches, lambda: R.log_sinkhorn(*args),
                lambda: R.log_sinkhorn_scan(*args),
                lambda: R.log_sinkhorn_plain(*args), err, scan_err,
                max(ops_ms, exp_ms), by if ops_ms >= exp_ms else "operations",
                {"M": M, "N": N, "iters": iters, "operations": ops,
                 "bytes": nbytes, "exps": exps, "bound_fp32_ms": ops_ms,
                 "bound_exp_ms": exp_ms, "plan": plan, "split_ms": split,
                 "repeats": True, "library": "none"}, 5,
                "yardstick: R's first design")
        elif name == "sample_descriptors":
            grid, pts, mode, scale = args
            plain = (S.sample_clamp_plain if mode == "clamp"
                     else S.sample_zero_plain)
            err = float((S.sample_descriptors(*args)
                         - plain(grid, pts, scale)).abs().max())
            check(err <= learned_checks.SAMPLE_TOL,
                  ("S vs plain on the path's input", path, err))
            P, D = pts.shape[0], grid.shape[2]
            ops, nbytes = S.work(*args)
            entry = timed_entry(
                name, path, S_SOURCE, S_REPLACES, launches,
                S.sample_descriptors, lambda g, p, m, s: plain(g, p, s),
                args, {}, err, *bound(ops, nbytes),
                {"points": P, "channels": D, "mode": mode,
                 "grid": list(grid.shape), "corner_rows": int(
                     S.corner_cells(grid.shape, pts, mode, scale).numel()),
                 "operations": ops, "bytes": nbytes,
                 "library": "F.grid_sample (the sampling alone, without "
                            "the normalization)"}, (20, 5))
            # the same points in grid_sample's [-1, 1] coordinates
            Hc, Wc = grid.shape[:2]
            g = grid.permute(2, 0, 1)[None].contiguous()
            p = pts.to(torch.float32)
            if mode == "clamp":
                xy = torch.stack([p[:, 0] / (scale * Wc) * 2 - 1,
                                  p[:, 1] / (scale * Hc) * 2 - 1], -1)
            else:
                xy = torch.stack([p[:, 1] / (scale * Wc) * 2 - 1,
                                  p[:, 0] / (scale * Hc) * 2 - 1], -1)
            xy = xy[None, None].contiguous()
            # the library call in turns with the kernel: library, kernel,
            # kernel, library
            fns = {"kernel": lambda: S.sample_descriptors(*args),
                   "library": lambda: F.grid_sample(
                       g, xy, mode="bilinear", align_corners=False)}
            lib_turns = {"kernel": [], "library": []}
            for which in ("library", "kernel", "kernel", "library"):
                lib_turns[which].append(cuda_ms(fns[which], 20))
            entry["library_ms"] = float(np.mean(lib_turns["library"]))
            entry["library_ms_turns"] = lib_turns["library"]
            entry["ms_turns_with_library"] = lib_turns["kernel"]
            log(f"[kernel] {path} sample_descriptors ({mode}) in turns "
                f"with F.grid_sample (ms): {json.dumps(lib_turns)}")
            entries.append(entry)
        elif name == "sold2_candidates":
            hm, junc, si, ei, n_s, prm = args
            out_k = TU.sold2_candidates(*args)
            out_p = TU.candidates_plain(*args)
            res = learned_checks.compare_candidates(out_k, out_p,
                                                    prm.detect_thresh)
            check(res["ok"], ("T vs plain on the path's input", res))
            live_mask = ~out_p[1].isnan()
            live = int(live_mask.sum())
            texels = int(TU.candidate_texels(hm, junc, si, ei, live_mask,
                                             n_s, prm).sum())
            ops, nbytes = TU.candidates_work(
                len(si), live, junc.shape[0], n_s,
                TU.patch_offsets(prm.patch_radius).shape[0], prm.bilinear,
                prm.use_candidate_suppression, texels)
            mean_err = float(torch.nan_to_num(
                (out_k[1] - out_p[1]).abs()).max())
            entries.append(timed_entry(
                name, path, TU_SOURCE, T_REPLACES, launches,
                TU.sold2_candidates, TU.candidates_plain, args, {},
                mean_err, *bound(ops, nbytes),
                dict(res, junctions=junc.shape[0], live=live,
                     texels=texels, operations=ops, bytes=nbytes,
                     library="none"),
                (10, 1)))
        else:
            segs, hm, n_s, K, interval = args
            vec = torch.as_tensor(TU.perturbation_values(K, interval),
                                  device=segs.device)
            out = TU.sold2_refine_junctions(*args)
            plain = TU.refine_plain(segs, hm, n_s, vec)
            err = float((out - plain).abs().max())
            check(torch.equal(out, plain),
                  ("U vs plain on the path's input", err))
            ops, nbytes = TU.refine_work(segs.shape[0], K, n_s, *hm.shape)
            entries.append(timed_entry(
                name, path, TU_SOURCE, U_REPLACES, launches,
                TU.sold2_refine_junctions,
                lambda s, h, n, k, i: TU.refine_plain(s, h, n, vec), args,
                {}, err, *bound(ops, nbytes),
                {"segments": segs.shape[0], "perturbations": K ** 4,
                 "samples": n_s, "bit_equal_to_plain": True,
                 "operations": ops, "bytes": nbytes, "library": "none"},
                (5, 1)))
    return entries


# ---------------------------------------------------------------- phase 16
V_SOURCE = "lbd_describe.cu"
V_REPLACES = "limap_tpu/line2d/lbd.py:67"
W_SOURCE = "ncc_argmax.cu"
W_REPLACES = "limap_tpu/line2d/dense.py:57"
X_SOURCE = "tplsd_decode.cu"
X_REPLACES = "limap_tpu/line2d/tp_lsd.py:129"
Y_SOURCE = "l2d2_patches.cu"
Y_REPLACES = "limap_tpu/line2d/l2d2.py:114 (get_patch, called at :183)"
# The JAX package's decoding of DeepLSD's, TP-LSD's and HAWPv3's fields
# built from the projected GT segments of phase 7's first views
# (tests/torch_port_reference_gates.py --zoo-fields 4): recall at 3 px.
ZOO_FIELD_VIEWS = 4
REFERENCE_ZOO_RECALL = {
    "deeplsd": [0.3763440860215054, 0.32967032967032966,
                0.33695652173913043, 0.3626373626373626],
    "tplsd": [0.989247311827957, 1.0, 0.967391304347826,
              0.989010989010989],
    "hawpv3": [0.967741935483871, 1.0, 0.9782608695652174,
               0.978021978021978]}
# A segment or two of a view may fall either way of a threshold (the
# fields' float32 rounding on the card): 3 % of a view's ~92 GT segments.
ZOO_RECALL_SLACK = 0.03
# The JAX package's runner on the first ZOO_RUNNER_VIEWS views of phase 7's
# scene with tpu_lsd and lbd / lbd, dense_naive / dense_ncc
# (tests/torch_port_reference_gates.py --lbd 16 --dense 16).
ZOO_RUNNER_VIEWS = 16
REFERENCE_ZOO_RUNNER = {
    "lbd": {"n_tracks_all": 351, "n_matches": 157200,
            "precision_0.05": 99.31506849315068,
            "recall_0.05": 226.1654657612942},
    "dense_ncc": {"n_tracks_all": 0, "n_matches": 94,
                  "precision_0.05": 0.0, "recall_0.05": 0.0}}
# LBD: the port's CPU run of the same views gives 345 tracks, 157,180
# matches and precision 98.97 (JAX's jit fuses the descriptor's float32
# arithmetic, moving its descriptors by up to 2e-3): 3 % of the tracks,
# 2.5 points of precision.  The weight-free NCC flow (stride-8 grid
# patches of an untextured wall) finds no consistent flow on these
# views; its gate is JAX's own result, 0 tracks and 94 matches (the
# port's CPU run gives the same), within 10 % of the matches.
ZOO_RUNNER_GATES = {
    "lbd": (("n_tracks_all", "relative", 0.03),
            ("precision_0.05", "points", 2.5)),
    "dense_ncc": (("n_tracks_all", "relative", 0.0),
                  ("n_matches", "relative", 0.1))}
# The learned descriptors' runner, card against CPU, on the first views
ZOO_MATCH_VIEWS = 4
# The zoo's maps and descriptors card against CPU (TF32 off): within
# LEARNED_MAP_RTOL of their largest value, as phase 15a's networks; LBD's
# descriptors are float32 sums in another order (LBD_CARD_TOL).
LBD_CARD_TOL = 1e-5


def zoo_kernels():
    from limap_tpu_torch.ops import (l2d2_patches, lbd_describe, ncc_argmax,
                                     tplsd_decode)
    return {"lbd_describe": lbd_describe.lbd_describe,
            "ncc_argmax_both": ncc_argmax.ncc_argmax_both,
            "tplsd_decode": tplsd_decode.tplsd_decode,
            "l2d2_patches": l2d2_patches.l2d2_patches}


def reset_zoo_launches():
    for k in zoo_kernels().values():
        k.launches = 0


def zoo_launches():
    return {name: k.launches for name, k in zoo_kernels().items()}


def match_set_difference(a, b):
    sa = set(map(tuple, np.asarray(a).reshape(-1, 2).tolist()))
    sb = set(map(tuple, np.asarray(b).reshape(-1, 2).tolist()))
    return len(sa), len(sb), len(sa ^ sb)


def zoo_card_vs_cpu(ckpt):
    """Phase 16a: V, W, X and Y against their plain versions on seeded
    inputs (ties, clipped samples, lines longer than the image), then the
    zoo's networks at 128 x 128 from the random checkpoints, card against
    CPU: the detectors' maps and each decoding on the CPU's maps, the
    descriptors and each matcher's pairs, S2DNet's features."""
    from limap_tpu_torch.testing import pipeline, zoo, zoo_checks
    t0 = time.perf_counter()
    n0 = zoo_launches()
    for name, case, res in zoo_checks.check_all("cuda"):
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    n1 = zoo_launches()
    check(all(n1[k] > n0[k] for k in n0), ("V, W, X, Y launches counted",
                                          n0, n1))
    scene = pipeline.build_scene(n_views=2, hw=(128, 128))
    imgs = [scene[1][k] for k in (0, 1)]
    segs = [zoo.noisy_segments(scene, k) for k in (0, 1)]
    res = zoo.detectors_card_vs_cpu(imgs[0], ckpt["zoo"])
    res.update(zoo.descriptors_card_vs_cpu(imgs, segs, ckpt["zoo"],
                                           ckpt["superpoint"]))
    res.update(zoo.s2dnet_card_vs_cpu(imgs[0], ckpt["s2dnet"]))
    log(f"[zoo card-vs-cpu] 128 x 128: {json.dumps(res)}")
    for k in ("deeplsd_df", "deeplsd_angle", "tplsd_center", "tplsd_disp",
              "l2d2_desc", "linetr_desc", "gluestick_desc", "s2dnet"):
        check(res[k] <= LEARNED_MAP_RTOL, (k, res[k]))
    check(res["hawpv3_scores"] <= zoo.HAWP_SCORE_RTOL,
          ("hawpv3 scores", res["hawpv3_scores"]))
    check(res["hawpv3_maps_excess"] <= 1.0,
          ("hawpv3 maps beyond their scores' error",
           res["hawpv3_maps_excess"]))
    check(res["lbd_desc"] <= LBD_CARD_TOL, ("lbd descriptors",
                                           res["lbd_desc"]))
    check(res["tplsd_decode_equal"], "X card vs CPU on the CPU's maps")
    g, c = res["deeplsd_segments"]
    check(abs(g - c) <= 0.1 * c + 1, ("DeepLSD segments", g, c))
    check(res["hawpv3_segments"][0] == res["hawpv3_segments"][1],
          ("HAWPv3 segments", res["hawpv3_segments"]))
    for m in ("lbd", "l2d2", "linetr", "gluestick", "dense_naive"):
        ng, nc, diff = res[f"{m}_matches"]
        check(diff <= MATCH_DIFF_SHARE * nc + 1, (m, "matches", ng, nc,
                                                  diff))
    log(f"[zoo card-vs-cpu] phase 16a took {time.perf_counter() - t0:.1f} s")


def zoo_detectors_full_width(scene, ckpt, card, dev="cuda"):
    """Phase 16's detectors at 600 x 800: each network forward on view 0,
    card against CPU and timed on the card; then each decoding on the card
    on fields built from the projected GT segments of ZOO_FIELD_VIEWS
    views, gated on recall against the JAX package's.  Returns X's
    largest input on the path."""
    from limap_tpu_torch.line2d import deeplsd, hawpv3, tp_lsd
    from limap_tpu_torch.ops import tplsd_decode as X
    from limap_tpu_torch.testing import zoo
    img = scene[1][0]
    H, W = img.shape[:2]
    opts = {"weight_path": ckpt["zoo"]}
    dets = {"deeplsd": deeplsd.DeepLSDDetector,
            "tplsd": tp_lsd.TPLSDDetector, "hawpv3": hawpv3.HAWPv3Detector}
    def hawp_scores(d):
        with torch.no_grad():
            return (d.net.scores(d.image_tensor(img)),)

    # HAWPv3's scores are held to zoo.HAWP_SCORE_RTOL and its maps texel
    # by texel to what the scores' difference allows
    maps = {"deeplsd": lambda d: d.fields(img), "tplsd": lambda d: d.maps(img),
            "hawpv3": hawp_scores}
    rtol = {"deeplsd": LEARNED_MAP_RTOL, "tplsd": LEARNED_MAP_RTOL,
            "hawpv3": zoo.HAWP_SCORE_RTOL}
    rec_x = Recorder(X, "tplsd_decode", lambda c, *a, **k: c.numel())
    try:
        for name, cls in dets.items():
            dg, dc = cls(dict(opts, device=dev)), cls(dict(opts,
                                                           device="cpu"))
            mg, mc = maps[name](dg), maps[name](dc)
            err = max(zoo.rel_err(a, b) for a, b in zip(mg, mc))
            secs = cuda_ms(lambda: maps[name](dg), 3) if dev == "cuda" \
                else float("nan")
            t1 = time.perf_counter()
            found = dg.detect_array(img)
            if dev == "cuda":
                torch.cuda.synchronize()
            log(f"[zoo] {name} forward at {H} x {W} on {card}: "
                f"{secs:.3f} ms; maps card vs CPU relative {err:.3e}; "
                f"detect a view {time.perf_counter() - t1:.3f} s, "
                f"{len(found)} segments (random weights)")
            check(err <= rtol[name], (name, "maps card vs CPU", err))
            if name == "hawpv3":
                excess = zoo.hawp_maps_excess(mg[0], mc[0])
                log(f"[zoo] hawpv3 maps card vs CPU: at most {excess:.3f} "
                    f"of what the scores' difference allows")
                check(excess <= 1.0, ("hawpv3 maps beyond their scores' "
                                      "error", excess))
        views = zoo.gt_field_views(scene, range(ZOO_FIELD_VIEWS))
        got = {k: [] for k in REFERENCE_ZOO_RECALL}
        for i, segs in views.items():
            hw = scene[1][i].shape[:2]
            df, ang = (torch.as_tensor(a, device=dev)
                       for a in zoo.deeplsd_fields(segs, hw))
            d = deeplsd.segments_from_fields(df, ang)
            c, disp = (torch.as_tensor(a, device=dev)
                       for a in zoo.tplsd_fields(segs, hw))
            t, n = tp_lsd.tplsd_decode(c, disp, 512)
            t = t.cpu().numpy()[:int(n)]
            m = {k: torch.as_tensor(v, device=dev)
                 for k, v in zoo.hawp_fields(segs, hw).items()}
            h = hawpv3.decode(m, *hw)
            for name, det in (("deeplsd", d), ("tplsd", t), ("hawpv3", h)):
                got[name].append(zoo.recall_xy(det, segs))
        log(f"[zoo] decoding on the GT fields of {ZOO_FIELD_VIEWS} views: "
            f"recall {json.dumps(got)}; the JAX package's "
            f"{json.dumps(REFERENCE_ZOO_RECALL)}")
        for name, ref in REFERENCE_ZOO_RECALL.items():
            for r, g in zip(ref, got[name]):
                check(g >= r - ZOO_RECALL_SLACK, (name, "GT-field recall",
                                                  got[name], ref))
    finally:
        rec_x.restore()
    return rec_x.args


def zoo_runner_full_width(workdir, method, card, dev="cuda",
                          n_views=ZOO_RUNNER_VIEWS):
    """Phase 16's weight-free descriptors: the from-pixels runner with
    tpu_lsd and lbd / lbd or dense_naive / dense_ncc on the first views of
    phase 7's scene, gated on tracks and precision against the JAX
    package's run.  Returns the largest V or W input of the path."""
    from limap_tpu_torch.line2d import dense as dense_mod
    from limap_tpu_torch.line2d import lbd as lbd_mod
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    ext, mat = ("lbd", "lbd") if method == "lbd" else ("dense_naive",
                                                       "dense_ncc")
    imagecols, _, nbrs, gt = pipeline.build_scene(
        n_views, image_dir=os.path.join(workdir, "images"))
    cfg = pipeline.runner_config(os.path.join(workdir, "out"),
                                 n_neighbors=len(nbrs[0]))
    cfg["line2d"]["extractor"] = {"method": ext}
    cfg["line2d"]["matcher"]["method"] = mat
    if method == "lbd":
        rec = Recorder(lbd_mod, "lbd_describe", lambda i, s, v: s.shape[0])
    else:
        rec = Recorder(dense_mod, "ncc_argmax_both",
                       lambda a, b: a.shape[0] * b.shape[0])
    t0 = time.perf_counter()
    try:
        tracks = line_triangulation(cfg, imagecols, nbrs, device=dev)
    finally:
        rec.restore()
    wall = time.perf_counter() - t0
    with open(os.path.join(cfg["dir_save"], "metrics.json")) as f:
        stages = json.load(f)["stages_s"]
    matches_dir = os.path.join(cfg["dir_save"], "line_matchings", "tpu_lsd",
                               f"feats_{ext}", f"matches_{mat}")
    n_matches = sum(len(m) for i in nbrs for m in np.load(
        os.path.join(matches_dir, f"matches_{i}.npy"),
        allow_pickle=True).item().values())
    quality = pipeline.quality_eval(tracks, gt)
    measured = dict(quality, n_tracks_all=len(tracks), n_matches=n_matches)
    log(f"[zoo runner] {ext} / {mat}, {n_views} views, {wall:.3f} s; stage "
        f"seconds {json.dumps(stages)} on {card}; {n_matches} matches, "
        f"{len(tracks)} tracks; quality_eval {json.dumps(quality)}")
    check(np.isfinite([x.line for x in tracks]).all(),
          (mat, "non-finite lines"))
    hold_to_gates(f"{mat} runner", measured, REFERENCE_ZOO_RUNNER[mat],
                  ZOO_RUNNER_GATES[mat])
    return rec.args


def shuffled_copy(method, info, seed=0):
    """A descinfo of ``method`` and a copy of it with its lines in a
    shuffled order; returns (copy, expected: a line's copy)."""
    if method == "gluestick":
        n = len(info["lines"])
    elif method == "linetr":
        n = info["mat_klines2sublines"].shape[0]
    else:
        n = len(info["line_descriptors"])
    perm = np.random.default_rng(seed).permutation(n)
    if method == "gluestick":
        rows = (2 * perm[:, None] + np.arange(2)).reshape(-1)
        copy = dict(info, lines=info["lines"][perm],
                    junctions=info["junctions"][rows],
                    junc_desc=info["junc_desc"][rows],
                    junc_score=info["junc_score"][rows])
    elif method == "linetr":
        copy = dict(info, mat_klines2sublines=info[
            "mat_klines2sublines"][perm])
    else:
        copy = dict(info, line_descriptors=info["line_descriptors"][perm])
    expected = np.empty(n, np.int64)
    expected[perm] = np.arange(n)
    return copy, expected


def zoo_descriptors_full_width(scene, ckpt, workdir, card, dev="cuda",
                               n_views=ZOO_MATCH_VIEWS):
    """Phase 16's learned descriptors (random weights): L2D2, LineTR and
    GlueStick on view 0 at 600 x 800 against a shuffled copy of its lines
    on the card (every match must be the copy); then each in the runner
    on the first views (GlueStick's with each view's nearest neighbour
    alone), on the CPU and on the card with the CPU's segments (matches
    equal up to a near tie).  Returns Y's largest
    input on the path."""
    from limap_tpu_torch.line2d import get_extractor, get_matcher
    from limap_tpu_torch.line2d import l2d2 as l2d2_mod
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline, zoo
    img = scene[1][0]
    segs = zoo.noisy_segments(scene, 0)
    rec_y = Recorder(l2d2_mod, "l2d2_patches", lambda i, m, b: m.shape[0])
    try:
        for method in ("l2d2", "linetr", "gluestick"):
            ext = get_extractor({"method": method,
                                 "sp_weight_path": ckpt["superpoint"]},
                                weight_path=ckpt["zoo"], device=dev)
            mat = get_matcher({"method": method, "topk": 0,
                               "match_threshold": 0.01}, ext,
                              weight_path=ckpt["zoo"], device=dev)
            t1 = time.perf_counter()
            info = (ext.compute_descinfo(img, segs) if method == "linetr"
                    else ext.extract_array(img, segs))
            t_ext = time.perf_counter() - t1
            copy, expected = shuffled_copy(method, info)
            t1 = time.perf_counter()
            m = mat.match_pair(info, copy)
            t_mat = time.perf_counter() - t1
            right = int((expected[m[:, 0]] == m[:, 1]).sum()) if len(m) \
                else 0
            log(f"[zoo] {method} at 600 x 800, {len(expected)} lines on "
                f"{card}: describe {t_ext:.3f} s, match {t_mat:.3f} s; "
                f"{len(m)} matches against the shuffled copy, {right} "
                f"the copy")
            # random weights make the descriptors of different lines
            # alike: LineTR's mutual test drops a row whose near-zero
            # distances tie, GlueStick's OT spreads a row over every
            # column; a floor of matches, each its copy
            floor = {"l2d2": 0.9 * len(expected),
                     "linetr": 0.5 * len(expected)}.get(method, 10)
            check(len(m) >= floor and right == len(m),
                  (method, "the shuffled copy not recovered", len(m), right))
    finally:
        rec_y.restore()
    imagecols, imgs, nbrs, _ = pipeline.build_scene(
        n_views, image_dir=os.path.join(workdir, "images"))
    for method in ("l2d2", "linetr", "gluestick"):
        # GlueStick's GNN on the CPU is the slowest match by far: its
        # runner takes each view's nearest neighbour alone
        mnbrs = ({i: n[:1] for i, n in nbrs.items()}
                 if method == "gluestick" else nbrs)
        matches = {}
        for d in ("cpu", dev):
            out = os.path.join(workdir, f"{method}_{d}")
            cfg = pipeline.runner_config(out, n_neighbors=len(mnbrs[0]))
            cfg["weight_path"] = ckpt["zoo"]
            cfg["line2d"]["extractor"] = {
                "method": method, "sp_weight_path": ckpt["superpoint"]}
            cfg["line2d"]["matcher"]["method"] = method
            # the random GNN's OT leaves few rows above the published 0.2
            cfg["line2d"]["matcher"]["match_threshold"] = 0.01
            if d != "cpu":
                cfg.update(load_det=True, load_dir=os.path.join(
                    workdir, f"{method}_cpu"))
            line_triangulation(cfg, imagecols, mnbrs, device=d)
            mdir = os.path.join(cfg["dir_save"], "line_matchings",
                                "tpu_lsd", f"feats_{method}",
                                f"matches_{method}")
            matches[d] = {i: np.load(os.path.join(
                mdir, f"matches_{i}.npy"), allow_pickle=True).item()
                for i in mnbrs}
        diffs = [match_set_difference(matches[dev][i][j],
                                      matches["cpu"][i][j])
                 for i in mnbrs for j in mnbrs[i]]
        n_c = sum(x[1] for x in diffs)
        n_d = sum(x[2] for x in diffs)
        log(f"[zoo runner card-vs-cpu] {method}, {n_views} views: "
            f"{sum(x[0] for x in diffs)} and {n_c} matches, {n_d} in one "
            f"only")
        check(n_d <= MATCH_DIFF_SHARE * n_c + 2, (method, "runner matches",
                                                   n_d, n_c))
    gluestick_pair_card_vs_cpu(ckpt, imgs, nbrs, os.path.join(
        workdir, "gluestick_cpu"), dev)
    return rec_y.args


GLUESTICK_PAIR_THRESHOLD = 1e-3


def gluestick_pair_card_vs_cpu(ckpt, imgs, nbrs, cpu_out, dev="cuda"):
    """The random GNN's OT leaves no pair of the runner above its
    threshold, so GlueStick's line scores and OT are held card against
    CPU on one pair of the CPU run's views and segments, and the mutual
    best entries above GLUESTICK_PAIR_THRESHOLD may differ only on a near
    tie of the OT."""
    from limap_tpu_torch.line2d import get_extractor, get_matcher
    from limap_tpu_torch.line2d.gluestick import matches_from_assignment
    from limap_tpu_torch.util import io as limapio
    segs = limapio.read_all_segments_from_folder(os.path.join(
        cpu_out, "line_detections", "tpu_lsd", "segments"))
    opts = {"method": "gluestick", "sp_weight_path": ckpt["superpoint"]}
    ext = get_extractor(opts, device="cpu")
    i, j = 0, nbrs[0][0]
    info = [ext.extract_array(imgs[k], segs[k]) for k in (i, j)]
    out = {}
    for d in ("cpu", dev):
        mat = get_matcher({"method": "gluestick", "topk": 0}, ext,
                          weight_path=ckpt["zoo"], device=d)
        sc = mat.scores(*info)
        z = mat.assignment(sc)
        m = matches_from_assignment(z, GLUESTICK_PAIR_THRESHOLD)
        m0 = np.full(len(info[0]["lines"]), -1, np.int64)
        m0[m[:, 0]] = m[:, 1]
        out[d] = (sc.cpu(), z.cpu(), m0)
    (sc, zc, mc), (sg, zg, mg) = out["cpu"], out[dev]
    s_err = float((sg - sc).abs().max())
    z_err = float((zg - zc).abs().max())
    rows, bad = ot_match_differences(zg.numpy(), zc.numpy(), mg, mc,
                                     GLUESTICK_PAIR_THRESHOLD)
    log(f"[zoo] GlueStick on views {i} and {j} ({len(mc)} x "
        f"{len(info[1]['lines'])} lines), card against CPU: line scores "
        f"{s_err:.3e}, OT {z_err:.3e}; {int((mg >= 0).sum())} and "
        f"{int((mc >= 0).sum())} matches at {GLUESTICK_PAIR_THRESHOLD}, "
        f"{len(rows)} rows differ, {len(bad)} not a near tie")
    check(s_err <= LEARNED_MAP_RTOL, ("GlueStick line scores", s_err))
    # the OT's input is 10 x the scores
    check(z_err <= 20 * LEARNED_MAP_RTOL + 1e-4, ("GlueStick OT", z_err))
    check(not bad, ("GlueStick matches differ", bad[:10]))


def s2dnet_full_width(scene, ckpt, workdir, dev="cuda"):
    """Phase 16's S2DNet: features at 600 x 800 card against CPU, then
    phase 12a's reduced façade refined with S2DNet features in the
    consistency term, on the CPU and on the card."""
    from limap_tpu_torch.features.extractors import S2DNetExtractor
    from limap_tpu_torch.pointsfm import ReadInfos, ReadPointTracks
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline, pointline
    from limap_tpu_torch.util import io as limapio
    img = scene[1][0]
    fg = S2DNetExtractor(ckpt["s2dnet"], device=dev).extract(img)
    fc = S2DNetExtractor(ckpt["s2dnet"], device="cpu").extract(img)
    err = float((fg.cpu() - fc).abs().max())
    log(f"[zoo] S2DNet at 600 x 800: {tuple(fg.shape)}, card vs CPU "
        f"{err:.3e}")
    check(err <= LEARNED_MAP_RTOL, ("S2DNet card vs CPU", err))
    small = dict(n_views=8, hw=(240, 320), n_points=400)
    model, image_dir, gt = pipeline.write_colmap_scene(workdir, **small)
    cfg = pipeline.colmap_vp_config(os.path.join(workdir, "map"))
    cols = ReadInfos(model, image_dir)
    tracks = line_triangulation(cfg, cols, points3d=ReadPointTracks(model),
                                device="cpu")
    segs = limapio.read_all_segments_from_folder(os.path.join(
        workdir, "map", "line_detections", "tpu_lsd", "segments"))
    model2, _, _ = pipeline.write_colmap_scene(
        os.path.join(workdir, "points"), n_line_points=800, **small)
    out = {}
    for d in ("cpu", dev):
        out[d] = pointline.run(tracks, cols, segs, model2, gt,
                               os.path.join(workdir, d), d,
                               n_wall_points=400, features="s2dnet",
                               weight_path=ckpt["s2dnet"], associate=False)
    (c, sc), (g, sg) = out["cpu"], out[dev]
    log(f"[zoo] line refinement with S2DNet features on phase 12a's "
        f"{len(tracks)} tracks: CPU summary {json.dumps(sc['refined_px'])}, "
        f"card {json.dumps(sg['refined_px'])}")
    pixel_card_vs_cpu(c, g, sc["refined_px"], sg["refined_px"])


def dense_runner_yardstick(card):
    """The dense runner again with W's first design in its place (the row
    scan, once a direction) and then with W, after phase 16's launches
    are read: whether W's gain shows in the runner's stage seconds."""
    from limap_tpu_torch.line2d import dense as dense_mod
    from limap_tpu_torch.ops import ncc_argmax as W

    def rowscan_both(f1, f2):
        return W.ncc_argmax_rowscan(f1, f2) + W.ncc_argmax_rowscan(f2, f1)

    both = dense_mod.ncc_argmax_both
    try:
        for which, fn in (("row scan", rowscan_both), ("W", both)):
            dense_mod.ncc_argmax_both = fn
            with tempfile.TemporaryDirectory() as workdir:
                log(f"[zoo] the dense runner with {which}:")
                zoo_runner_full_width(workdir, "dense_ncc", card)
    finally:
        dense_mod.ncc_argmax_both = both


def measure_ncc(path, args, launches):
    """W on the dense runner's largest pair: both directions held to the
    plain version (a differing index a near tie, zoo_checks.ncc_witness)
    and to the row-scan yardstick bit for bit; timed in turns with the
    plain version, then in turns with the yardstick (one launch a
    direction) and the library call (one f1 @ f2.T, both max
    reductions)."""
    from limap_tpu_torch.ops import ncc_argmax as W
    from limap_tpu_torch.testing import zoo_checks
    f1, f2 = args
    k12, ks12, k21, ks21 = W.ncc_argmax_both(*args)
    p12, ps12, p21, ps21 = W.ncc_argmax_both_plain(*args)
    a, b = f1.cpu().numpy(), f2.cpu().numpy()
    rows, bad, serr = zoo_checks.ncc_witness(a, b, k12, ks12, p12, ps12)
    cols, badc, serrc = zoo_checks.ncc_witness(b, a, k21, ks21, p21, ps21)
    err = max(serr, serrc)
    check(not bad and not badc and err <= zoo_checks.NCC_TIE,
          ("W vs plain", path, len(rows), len(cols), (bad + badc)[:5], err))
    r12, rs12 = W.ncc_argmax_rowscan(f1, f2)
    r21, rs21 = W.ncc_argmax_rowscan(f2, f1)
    same = bool(torch.equal(k12, r12) and torch.equal(ks12, rs12)
                and torch.equal(k21, r21) and torch.equal(ks21, rs21))
    check(same, ("W vs the row-scan yardstick", path))
    ops, nbytes = W.work(f1.shape[0], f2.shape[0], f1.shape[1])

    def rowscan_both():
        W.ncc_argmax_rowscan(f1, f2)
        W.ncc_argmax_rowscan(f2, f1)

    yard = {"kernel": [], "rowscan": [], "library": []}
    fns = {"kernel": lambda: W.ncc_argmax_both(f1, f2),
           "rowscan": rowscan_both,
           "library": lambda: W.ncc_argmax_both_plain(f1, f2)}
    for which in ("library", "rowscan", "kernel", "kernel", "rowscan",
                  "library"):
        yard[which].append(cuda_ms(fns[which], 5))
    entry = timed_entry(
        "ncc_argmax_both", path, W_SOURCE, W_REPLACES, launches,
        W.ncc_argmax_both, W.ncc_argmax_both_plain, args, {}, err,
        *bound(ops, nbytes),
        {"N1": f1.shape[0], "N2": f2.shape[0], "D": f1.shape[1],
         "rows_differ": len(rows), "cols_differ": len(cols),
         "equal_to_rowscan": same, "operations": ops, "bytes": nbytes,
         "ms_turns_with_yardsticks": yard["kernel"],
         "rowscan_both_ms": float(np.mean(yard["rowscan"])),
         "rowscan_both_ms_turns": yard["rowscan"],
         "library_ms_turns": yard["library"],
         "library": "one f1 @ f2.T, then max over dim 1 and over dim 0"},
        (5, 1))
    entry["library_ms"] = float(np.mean(yard["library"]))
    log(f"[kernel] {path} ncc_argmax_both in turns with its yardsticks "
        f"(ms): {json.dumps(yard)}")
    return entry


def measure_zoo(items):
    """V, W, X and Y on their phase-16 inputs, ``items`` [(kernel, path,
    args, launches on the path)]: each held to its plain version and
    timed in turns with its bound; W also beside its first design and
    the library call (measure_ncc)."""
    from limap_tpu_torch.ops import l2d2_patches as Y
    from limap_tpu_torch.ops import lbd_describe as V
    from limap_tpu_torch.ops import tplsd_decode as X
    from limap_tpu_torch.testing import zoo_checks
    entries = []
    for name, path, args, launches in items:
        if name == "lbd_describe":
            img, segs, valid = args
            err = float((V.lbd_describe(*args)
                         - V.lbd_describe_plain(*args)).abs().max())
            check(err <= zoo_checks.LBD_TOL, ("V vs plain", path, err))
            ops, nbytes = V.work(*img.shape, segs.shape[0])
            entries.append(timed_entry(
                name, path, V_SOURCE, V_REPLACES, launches, V.lbd_describe,
                V.lbd_describe_plain, args, {}, err, *bound(ops, nbytes),
                {"lines": segs.shape[0], "image": list(img.shape),
                 "operations": ops, "bytes": nbytes, "library": "none"},
                (5, 1)))
        elif name == "ncc_argmax_both":
            entries.append(measure_ncc(path, args, launches))
        elif name == "tplsd_decode":
            c, d, max_segs, thresh, r = args
            sk, nk = X.tplsd_decode(*args)
            sp, np_ = X.tplsd_decode_plain(*args)
            check(torch.equal(sk, sp) and int(nk) == int(np_),
                  ("X vs plain", path))
            n_peaks = int((X.peak_scores(c, thresh, r) > 0).sum())
            ops, nbytes = X.work(*c.shape, max_segs, r, n_peaks)
            entries.append(timed_entry(
                name, path, X_SOURCE, X_REPLACES, launches, X.tplsd_decode,
                X.tplsd_decode_plain, args, {}, 0.0, *bound(ops, nbytes),
                {"map": list(c.shape), "max_segs": max_segs,
                 "peaks": n_peaks, "bit_equal_to_plain": True,
                 "operations": ops, "bytes": nbytes, "library": "none"},
                (10, 2)))
        else:
            img, minv, boxes = args
            k = Y.l2d2_patches(*args)
            p = Y.l2d2_patches_plain(*args)
            check(torch.equal(k, p), ("Y vs plain", path,
                                      float((k - p).abs().max())))
            ops, nbytes = Y.work(img.shape, minv, boxes)
            entries.append(timed_entry(
                name, path, Y_SOURCE, Y_REPLACES, launches, Y.l2d2_patches,
                Y.l2d2_patches_plain, args, {}, 0.0, *bound(ops, nbytes),
                {"lines": minv.shape[0], "image": list(img.shape),
                 "outside_canvas": int(((boxes[:, 0] < 0)
                                        | (boxes[:, 1] < 0)).sum()),
                 "bit_equal_to_plain": True, "operations": ops,
                 "bytes": nbytes, "library": "none"}, (10, 2)))
    return entries


def zoo_full_width(scene, ckpt, card):
    """Phase 16: the zoo's paths at full width with V, W, X, Y and R's
    launches counted over them, then the kernels on their inputs."""
    from limap_tpu_torch.line2d import gluestick
    from limap_tpu_torch.ops import log_sinkhorn as R
    reset_zoo_launches()
    R.log_sinkhorn.launches = 0
    shapes = Counter()
    counter = ShapeCounter(gluestick, "log_sinkhorn", shapes)
    t0 = time.perf_counter()
    x_args = zoo_detectors_full_width(scene, ckpt, card)
    log(f"[zoo] the detectors took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        v_args = zoo_runner_full_width(os.path.join(workdir, "lbd"), "lbd",
                                       card)
        w_args = zoo_runner_full_width(os.path.join(workdir, "dense"),
                                       "dense_ncc", card)
        log(f"[zoo] the LBD and dense runners took "
            f"{time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        y_args = zoo_descriptors_full_width(scene, ckpt,
                                            os.path.join(workdir, "desc"),
                                            card)
        log(f"[zoo] the learned descriptors took "
            f"{time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        s2dnet_full_width(scene, ckpt, os.path.join(workdir, "s2dnet"))
        log(f"[zoo] S2DNet took {time.perf_counter() - t1:.1f} s")
    counter.restore()
    launches = zoo_launches()
    r_launches = R.log_sinkhorn.launches
    log(f"[zoo] phase 16's paths took {time.perf_counter() - t0:.1f} s; "
        f"launches {json.dumps(launches)}, log_sinkhorn {r_launches}")
    log_r_shapes("phase 16's paths (GlueStick's OT)", shapes)
    for name, n in launches.items():
        check(n > 0, f"phase 16's paths did not launch {name}")
    check(r_launches > 0, "GlueStick's OT did not launch log_sinkhorn")
    dense_runner_yardstick(card)
    return measure_zoo([
        ("lbd_describe", "lbd_runner", v_args, launches["lbd_describe"]),
        ("ncc_argmax_both", "dense_runner", w_args,
         launches["ncc_argmax_both"]),
        ("tplsd_decode", "tplsd_detect", x_args, launches["tplsd_decode"]),
        ("l2d2_patches", "l2d2_describe", y_args, launches["l2d2_patches"])])


# Phase 17: the ranks, the BA's steps, the multi-chip tolerances of
# tests/test_multichip_parity.py (d partial sums are added in another
# order than one card's), the seconds a join may take.  CG's poses are
# weakly determined along a near-gauge direction (phase 14's CG and dense
# runs part there by millimetres at a cost 4e-6 apart), and CG's 64
# float32 iterations carry the order of the sums along it: the d-rank CG
# run's poses are held within MULTI_POSE_TOL or, where larger, the
# one-card CG run's own distance from the one-card dense solve.  Rounding
# is the cause: in float64 the two-rank CG run is 3.7e-8 from the
# one-process run with the scale gauge free and 1.2e-8 with two poses
# fixed, the near-gauge direction (tests/test_torch_parallel_ba.py::
# test_trajectory_matches_one_process_in_float64[cg] and [cg two fixed
# poses], within MULTI_POSE_TOL); in float32 the same runs part by 2.1e-3.
RANKS_17 = 2
BA_STEPS_17 = 20
MULTI_COST_RTOL, MULTI_COST_ATOL_SHARE = 5e-3, 1e-5
MULTI_POSE_TOL, MULTI_LINE_TOL = 1e-4, 1e-3
RANKS_TIMEOUT_S = 300
PROTOCOL_17 = (100, 1500, 20)   # phase 4's scene
MULTI_TRI_CFG = {"triangulation": {"max_tris_per_node": 32}}


def pose_arrays(imagecols):
    """[I, 4] qvec and [I, 3] tvec of a collection, by image id."""
    ids = imagecols.get_img_ids()
    return (np.stack([imagecols.campose(i).qvec for i in ids]),
            np.stack([imagecols.campose(i).tvec for i in ids]))


def same_ba_output(a, b):
    """Two BA outputs identical bit for bit."""
    return (a[3] == b[3] and np.array_equal(a[1], b[1])
            and all(np.array_equal(x, y) for x, y in zip(pose_arrays(a[0]),
                                                         pose_arrays(b[0])))
            and len(a[2]) == len(b[2])
            and all(np.array_equal(x.line, y.line)
                    for x, y in zip(a[2], b[2])))


def collectives_line(what, res, steps, card):
    """A BA run's collectives over the mesh: calls and bytes a step (the
    step's, the cost's and the first cost's), and the share of the run
    spent in them."""
    c = res["collectives"]
    share = c["seconds"] / res["seconds"] if res["seconds"] else 0.0
    log(f"[multi-card] {what}: {res['seconds']:.3f} s for {steps} steps; "
        f"collectives {json.dumps(c['calls'])} ("
        f"{json.dumps({k: n / steps for k, n in c['calls'].items()})} a "
        f"step), bytes {json.dumps(c['bytes'])} ("
        f"{json.dumps({k: n / steps for k, n in c['bytes'].items()})} a "
        f"step), {c['seconds']:.4f} s in them, {100 * share:.2f} % of the "
        f"run; on {card}")
    return share


def hold_ba_to_one_card(what, got, ref, gt, pose_tol=MULTI_POSE_TOL):
    """A d-rank BA output against the one-card run's: the multi-chip
    tolerances (the poses' ``pose_tol``) and phase 14's gates on the
    median pose errors."""
    from limap_tpu_torch.testing import refine
    costs, ref_costs = np.asarray(got[3]), np.asarray(ref[3])
    dq, dt = (np.abs(x - y).max() for x, y in zip(pose_arrays(got[0]),
                                                   pose_arrays(ref[0])))
    dl = track_line_distance(got[2], ref[2])
    dp = float(np.abs(got[1] - ref[1]).max())
    te, re = refine.pose_errors64(got[0], gt)
    log(f"[multi-card] {what} against the one-card run: costs "
        f"{costs[0]:.6f} -> {costs[-1]:.6f} (one card {ref_costs[0]:.6f} "
        f"-> {ref_costs[-1]:.6f}), largest cost difference "
        f"{np.abs(costs - ref_costs).max():.3e}; poses within {dq:.2e} "
        f"(qvec), {dt:.2e} (tvec); points {dp:.2e} m; lines {dl:.2e} m; "
        f"median errors {np.median(te):.5f} m, {np.median(re):.5f} deg")
    check(np.allclose(costs, ref_costs, rtol=MULTI_COST_RTOL,
                      atol=MULTI_COST_ATOL_SHARE * ref_costs[0]),
          (what, "costs", costs, ref_costs))
    check(max(dq, dt) <= pose_tol, (what, "poses", dq, dt, pose_tol))
    check(dl <= MULTI_LINE_TOL, (what, "lines", dl))
    hold_to_gates(what, {"trans_after": float(np.median(te)),
                         "rot_after": float(np.median(re))},
                  REFERENCE_REFINE, [g for g in REFINE_GATES
                                     if g[0].endswith("_after")])


def node_table_difference(a, b):
    """(tables bit-equal, largest best-score difference, valid-edge
    counts equal) of two triangulators' node tables."""
    return (all(np.array_equal(x, y) for x, y in zip(a, b)),
            float(np.abs(a[2] - b[2]).max()), np.array_equal(a[4], b[4]))


def multicard(ba_inputs, card, dev="cuda"):
    """Phase 17 (see the module docstring); ``dev`` "cpu" rehearses it
    on gloo with the plain versions."""
    import torch.distributed as dist
    from limap_tpu_torch.parallel import (HybridBAOptions, distributed,
                                          make_mesh,
                                          solve_hybrid_bundle_adjustment)
    from limap_tpu_torch.parallel.distributed import run_distributed_mapping
    from limap_tpu_torch.parallel.mesh import all_reduce_sum
    from limap_tpu_torch.testing import multirank
    from limap_tpu_torch.testing.synthetic import build_scene
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)
    imagecols, pointtracks, linetracks, gt = ba_inputs
    ba_args = (imagecols, pointtracks, linetracks)
    opts = {"n_fixed_poses": 2}

    # (a) one NCCL rank in this process against the one-card call
    t0 = time.perf_counter()
    one = solve_hybrid_bundle_adjustment(
        *ba_args, HybridBAOptions(**opts), n_iterations=BA_STEPS_17,
        device=dev)
    one_s = time.perf_counter() - t0
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as store:
        t0 = time.perf_counter()
        distributed.maybe_initialize(f"file://{store}/store", 1, 0,
                                     timeout_s=120.0)
        init_s = time.perf_counter() - t0
        try:
            backend = "nccl" if dev == "cuda" else "gloo"
            check(dist.get_backend() == backend,
                  ("phase 17a backend", dist.get_backend()))
            # NCCL sets its communicator up at the first collective
            t0 = time.perf_counter()
            all_reduce_sum([torch.zeros(1, device=dev)], make_mesh())
            torch.cuda.synchronize() if dev == "cuda" else None
            init_s = (init_s, time.perf_counter() - t0)
            nccl = multirank.hybrid_ba(0, 1, *ba_args, opts, BA_STEPS_17,
                                       dev, timed=True)
        finally:
            dist.destroy_process_group()
    log(f"[multi-card] (a) one NCCL rank: group in {init_s[0]:.2f} s, "
        f"the first collective {init_s[1]:.2f} s; "
        f"{nccl['seconds']:.3f} s for the BA (one card without a group "
        f"{one_s:.3f} s); kernel launches {json.dumps(nccl['launches'])}")
    check_hybrid_launches("phase 17a", nccl["launches"], product=False)
    check(nccl["collectives"]["calls"].get("all_reduce", 0) > 0
          and nccl["collectives"]["calls"].get("all_gather", 0) > 0,
          ("phase 17a collectives", nccl["collectives"]))
    collectives_line("(a) one NCCL rank, dense", nccl, BA_STEPS_17, card)
    check(same_ba_output(nccl["out"], one),
          "phase 17a: one NCCL rank differs from the one-card call")
    log("[multi-card] (a) costs, poses, points and lines bit-equal to the "
        "one-card call")

    # (b) the one-rank references here, then two gloo ranks
    imgs, segs, nbrs, _ = build_scene(*PROTOCOL_17, device=dev)
    t0 = time.perf_counter()
    tri = GlobalLineTriangulator(TriangulatorConfig.from_dict(
        MULTI_TRI_CFG["triangulation"]), dev)
    tri.init(segs, imgs)
    tri.triangulate_all(nbrs)
    one_tables = multirank.node_tables(tri)
    one_tracks = tri.compute_line_tracks()
    one_tri_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_mapped = run_distributed_mapping(MULTI_TRI_CFG, imgs, segs, nbrs,
                                         mesh=None, device=dev)
    one_map_s = time.perf_counter() - t0
    one_cg = solve_hybrid_bundle_adjustment(
        *ba_args, HybridBAOptions(solver="cg", **opts),
        n_iterations=BA_STEPS_17, device=dev)
    cg_spread = max(np.abs(x - y).max() for x, y in zip(
        pose_arrays(one_cg[0]), pose_arrays(one[0])))
    log(f"[multi-card] one card: CG's poses within {cg_spread:.2e} of the "
        f"dense solve's (qvec, tvec)")
    t0 = time.perf_counter()
    ranks = multirank.start(multirank.jobs, RANKS_17, ([
        (multirank.mapping, (imgs, segs, nbrs, MULTI_TRI_CFG, dev)),
        (multirank.hybrid_ba, ba_args + (opts, BA_STEPS_17, dev, True)),
        (multirank.hybrid_ba, ba_args + (dict(opts, solver="cg"),
                                         BA_STEPS_17, dev, True))],),
        backend="gloo", threads=2)
    ranked = ranks.join(timeout_s=RANKS_TIMEOUT_S)
    log(f"[multi-card] (b) {RANKS_17} gloo ranks sharing the card ran in "
        f"{time.perf_counter() - t0:.1f} s (the processes' start "
        f"included); one rank here: triangulate_all + tracks "
        f"{one_tri_s:.3f} s, run_distributed_mapping {one_map_s:.3f} s")
    for r, (mp_, dense, cg) in enumerate(ranked):
        log(f"[multi-card] (b) rank {r}: seconds {json.dumps(mp_['seconds'])}"
            f"; F, G launches {json.dumps(mp_['launches'])}; mine "
            f"{mp_['mine'][0]}..{mp_['mine'][-1]}; BA dense "
            f"{dense['seconds']:.3f} s, CG {cg['seconds']:.3f} s; O, P, Q "
            f"launches dense {json.dumps(dense['launches'])}, CG "
            f"{json.dumps(cg['launches'])}")
        for name, n in mp_["launches"].items():
            check(n > 0, f"phase 17b rank {r} did not launch {name}")
        check_hybrid_launches(f"phase 17b rank {r} dense", dense["launches"],
                              product=False)
        check_hybrid_launches(f"phase 17b rank {r} CG", cg["launches"],
                              product=True)
        check(mp_["segs_keys"] == imgs.get_img_ids(),
              ("phase 17b merged segments", r))
        same, dscore, cnt = node_table_difference(mp_["tables"], one_tables)
        log(f"[multi-card] (b) rank {r} triangulate_all_mesh: node tables "
            f"bit-equal {same}, best scores within {dscore:.3e}, edge "
            f"counts equal {cnt}; {len(mp_['tracks'])} tracks (one rank "
            f"{len(one_tracks)})")
        check(dscore <= 1e-4 and cnt, ("phase 17b node tables", r, dscore))
        for what, got, ref in (("triangulate_all_mesh", mp_["tracks"],
                                one_tracks),
                               ("run_distributed_mapping", mp_["mapped"],
                                one_mapped)):
            check(sorted(map(key, got)) == sorted(map(key, ref)),
                  (f"phase 17b {what} supports", r, len(got), len(ref)))
            check(track_line_distance(got, ref) <= MULTI_LINE_TOL,
                  (f"phase 17b {what} lines", r))
        for what, res, ref, tol in (
                ("dense", dense, one, MULTI_POSE_TOL),
                ("CG", cg, one_cg, max(MULTI_POSE_TOL, cg_spread))):
            hold_ba_to_one_card(f"(b) rank {r} {what}", res["out"], ref, gt,
                                tol)
            collectives_line(f"(b) rank {r} {what}", res, BA_STEPS_17, card)
    for j in (1, 2):
        check(same_ba_output(ranked[0][j]["out"], ranked[1][j]["out"]),
              ("phase 17b: the ranks' BA outputs differ", j))
    log("[multi-card] (b) both ranks' BA outputs identical bit for bit")


def save_loc_inputs(recorded, path):
    """The inputs of phase 8's LO solves and of B's launches, on the CPU,
    as testing/lo_wall.py reads them (the config as a dict)."""
    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def call(a, k):
        return [cpu(x) if not dataclasses.is_dataclass(x)
                else dataclasses.asdict(x) for x in a], \
            {n: cpu(v) for n, v in k.items()}

    torch.save({"lm_jointloc": [call(*c) for c in recorded["lm_jointloc"]],
                "trace_roots": [call(*c) for c in
                                recorded["trace_roots_calls"]]}, path)
    log(f"[localize] the inputs of {len(recorded['lm_jointloc'])} LO solves "
        f"and {len(recorded['trace_roots_calls'])} launches of B saved to "
        f"{path}")


def main():
    parser = argparse.ArgumentParser(
        description="Drive every path of the port on one card.")
    parser.add_argument("--save-loc-inputs", default="", metavar="FILE",
                        help="save phase 8's LO and root-finder inputs")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible")
        return 2
    from limap_tpu_torch.ops import cuda_build
    from limap_tpu_torch.ops import nn_distance as nnd

    global SMS, SM_CLOCK_HZ
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    SM_CLOCK_HZ = sm_clock_hz()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; {SMS} SMs, highest SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz")
    log("optional packages on this machine: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("yaml", "cv2", "PIL")))

    # ---- 1. build: one nvcc a source, all started together ----
    from limap_tpu_torch.ops import (epipolar_iou, hybrid_ba, line_ransac,
                                     linker_edges, lm_assoc, lm_jointloc,
                                     lm_line_ba, lm_line_refine, log_sinkhorn,
                                     mesh_distance, pose_score,
                                     sample_descriptors, sold2_lines,
                                     trace_roots, tri_propose, tri_score,
                                     vp_detect)
    from limap_tpu_torch.ops import (l2d2_patches, lbd_describe, ncc_argmax,
                                     tplsd_decode)
    from limap_tpu_torch.testing import (fitnmerge_checks, kernel_checks,
                                         lm_checks, tri_checks, vp_checks)
    t0 = time.perf_counter()
    libs = (nnd, trace_roots, pose_score, epipolar_iou, line_ransac,
            linker_edges, tri_propose, tri_score, lm_line_ba, lm_jointloc,
            vp_detect, lm_line_refine, lm_assoc, mesh_distance, hybrid_ba,
            log_sinkhorn, sample_descriptors, sold2_lines, lbd_describe,
            ncc_argmax, tplsd_decode, l2d2_patches)
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
    for case, res in tri_checks.check_all_scan():
        log(f"[kernel] tri_propose exhaustive vs its first design "
            f"(propose_exhaustive_scan), case {case}: {json.dumps(res)}")
        check(res["bit_equal"], ("tri_propose exhaustive vs scan", case, res))
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
    t0 = time.perf_counter()
    n0 = klm_launches()
    for name, case, res in lm_checks.check_all_klm():
        log(f"[kernel] {name} vs plain, case {case}: {json.dumps(res)}")
        check(res["ok"], (name, "vs plain", case, res))
    n1 = klm_launches()
    check(all(n1[k] > n0[k] for k in n0), ("K, L, M launches counted",
                                          n0, n1))
    log(f"[kernel] lm_line_refine, lm_assoc_lines, lm_assoc_points seeded "
        f"cases took {time.perf_counter() - t0:.1f} s")
    mesh_seeded_cases()
    hybrid_seeded_cases()

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

    # ---- 15a. the learned front end, card against CPU ----
    learned_card_vs_cpu()
    from limap_tpu_torch.testing import learned
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt = learned.write_random_checkpoints(ckpt_dir.name)
    log(f"[learned] random checkpoints in the published layouts: "
        f"{json.dumps({k: os.path.basename(v) for k, v in ckpt.items()})}")

    # ---- 7. the pipeline from pixels at full width ----
    with tempfile.TemporaryDirectory() as workdir:
        for kernel in kernels.values():
            kernel.launches = 0
        reset_triangulator_launches()
        recorders = triangulator_recorders()
        try:
            pixel_queries, pixel_cloud, scene, runner_tracks, \
                pixel_lines = from_pixels_full_width(card, workdir)
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
        loc_launches, recorded, loc_direct = localization_full_width(
            scene, runner_tracks, workdir, card)
        log(f"[localize] phase 8 took {time.perf_counter() - t0:.1f} s")
        if opts.save_loc_inputs:
            save_loc_inputs(recorded, opts.save_loc_inputs)
        t0 = time.perf_counter()
        entries += measure_localization_kernels(recorded, loc_launches)
        log(f"[localize] phase 8's kernel checks took "
            f"{time.perf_counter() - t0:.1f} s")
        del recorded
        # phase 14's localization CLI, on phase 8's map and queries
        t0 = time.perf_counter()
        localization_cli(scene, runner_tracks, loc_direct, workdir, card)
        log(f"[refine cli] the localization CLI took "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 15's localization with superglue_endpoints, on phase 8's
        # map and queries
        t0 = time.perf_counter()
        learned_localization(scene, runner_tracks, loc_direct["q"], ckpt,
                             workdir, card)
        log(f"[learned localize] took {time.perf_counter() - t0:.1f} s")

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
        recorded, ex_launches, ex_path_launches, ex_queries, ex_cloud = \
            exhaustive_full_width(scene, os.path.join(workdir, "exhaustive"),
                                  card)
        nn_launches = {name: k.launches for name, k in kernels.items()}
        check(nn_launches["nn_min_dist"] > 0,
              "the exhaustive path did not launch nn_min_dist")
        check(nn_launches["nn_min_dist_scalar"] == 0,
              "the exhaustive path launched the yardstick kernel")
        entries += measure_kernels(kernels, "exhaustive", ex_queries,
                                   ex_cloud, nn_launches)
        del ex_queries, ex_cloud
        entries += measure_exhaustive_kernels(recorded, ex_launches,
                                              ex_path_launches)
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
        recorded, vp_launches, facade_map = colmap_vp_full_width(workdir,
                                                                 card)
        entries.append(measure_vp_detect(recorded["vp_detect"],
                                         vp_launches["vp_detect"]))
        entries += measure_triangulator_kernels("colmap_vp", recorded,
                                                vp_launches)
        del recorded
        log(f"[colmap-vp] phase 11 took {time.perf_counter() - t0:.1f} s")

        # ---- 12a. refinement and association, card against CPU ----
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            pointline_card_vs_cpu(small)
        log(f"[pointline card-vs-cpu] phase 12a took "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 12. refinement and association at full width ----
        t0 = time.perf_counter()
        recorded, pl_launches, wall = pointline_full_width(
            workdir, *facade_map, card)
        log(f"[pointline] phase 12's path took {wall:.1f} s")
        entries += measure_klm(recorded, pl_launches)
        del recorded, facade_map
        log(f"[pointline] phase 12 took {time.perf_counter() - t0:.1f} s")

    # ---- 13. the GT evaluation of phase 7's map at full width ----
    t0 = time.perf_counter()
    entries.append(evaluation_full_width(pixel_lines, scene[3], card))
    log(f"[evaluation] phase 13 took {time.perf_counter() - t0:.1f} s")

    # ---- 14a. the joint SfM refinement, card against CPU ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as small:
        refine_card_vs_cpu(small)
    log(f"[refine card-vs-cpu] phase 14a took "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 14. the joint SfM refinement and the CLIs at full width ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        recorded, hba_launches, refine_scene, refine_out = \
            refine_full_width(workdir, card)
        direct, gt_calls, gt_launches = refine_gt_map(refine_scene, card)
        entries += measure_hybrid(recorded, hba_launches, gt_calls,
                                  gt_launches)
        del recorded, gt_calls
        refine_clis(refine_scene, direct, workdir, card)
        ba_inputs = refine_ba_inputs(refine_scene, refine_out)
    log(f"[refine] phase 14 took {time.perf_counter() - t0:.1f} s")

    # ---- 15. the learned front end at full width ----
    t0 = time.perf_counter()
    items = learned_points_full_width(scene, ckpt, card)
    with tempfile.TemporaryDirectory() as workdir:
        items += sinkhorn_runner_full_width(workdir, card)
    items += sold2_full_width(scene, ckpt, card)
    log(f"[learned] phase 15's paths took {time.perf_counter() - t0:.1f} s")
    entries += measure_learned(items)
    log(f"[learned] phase 15 took {time.perf_counter() - t0:.1f} s")

    # ---- 16a. the rest of the learned zoo, card against CPU ----
    zoo_card_vs_cpu(ckpt)

    # ---- 16. the rest of the learned zoo at full width ----
    t0 = time.perf_counter()
    entries += zoo_full_width(scene, ckpt, card)
    ckpt_dir.cleanup()
    log(f"[zoo] phase 16 took {time.perf_counter() - t0:.1f} s")

    # ---- 17. the multi-card form: one NCCL rank, two gloo ranks ----
    t0 = time.perf_counter()
    multicard(ba_inputs, card)
    log(f"[multi-card] phase 17 took {time.perf_counter() - t0:.1f} s "
        f"on {card}")

    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
