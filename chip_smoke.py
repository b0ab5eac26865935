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
     -> line BA, then GT evaluation, with quality gates;
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
     and timings of both kernels on that evaluation's input.

Prints the kernels' JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

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
                avg_segs=float(np.mean([len(v) for v in segs.values()])))


def hold_to_gates(what, measured, ref):
    for name, unit, slack in FROM_PIXELS_GATES:
        got = measured[name]
        margin = slack if unit == "points" else ref[name] * slack
        log(f"[{what}] gate {name}: {got:.4f} against the reference's "
            f"{ref[name]:.4f} ({unit} {slack})")
        check(abs(got - ref[name]) <= margin,
              (what, "gate", name, got, ref[name]))


def from_pixels_full_width(card):
    """Phase 7: the runner once, then two passes of the timed pipeline
    (the first warms the allocator and the libraries), each held to the
    gates, then GT evaluation of the second pass's tracks.  Returns the
    evaluation's queries and cloud on the card."""
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    from limap_tpu_torch.line2d.tpu_lsd import detect_segments
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.testing.synthetic import gt_point_cloud

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        scene = pipeline.build_scene(
            image_dir=os.path.join(workdir, "images"))
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
        hold_to_gates("runner", runner_full_width(
            scene, os.path.join(workdir, "runner"), card), REFERENCE_RUNNER)

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
    return evaluation_queries(r["linetracks"], 1000), evaluator.points


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

    # ---- 1. build ----
    t0 = time.perf_counter()
    nnd.build()
    log(f"[build] nn_min_dist.cu built in {time.perf_counter() - t0:.2f} s")
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

    # ---- 4. the main path at full width ----
    for kernel in kernels.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tracks, rep, stages, n_queries, cloud = run_slice(
        "cuda", n_views=100, n_lines=1500, n_neighbors=20)
    main_launches = {name: k.launches for name, k in kernels.items()}
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

    # ---- 6. front end and runner, card against CPU ----
    with tempfile.TemporaryDirectory() as workdir:
        front_end_card_vs_cpu(workdir)

    # ---- 7. the pipeline from pixels at full width ----
    for kernel in kernels.values():
        kernel.launches = 0
    pixel_queries, pixel_cloud = from_pixels_full_width(card)
    pixel_launches = {name: k.launches for name, k in kernels.items()}
    check(pixel_launches["nn_min_dist"] > 0,
          "the from-pixels path did not launch nn_min_dist")
    check(pixel_launches["nn_min_dist_scalar"] == 0,
          "the from-pixels path launched the yardstick kernel")
    entries += measure_kernels(kernels, "from_pixels", pixel_queries,
                               pixel_cloud, pixel_launches)

    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
