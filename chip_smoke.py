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
  5. time each kernel beside its bound, its plain version and one
     PyTorch library call computing the same function; the tensor-core
     kernel and the CUDA-core yardstick in turns.

Prints the kernels' JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
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
F2D = {"th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
       "th_sv_num_supports": 3, "th_overlap": 0.05,
       "th_overlap_num_supports": 3}
TAUS = (0.01, 0.05, 0.1)


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
    """The port's slice through its entry points; returns (tracks,
    report, per-stage seconds, queries and cloud of the evaluation)."""
    from limap_tpu_torch.base.line_linker import LineLinker3dConfig
    from limap_tpu_torch.base.linetrack import batch_to_tracks
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    from limap_tpu_torch.merging.merging import (compact_track_batch,
                                                 filter_chain_batch)
    from limap_tpu_torch.optimize.line_ba import (
        LineBAConfig, get_output_tracks, solve_line_bundle_adjustment)
    from limap_tpu_torch.testing.synthetic import (build_scene,
                                                   gt_point_cloud)
    from limap_tpu_torch.triangulation.triangulator import (
        GlobalLineTriangulator, TriangulatorConfig)

    imagecols, segs, nbrs, gt = build_scene(n_views, n_lines, n_neighbors,
                                            device=device)
    if noise:
        rng = np.random.default_rng(1)
        segs = {k: (v + rng.normal(0, noise, v.shape)).astype(np.float32)
                for k, v in segs.items()}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t = {}

    def stage(name, t0):
        sync()
        t[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    tri = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=32),
                                 device=device)
    tri.init(segs, imagecols)
    tri.triangulate_all(nbrs)
    t0 = stage("triangulate", t0)
    tb, host = tri.compute_track_batch(return_host=True)
    t0 = stage("tracks", t0)
    views = imagecols.batch(device)
    tb, host = filter_chain_batch(tb, views, F2D, LineLinker3dConfig(),
                                  host=host)
    tb, host = compact_track_batch(host.refresh(tb, with_line=True),
                                   return_host=True, device=device)
    t0 = stage("filters", t0)
    cfg = LineBAConfig(max_num_iterations=20)
    refined, _ = solve_line_bundle_adjustment(tb, views, cfg)
    tb = get_output_tracks(tb, views, refined, cfg.num_outliers_aggregator)
    tracks = [x for x in batch_to_tracks(tb, host=host) if x.count_lines()]
    t0 = stage("ba", t0)
    cloud = gt_point_cloud(gt, points_per_segment)
    evaluator = PointCloudEvaluator(cloud, device=device)
    lines = np.stack([x.line for x in tracks])
    report = report_error_to_gt(evaluator, lines, TAUS, n_samples)
    stage("evaluate", t0)
    return tracks, report, t, len(lines) * n_samples, evaluator.points


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


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible")
        return 2
    from limap_tpu_torch.ops import cuda_build
    from limap_tpu_torch.ops import nn_distance as nnd

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

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

    # ---- 5. kernel timing at the main path's shapes ----
    from limap_tpu_torch.evaluation import evaluator as evaluator_module
    from limap_tpu_torch.evaluation.evaluator import (PointCloudEvaluator,
                                                      report_error_to_gt)
    queries = evaluation_queries(tracks, 1000)
    check(queries.shape[0] == n_queries, "query count")
    sub = queries[:8192].contiguous()
    max_err = {name: max_err_to_plain(kernel, sub, cloud)
               for name, kernel in kernels.items()}
    for name, err in max_err.items():
        check(err <= 1e-5, (name, "vs plain at full shape", err))
    S, M = queries.shape[0], cloud.shape[0]

    def library():
        step = 1024
        return torch.cat([torch.cdist(queries[i:i + step], cloud).amin(1)
                          for i in range(0, S, step)])

    # the two kernels in turns on this one card
    turns = ["nn_min_dist_scalar", "nn_min_dist", "nn_min_dist",
             "nn_min_dist_scalar"]
    times = {name: [] for name in kernels}
    for name in turns:
        times[name].append(cuda_ms(
            lambda: kernels[name](queries, cloud), 3))
    log(f"[time] in turns {turns}: {json.dumps(times)} ms")
    check(torch.equal(nnd.nn_min_dist(queries, cloud),
                      nnd.nn_min_dist_scalar(queries, cloud)),
          "the two kernels differ at the main path's shapes")
    confirms_per_query = int(nnd.nn_min_dist.confirms) / S

    # the evaluation stage on either kernel
    lines = np.stack([x.line for x in tracks])
    evaluator = PointCloudEvaluator(cloud.cpu().numpy(), device="cuda")
    evaluate_s = {}
    for name in turns:
        evaluator_module.nn_min_dist = kernels[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report_error_to_gt(evaluator, lines, TAUS, 1000)
        torch.cuda.synchronize()
        evaluate_s.setdefault(name, []).append(time.perf_counter() - t0)
    evaluator_module.nn_min_dist = nnd.nn_min_dist
    log(f"[time] evaluate stage seconds by kernel {json.dumps(evaluate_s)}")

    plain_ms = cuda_ms(lambda: nnd.nn_min_dist_plain(queries, cloud), 1,
                       warmup=False)
    library_ms = cuda_ms(library, 1, warmup=False)
    # the least time of any implementation: per pair 16 TF32 operations
    # (one k=8 product) on the tensor cores or one fp32 compare on the
    # CUDA cores, or the bytes; beside it the bound of the CUDA-core
    # route (8 fp32 operations a pair)
    seconds = {"operations": max(S * M * 16 / TF32_PEAK,
                                 S * M / (FP32_PEAK / 2)),
               "bytes": (S * 12 + M * 12 + S * 4) / HBM_BYTES_PER_S}
    bound_by = max(seconds, key=seconds.get)
    entries = []
    for name in kernels:
        entries.append({
            "name": name, "route": "cuda",
            "source": "limap_tpu_torch/csrc/nn_min_dist.cu",
            "replaces": "limap_tpu/ops/pallas/nn_distance.py:55",
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": sum(times[name]) / len(times[name]),
            "ms_turns": times[name],
            "plain_ms": plain_ms, "bound_ms": seconds[bound_by] * 1e3,
            "bound_by": bound_by,
            "cuda_core_bound_ms": S * M * 8 / FP32_PEAK * 1e3,
            "library_ms": library_ms, "queries": S, "points": M,
            "on_main_path": name == "nn_min_dist",
            "evaluate_stage_s": evaluate_s[name]})
    entries[0]["confirms_per_query"] = confirms_per_query
    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
