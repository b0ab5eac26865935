"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a GPU.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import nn_distance as nnd
from limap_tpu_torch.ops.epipolar_iou import epipolar_iou_grid
from limap_tpu_torch.ops.pose_score import pose_score
from limap_tpu_torch.ops.trace_roots import trace_roots
from limap_tpu_torch.testing import (fitnmerge_checks, kernel_checks,
                                     lm_checks, tri_checks)
from limap_tpu_torch.testing.evaluation import mesh_cases
from limap_tpu_torch.ops.nn_distance import (nn_min_dist, nn_min_dist_plain,
                                             nn_min_dist_scalar)

pytestmark = pytest.mark.cuda

KERNELS = {"nn_min_dist": nn_min_dist,
           "nn_min_dist_scalar": nn_min_dist_scalar}
# ragged sizes (none a multiple of the scalar kernel's 256 threads and
# 2048-point tiles or of the tensor-core kernel's 256-query blocks and
# 1024-point stages, M below one tile, S = 1) and one evaluation-sized cloud
SIZES = [(1, 5), (70, 300), (257, 1025), (513, 2049), (33, 4097),
         (8192, 100_000)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def adversarial(kind):
    """Inputs built against the tensor-core filter (numpy fp32)."""
    rng = np.random.default_rng(7)
    p = rng.uniform(-10, 10, (20_000, 3))
    q = p[rng.integers(0, len(p), 2000)] + rng.normal(0, 0.02, (2000, 3))
    if kind == "shifted":       # a scene 1 km from the origin on each axis
        p, q = p + 1000.0, q + 1000.0
    elif kind == "zero":        # the cloud holds the queries, and twice
        p = np.concatenate([p, q, q, p[:500]])
    elif kind == "clusters":    # points within 1e-4 m around each query
        p = np.concatenate([p] + [q + rng.normal(0, 1e-4, q.shape)
                                  for _ in range(6)])
    return q.astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("S,M", SIZES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_vs_plain(cuda, name, S, M):
    kernel = KERNELS[name]
    rng = np.random.default_rng(S + M)
    q = torch.as_tensor(rng.normal(size=(S, 3)).astype(np.float32),
                        device="cuda")
    p = torch.as_tensor((rng.normal(size=(M, 3)) * 2).astype(np.float32),
                        device="cuda")
    n0 = kernel.launches
    d = kernel(q, p)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    # both take the difference form in fp32; the rounding order differs
    torch.testing.assert_close(d, nn_min_dist_plain(q, p), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["shifted", "zero", "clusters"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_adversarial(cuda, name, kind):
    q, p = (torch.as_tensor(x, device="cuda") for x in adversarial(kind))
    d = KERNELS[name](q, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, nn_min_dist_plain(q, p), rtol=1e-5,
                               atol=1e-6)


def test_kernels_agree_bit_for_bit(cuda):
    """The confirm step is the scalar kernel's arithmetic on the pairs
    that matter, so the two kernels return the same bits."""
    q, p = (torch.as_tensor(x, device="cuda") for x in adversarial("zero"))
    assert torch.equal(nn_min_dist(q, p), nn_min_dist_scalar(q, p))
    confirms = int(nn_min_dist.confirms)
    assert 0 < confirms < 0.05 * q.shape[0] * p.shape[0]


def test_filter_tile_vs_plain(cuda):
    """The mma fragment layout and the staging: the kernel's raw filter
    values against the fp32 matrix product of the same operands."""
    q, p = (torch.as_tensor(x, device="cuda")
            for x in adversarial("shifted"))
    B, centre, p_max, _ = nnd.prepare_cloud_operand(p[:1500])
    A, ss, _ = nnd.prepare_query_operand(q[:600], centre, p_max)
    D = nnd.filter_tile_values(A, B)
    torch.cuda.synchronize()
    ref = nnd.filter_values_plain(A, B[:nnd.CLOUD_PAD])
    # 8 addends of magnitude up to (||s'|| + ||p'||)^2, each truncated
    # at the largest one's last place by the tensor cores
    atol = 2.0 ** -19 * float((ss.max().sqrt() + p_max) ** 2)
    torch.testing.assert_close(D, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_nn_min_dist_kernel_edge_cases(cuda, name):
    kernel = KERNELS[name]
    p = torch.randn(10, 3, device="cuda")
    assert kernel(torch.zeros((0, 3), device="cuda"), p).shape == (0,)
    out = kernel(torch.randn(4, 3, device="cuda"),
                 torch.zeros((0, 3), device="cuda"))
    assert torch.isinf(out).all()
    with pytest.raises(ValueError):
        kernel(torch.randn(4, 3, device="cuda"), p.cpu())


def test_tpu_lsd_repeats_on_the_card_and_agrees_with_the_cpu(cuda):
    """The card adds a component's moments in pixel order, so two runs
    give the same bits, and the CPU's segments within 0.05 px (measured
    0.011 px at 800x600 on an H100)."""
    from limap_tpu_torch.line2d.tpu_lsd import detect_segments
    from limap_tpu_torch.testing import pipeline
    img = pipeline.build_scene(n_views=1)[1][0]
    first = detect_segments(img, max_segs=3000, device="cuda")
    again = detect_segments(img, max_segs=3000, device="cuda")
    assert np.array_equal(first, again) and len(first) > 300
    cpu = detect_segments(img, max_segs=3000, device="cpu")
    offs = np.abs(cpu[:, None, :4] - first[None, :, :4]).max(-1).min(1)
    assert (offs > 0.05).sum() <= 0.02 * len(cpu)


@pytest.mark.parametrize("seed,degenerate", kernel_checks.SEEDS)
@pytest.mark.parametrize("kernel", kernel_checks.KERNELS)
def test_localization_kernel_vs_plain(cuda, kernel, seed, degenerate):
    """trace_roots, pose_score and epipolar_iou_grid against their plain
    versions on seeded inputs, the third degenerate (parallel lines,
    poses with the scene behind the camera and NaN poses, zero-length
    segments); tolerances in limap_tpu_torch/testing/kernel_checks.py."""
    launches = {"trace_roots": trace_roots, "pose_score": pose_score,
                "epipolar_iou_grid": epipolar_iou_grid}[kernel]
    n0 = launches.launches
    res = kernel_checks.check_one(kernel, seed, degenerate)
    torch.cuda.synchronize()
    assert launches.launches > n0
    assert res["ok"], res


@pytest.mark.parametrize("case", fitnmerge_checks.RANSAC_CASES)
def test_line_ransac_kernel_vs_plain(cuda, case):
    """The RANSAC scoring kernel against its plain version at ragged
    sizes, with invalid samples (NaN points among them), all-invalid rows
    and points exactly on the threshold: equal masks, counts and best
    hypotheses."""
    from limap_tpu_torch.ops.line_ransac import line_ransac
    n0 = line_ransac.launches
    res = fitnmerge_checks.check_line_ransac(*case)
    torch.cuda.synchronize()
    assert line_ransac.launches == n0 + 1
    assert res["ok"] and res["rows_differ"] == 0, res


@pytest.mark.parametrize("config", fitnmerge_checks.LINKER_CONFIGS)
@pytest.mark.parametrize("case", fitnmerge_checks.LINKER_CASES)
def test_linker_edges_kernel_vs_plain(cuda, case, config):
    """The linker's edge test against its plain version at ragged sizes,
    with masked lines, dead neighbour slots and pairs built just inside
    and outside each threshold, under two linker configs: equal bits but
    for flips within rounding of a threshold, no more of them than the
    plain version's own one-ulp spread plus one."""
    from limap_tpu_torch.ops.linker_edges import linker_edges
    n0 = linker_edges.launches
    res = fitnmerge_checks.check_linker_edges(*case, config)
    torch.cuda.synchronize()
    assert linker_edges.launches == n0 + 1
    assert res["ok"], res


def test_fitnmerge_kernels_refuse_what_they_cannot_take(cuda):
    from limap_tpu_torch.ops.line_ransac import MAX_SAMPLES, line_ransac
    pts = torch.zeros((2, MAX_SAMPLES + 1, 3), device="cuda")
    valid = torch.ones((2, MAX_SAMPLES + 1), dtype=torch.bool, device="cuda")
    idx = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    th = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="samples"):
        line_ransac(pts, valid, th, idx, idx)
    with pytest.raises(ValueError, match="idx_a"):
        line_ransac(pts[:, :8], valid[:, :8], th, idx.cpu(), idx)


TRI_CASES = [(name, case) for case in ("6x120, 0.3 px", "4x40, endpoints")
             for name in ("tri_propose words", "tri_score words",
                          "tri_propose exhaustive", "tri_score exhaustive")]


@pytest.fixture(scope="module")
def tri_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return {(name, case): res
            for name, case, res in tri_checks.check_all("cuda")}


@pytest.mark.parametrize("name,case", TRI_CASES)
def test_triangulator_kernels_vs_plain(tri_results, name, case):
    res = tri_results[(name, case)]
    assert res["ok_to_plain"], res


def test_triangulator_kernels_count_their_launches(cuda):
    from limap_tpu_torch.ops import tri_propose, tri_score
    tri, matches = tri_checks.seeded_inputs(n_views=3, n_lines=20)
    n_f, n_g = tri_propose.propose.launches, tri_score.score.launches
    tri.triangulate_all(matches)
    assert tri_propose.propose.launches == n_f + 1
    assert tri_score.score.launches == n_g + 1
    tri.triangulate_all_exhaustive({i: sorted(m) for i, m in
                                    matches.items()})
    # the count, then the write; then the score
    assert tri_propose.propose.launches == n_f + 3
    assert tri_score.score.launches == n_g + 2


def test_triangulator_kernels_refuse_what_they_cannot_take(cuda):
    from limap_tpu_torch.ops import tri_propose, tri_score
    tri, matches = tri_checks.seeded_inputs(n_views=3, n_lines=20)
    meta = torch.zeros((3, 3), dtype=torch.int32, device="cuda")
    words = torch.zeros((3, tri.L, 4), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        tri_propose.propose(tri.cfg, tri.L, 2, tri._l2d_packed,
                            tri._cam_packed, words, meta)
    with pytest.raises(ValueError):
        tri_score.score(tri.cfg, tri.L, 2, tri._l2d_packed, tri._cam_packed,
                        words.int(), meta,
                        torch.zeros((3 * tri.L, 4, 9), device="cuda"),
                        torch.zeros((3 * tri.L, 5), dtype=torch.bool,
                                    device="cuda"))
    nbrs = {i: sorted(m) for i, m in matches.items()}
    counts = tri_propose.count_exhaustive(
        tri.cfg, tri.L, 2, tri._l2d_packed, tri._cam_packed,
        tri._device(tri._meta([[tri.id2idx[n] for n in nbrs[i]]
                               for i in sorted(nbrs)],
                              [tri.id2idx[i] for i in sorted(nbrs)], 2)))
    assert int(counts.max()) > 2
    with pytest.raises(ValueError, match="survivors"):
        tri_propose.propose_exhaustive(
            tri.cfg, tri.L, 2, tri._l2d_packed, tri._cam_packed,
            tri._device(tri._meta([[tri.id2idx[n] for n in nbrs[i]]
                                   for i in sorted(nbrs)],
                                  [tri.id2idx[i] for i in sorted(nbrs)], 2)),
            2)


SCAN_CASES = ["6x120, 0.3 px", "4x40, endpoints", "4x40, ranges",
              "5x36, slots of -1"]


@pytest.fixture(scope="module")
def scan_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return dict(tri_checks.check_all_scan("cuda"))


@pytest.mark.parametrize("case", SCAN_CASES)
def test_exhaustive_passes_equal_the_first_design_bit_for_bit(scan_results,
                                                              case):
    """F's tiled count and write (with the count's slot counts and
    without) give the first design's counts, words, rows and ok bit for
    bit."""
    res = scan_results[case]
    assert res["bit_equal"], res
    if case.endswith("-1"):
        assert res["empty_slots"] > 0


def test_exhaustive_scan_counts_its_own_launches(cuda):
    from limap_tpu_torch.ops import tri_propose
    tri, matches = tri_checks.seeded_inputs(n_views=3, n_lines=20)
    n_f = tri_propose.propose.launches
    n_s = tri_propose.propose_exhaustive_scan.launches
    n_t = tri_propose.exhaustive_tables.launches
    tri.triangulate_all_exhaustive({i: sorted(m) for i, m in
                                    matches.items()})
    # one table launch for the count and the write
    assert tri_propose.propose.launches == n_f + 2
    assert tri_propose.exhaustive_tables.launches == n_t + 1
    assert tri_propose.propose_exhaustive_scan.launches == n_s
    case, args = next(tri_checks.scan_cases("cuda"))
    tri_checks.compare_to_scan(*args)
    # the scan's count and write; the tiled count, and two writes of which
    # one counts first and builds its own tables
    assert tri_propose.propose_exhaustive_scan.launches == n_s + 2
    assert tri_propose.propose.launches == n_f + 6
    assert tri_propose.exhaustive_tables.launches == n_t + 3


def test_lm_kernels_vs_plain_seeded(cuda):
    """H and I against plain, every row, on the seeded cases: 3 losses
    of the line BA, every cost function, weight and loss of the pose
    solve, and the corners (|cos| = 1 under line3dpp, parallel rays
    under 3d_line_line_dist2, zero-weight rows)."""
    failed = [(name, case, res) for name, case, res in lm_checks.check_all()
              if not res["ok"]]
    assert not failed, failed


def test_lm_kernels_count_their_launches(cuda):
    from limap_tpu_torch.ops import lm_jointloc, lm_line_ba
    from limap_tpu_torch.optimize.line_ba import LineBAConfig
    params0, aux = lm_checks.seeded_line_ba(T=8, S=6)
    n0 = lm_line_ba.solve.launches
    lm_line_ba.solve(params0, *aux, LineBAConfig(), num_iterations=3)
    lm_line_ba.normal_equations(params0, *aux, LineBAConfig())
    torch.cuda.synchronize()
    assert lm_line_ba.solve.launches == n0 + 1
    params0, data = lm_checks.seeded_jointloc(T=3)
    cfg = lm_checks.loc_config(*lm_checks.JOINTLOC_CONFIGS[-1])
    n0 = lm_jointloc.solve.launches
    lm_jointloc.solve(params0, *data, cfg, num_iterations=3)
    lm_jointloc.normal_equations(params0, *data, cfg)
    torch.cuda.synchronize()
    assert lm_jointloc.solve.launches == n0 + 1


def test_lm_kernels_at_the_corners(cuda):
    from limap_tpu_torch.ops import lm_jointloc, lm_line_ba
    from limap_tpu_torch.optimize.line_ba import LineBAConfig
    params0, aux = lm_checks.seeded_line_ba(T=32, S=12)
    res = lm_line_ba.solve(params0, *aux, LineBAConfig())
    zero = aux[5].sum(1) == 0
    assert zero.any() and torch.equal(res.params[zero], params0[zero])
    assert (res.cost[zero] == 0).all() and (res.n_accepted[zero] == 0).all()
    params0, data = lm_checks.seeded_jointloc(seed=2, corners=True)
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "line3dpp",
                               "huber", 1.0, 1.0)
    ne_k = lm_jointloc.normal_equations(params0, *data, cfg)
    ne_p = lm_jointloc.normal_equations_plain(params0, data, cfg)
    for k, p in zip(ne_k, ne_p):
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        assert torch.equal(torch.isinf(k), torch.isinf(p))
    assert not torch.isfinite(ne_k[0][0]).all()      # |cos| = 1 in row 0
    res = lm_jointloc.solve(params0, *data, cfg)
    plain = lm_jointloc.solve_plain(params0, data, cfg)
    for r in (res, plain):   # row 0 stalls; the masked-out row stays put
        assert int(r.n_accepted[0]) == 0 and int(r.n_accepted[-1]) == 0
        assert torch.equal(r.params[0], params0[0])
        assert torch.equal(r.params[-1], params0[-1])
        assert float(r.cost[-1]) == 0.0


def test_lm_kernels_refuse_what_they_cannot_take(cuda):
    from limap_tpu_torch.ops import lm_jointloc, lm_line_ba
    from limap_tpu_torch.optimize.line_ba import LineBAConfig
    params0, aux = lm_checks.seeded_line_ba(T=8, S=6)
    with pytest.raises(ValueError):
        lm_line_ba.solve(params0.double(), *aux, LineBAConfig())
    with pytest.raises(ValueError):
        lm_line_ba.solve(params0, *aux[:-1], aux[-1].cpu(), LineBAConfig())
    with pytest.raises(ValueError):
        lm_line_ba.solve(params0[:4], *aux, LineBAConfig())
    params0, data = lm_checks.seeded_jointloc(T=3)
    cfg = lm_checks.loc_config(*lm_checks.JOINTLOC_CONFIGS[0])
    with pytest.raises(ValueError):
        lm_jointloc.solve(params0, *data[:4], data[4].float(), *data[5:],
                          cfg)
    with pytest.raises(ValueError):
        lm_jointloc.solve(params0, *data[:8], data[8].cpu(), cfg)
    with pytest.raises(ValueError):
        lm_jointloc.solve(params0, *data, dataclasses.replace(
            cfg, cost_function="2d_unknown"))



def test_klm_kernels_vs_plain_seeded(cuda):
    """K (each term alone and all four), L (with and without VPs) and M
    (empty, seeded and full association slots) against plain, every row,
    on the seeded cases; partings witnessed in float64."""
    failed = [(name, case, res) for name, case, res
              in lm_checks.check_all_klm() if not res["ok"]]
    assert not failed, failed


def test_klm_kernels_count_their_launches(cuda):
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    params0, data = lm_checks.seeded_refine(T=8, S=6, F=3)
    d, terms = lm_checks.refine_case(params0, data, "all")
    n0 = lm_line_refine.solve.launches
    lm_line_refine.solve(params0, d, terms, num_iterations=3)
    lm_line_refine.normal_equations(params0, d, terms)
    lp, ldata, pp, pdata = lm_checks.seeded_assoc(T=8, S=6, n_points=20)
    nl, npnt = lm_assoc.solve_lines.launches, lm_assoc.solve_points.launches
    lm_assoc.solve_lines(lp, ldata, AssocTerms(), num_iterations=3)
    lm_assoc.solve_points(pp, pdata, AssocTerms(), num_iterations=3)
    lm_assoc.normal_equations_points(pp, pdata, AssocTerms())
    torch.cuda.synchronize()
    assert lm_line_refine.solve.launches == n0 + 1
    assert lm_assoc.solve_lines.launches == nl + 1
    assert lm_assoc.solve_points.launches == npnt + 1


def test_klm_kernels_refuse_what_they_cannot_take(cuda):
    from limap_tpu_torch.ops import lm_assoc, lm_line_refine
    from limap_tpu_torch.ops.lm_assoc import AssocTerms
    params0, data = lm_checks.seeded_refine(T=8, S=6, F=3)
    d, terms = lm_checks.refine_case(params0, data, "all")
    with pytest.raises(ValueError):
        lm_line_refine.solve(params0.double(), d, terms)
    with pytest.raises(ValueError):
        lm_line_refine.solve(params0, d._replace(fc_ref=d.fc_ref.long()),
                             terms)
    lp, ldata, pp, pdata = lm_checks.seeded_assoc(T=8, S=6, n_points=20)
    with pytest.raises(ValueError):
        lm_assoc.solve_lines(lp, ldata._replace(points=ldata.points[:0]),
                             AssocTerms())
    with pytest.raises(ValueError):
        lm_assoc.solve_points(pp, pdata._replace(mask=pdata.mask.cpu()),
                              AssocTerms())


VP_CASES = ["ragged 491/37/0/950/120/3 lines, H 512",
            "20 lines < H 512, 4 VPs", "on the threshold and tied counts",
            "3500 lines (mask past shared memory)"]


@pytest.fixture(scope="module")
def vp_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from limap_tpu_torch.testing import vp_checks
    return dict(vp_checks.check_all("cuda"))


@pytest.mark.parametrize("case", VP_CASES)
def test_vp_detect_kernel_vs_plain(vp_results, case):
    res = vp_results[case]
    assert res["ok"], res


def test_vp_detect_runs_every_image_in_one_launch(cuda):
    from limap_tpu_torch.ops import vp_detect
    from limap_tpu_torch.testing import vp_checks
    from limap_tpu_torch.vplib import JLinkage, JLinkageConfig
    rng = np.random.default_rng(3)
    segs = {i: vp_checks.random_image(rng, n) for i, n in
            enumerate((300, 40, 5, 700))}
    n0 = vp_detect.detect.launches
    card = JLinkage(JLinkageConfig(), seed=2, device="cuda")
    res = card.detect_vp_all_images(segs)
    assert vp_detect.detect.launches == n0 + 1
    cpu = JLinkage(JLinkageConfig(), seed=2,
                   device="cpu").detect_vp_all_images(segs)
    for i in segs:
        np.testing.assert_array_equal(res[i].labels, cpu[i].labels)
        np.testing.assert_allclose(res[i].vps, cpu[i].vps, atol=1e-5)


TRI_VP_CASES = [(name, case) for case in ("6x120 vp", "6x120 vp only",
                                          "4x40 vp, ranges")
                for name in ("tri_propose vp", "tri_score vp")]


@pytest.fixture(scope="module")
def tri_vp_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return {(name, case): res
            for name, case, res in tri_checks.check_all_vp("cuda")}


@pytest.mark.parametrize("name,case", TRI_VP_CASES)
def test_triangulator_vp_banks_vs_plain(tri_vp_results, name, case):
    res = tri_vp_results[(name, case)]
    assert res["ok_to_plain"], res


@pytest.mark.parametrize("case", range(len(mesh_cases())))
def test_mesh_min_dist_kernel_vs_plain(cuda, case):
    """Kernel N against its plain scan on the seeded cases: bit for bit
    (the same correctly rounded fp32 operations in the same order, only
    pairs above a point's best skipped), one launch counted, its counts
    those of the cull's replay on the same prepared arrays; the first
    design (every pair) bit for bit too."""
    from limap_tpu_torch.ops import mesh_distance as md
    _, p, t = mesh_cases()[case]
    pc = torch.as_tensor(p, device="cuda")
    tc = torch.as_tensor(t, device="cuda")
    n0 = md.mesh_min_dist.launches
    got = md.mesh_min_dist(pc, tc)
    counts = md.mesh_min_dist.counts.tolist()
    ref = md.mesh_min_dist_plain(pc, tc)
    torch.cuda.synchronize()
    assert md.mesh_min_dist.launches == n0 + 1
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert torch.equal(md.mesh_min_dist_scan(pc, tc), ref)
    mesh = md.prepare_mesh(tc)
    _, replay = md.mesh_min_dist_culled(
        pc.cpu(), md.PreparedMesh(*(x.cpu() for x in mesh)))
    assert counts == [replay[k] for k in md.COUNTS]


@pytest.mark.parametrize("what", ["over", "beside", "far"])
def test_mesh_min_dist_culls_the_wall(cuda, what):
    """On the full wall mesh (135,000 triangles) the kernel is bit-equal
    to the plain scan and evaluates the replay's pairs: a few per mille of
    them over and beside the wall."""
    from limap_tpu_torch.ops import mesh_distance as md
    from limap_tpu_torch.testing.evaluation import wall_mesh, wall_samples
    verts, faces = wall_mesh()
    tris = torch.as_tensor(verts[faces], device="cuda")
    mesh = md.prepare_mesh(tris)
    q = wall_samples(what).cuda()
    got = md.mesh_min_dist(q, mesh)
    counts = md.mesh_min_dist.counts.tolist()
    assert torch.equal(got, md.mesh_min_dist_plain(q, tris))
    _, replay = md.mesh_min_dist_culled(
        q.cpu(), md.PreparedMesh(*(x.cpu() for x in mesh)))
    assert counts == [replay[k] for k in md.COUNTS]


@pytest.mark.parametrize("N1,N2,D", [(129, 257, 64), (1000, 1301, 64),
                                     (7500, 300, 64), (300, 7500, 49)])
def test_ncc_argmax_both_equals_the_row_scan(cuda, N1, N2, D):
    """Kernel W's one pass gives, in both directions, the first design's
    one-direction results bit for bit (the same fmaf chains), across
    ragged 128-row tiles."""
    from limap_tpu_torch.ops import ncc_argmax as W
    g = torch.Generator(device="cuda").manual_seed(N1 + N2)
    f1 = torch.randn(N1, D, device="cuda", generator=g)
    f2 = torch.randn(N2, D, device="cuda", generator=g)
    f1 = f1 / f1.norm(dim=1, keepdim=True)
    f2 = f2 / f2.norm(dim=1, keepdim=True)
    i12, s12, i21, s21 = W.ncc_argmax_both(f1, f2)
    r12, rs12 = W.ncc_argmax_rowscan(f1, f2)
    r21, rs21 = W.ncc_argmax_rowscan(f2, f1)
    assert torch.equal(i12, r12) and torch.equal(s12, rs12)
    assert torch.equal(i21, r21) and torch.equal(s21, rs21)


def test_mesh_evaluator_on_the_card_never_takes_the_plain_scan(
        cuda, monkeypatch):
    """MeshEvaluator on the card launches kernel N for each call and never
    reaches the plain scan; the empty inputs make no launch."""
    from limap_tpu_torch.base.lines import Segments
    from limap_tpu_torch.evaluation import MeshEvaluator
    from limap_tpu_torch.ops import mesh_distance as md
    from limap_tpu_torch.testing.evaluation import wall_mesh, wall_distance

    def refuse(*a, **k):
        raise AssertionError("the plain scan ran on the card")

    monkeypatch.setattr(md, "mesh_min_dist_plain", refuse)
    verts, faces = wall_mesh(cell=0.2, jitter=0.05)
    mesh = MeshEvaluator(verts, faces, device="cuda")
    rng = np.random.default_rng(5)
    s = np.stack([rng.uniform(-5, 5, 50), rng.uniform(-4, 4, 50),
                  10 + rng.normal(0, 0.3, 50)], 1)
    lines = torch.as_tensor(np.stack([s, s + rng.normal(0, 0.2, (50, 3))],
                                     1), dtype=torch.float32, device="cuda")
    seg = Segments(lines[:, 0], lines[:, 1])
    n0 = md.mesh_min_dist.launches
    d = mesh.ComputeDistsLine(seg, 100)
    mesh.ComputeInlierRatio(seg, 0.05, 100)
    mesh.ComputeDistPoint([0.0, 0.0, 10.5])
    torch.cuda.synchronize()
    assert md.mesh_min_dist.launches == n0 + 3
    q = (lines[:, :1] + torch.linspace(0, 1, 100, device="cuda")[None, :,
                                                                  None]
         * (lines[:, 1:] - lines[:, :1])).reshape(-1, 3)
    inside, dz = wall_distance(q.cpu().numpy())
    dd = d.reshape(-1).double().cpu().numpy()
    assert np.abs(dd[inside] - dz[inside]).max() <= 1e-5
    n1 = md.mesh_min_dist.launches
    assert md.mesh_min_dist(q[:0], mesh.tris).shape == (0,)
    assert torch.isinf(md.mesh_min_dist(q, mesh.tris[:0])).all()
    assert md.mesh_min_dist.launches == n1


def _hybrid_cases():
    from limap_tpu_torch.testing import hybrid_checks
    return [case for case, _, _ in hybrid_checks.cases()]


@pytest.mark.parametrize("case", _hybrid_cases())
def test_hybrid_ba_kernels_vs_plain(cuda, case):
    """Kernels O, P and Q against their plain versions on the seeded
    cases of testing/hybrid_checks.py (each kind, each option)."""
    from limap_tpu_torch.parallel.sharded_ba import HybridBAOptions
    from limap_tpu_torch.testing import hybrid_checks as HC
    i, (name, prob, okw) = next((i, c) for i, c in enumerate(HC.cases())
                                if c[0] == case)
    state, ld, pd, I, C = HC.seeded_problem(seed=10 + i, device="cuda",
                                            **prob)
    opts = HybridBAOptions(**okw)
    for kind, data in (("line", ld), ("point", pd)):
        res, _ = HC.check_terms(kind, state, data, opts, opts.damping, I, C,
                                opts.solver != "cg")
        assert res["ok"], (kind, res)
    assert HC.check_cost(state, ld, pd, opts)["ok"]


def test_hybrid_ba_step_runs_on_the_kernels(cuda):
    """One BA step on the card goes through O, P and Q, and never through
    their plain versions."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import (HybridBAOptions,
                                          make_hybrid_ba_cost,
                                          make_hybrid_ba_step)
    from limap_tpu_torch.testing import hybrid_checks as HC
    state, ld, pd, I, C = HC.seeded_problem(seed=3, device="cuda")

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for solver in ("dense", "cg"):
        opts = HybridBAOptions(solver=solver, optimize_focal=True)
        n0 = (O.hybrid_terms.launches, O.hybrid_apply.launches,
              O.hybrid_cost.launches)
        c0 = dict(O.hybrid_terms.counts, **O.hybrid_apply.counts)
        saved = (O.hybrid_terms_plain, O.hybrid_apply_plain,
                 O.hybrid_cost_plain)
        O.hybrid_terms_plain = O.hybrid_apply_plain = \
            O.hybrid_cost_plain = refuse
        try:
            new, cost = make_hybrid_ba_step(None, I, C, opts)(state, ld, pd)
            c1 = make_hybrid_ba_cost(None, opts)(new, ld, pd)
            c2 = make_hybrid_ba_cost(None, opts)(new, ld, pd)
        finally:
            (O.hybrid_terms_plain, O.hybrid_apply_plain,
             O.hybrid_cost_plain) = saved
        assert torch.equal(c1, c2) and torch.isfinite(c1)
        assert O.hybrid_terms.launches == n0[0] + 2
        assert O.hybrid_apply.launches > n0[1]
        assert O.hybrid_cost.launches == n0[2] + 2
        assert all(torch.isfinite(x).all() for x in new)
        c1 = dict(O.hybrid_terms.counts, **O.hybrid_apply.counts)
        moved = {k: c1[k] - c0.get(k, 0) for k in c1}
        for kind in ("line", "point"):
            assert moved[kind] == 1
            assert moved[f"{kind}, backsub"] == 1
            # CG's product takes both kinds in one launch
            assert moved.get(f"{kind}, apply", 0) == 0
        if solver == "dense":
            assert moved.get("line+point, apply", 0) == 0
        else:
            assert moved["line+point, apply"] > 0
        assert O.hybrid_apply.launches - n0[1] == sum(
            v for k, v in moved.items() if "," in k)


def test_hybrid_terms_with_its_index_and_the_yardstick(cuda):
    """O given the step's prebuilt index gives the bits of O that builds
    its own; the first design's stage 2 (the yardstick) holds to plain
    and counts its launches apart."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import HybridBAOptions
    from limap_tpu_torch.testing import hybrid_checks as HC
    state, ld, pd, I, C = HC.seeded_problem(seed=7, device="cuda")
    for opts in (HybridBAOptions(optimize_focal=True),
                 HybridBAOptions(solver="cg")):
        dense = opts.solver != "cg"
        lam = torch.tensor(opts.damping, device="cuda")
        for kind, data in (("line", ld), ("point", pd)):
            land = state.line_params if kind == "line" \
                else state.point_params
            args = (kind, land, state.pose_params, state.cam_fxfy,
                    *data[:3], tuple(data[3:-1]), data[-1], opts, lam, I, C,
                    dense)
            ix = O.build_index(data[2], data[1], data[-1], I, C,
                               opts.optimize_focal, dense)
            a = HC.weighted_only(O.hybrid_terms(*args, index=ix))
            b = HC.weighted_only(O.hybrid_terms(*args))
            for name in ("g", "diag0", "Hinv", "H_cl", "A", "g_red"):
                assert torch.equal(getattr(a, name), getattr(b, name)), name
            assert (a.Hp is None) == (not dense)
            if dense:
                assert torch.equal(a.Hp, b.Hp)
            n0, s0 = O.hybrid_terms.launches, O.hybrid_terms_scan.launches
            res, _ = HC.check_terms(kind, state, data, opts, opts.damping,
                                    I, C, dense, O.hybrid_terms_scan)
            assert res["ok"], (kind, res)
            assert O.hybrid_terms_scan.launches == s0 + 2
            assert O.hybrid_terms.launches == n0
            scan = O.hybrid_terms_scan(*args, index=ix)
            # without an index the yardstick builds the grouping alone, as
            # its path did on every call, and gives the same bits
            lone = O.hybrid_terms_scan(*args)
            assert lone.index.pair_s.numel() == 0
            given = O.hybrid_terms_scan(*args, index=O.grouping_index(
                data[2], data[1], data[-1], I, C, opts.optimize_focal,
                dense))
            for name in ("g", "diag0") + (("Hp",) if dense else ()):
                assert torch.equal(getattr(lone, name),
                                   getattr(scan, name)), name
                assert torch.equal(getattr(given, name),
                                   getattr(scan, name)), name
            if not dense:
                # a group's (s, s) pairs are one share: g and diag0 add up
                # as the first design's, bit for bit
                assert torch.equal(a.g, scan.g)
                assert torch.equal(a.diag0, scan.diag0)


@pytest.fixture(scope="module")
def hybrid_scan_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from limap_tpu_torch.testing import hybrid_checks as HC
    return dict(HC.check_all_scan("cuda"))


@pytest.mark.parametrize("case", _hybrid_cases())
def test_hybrid_apply_equals_its_first_design_bit_for_bit(
        hybrid_scan_results, case):
    """P's product and back-substitution on each kind, and the product of
    both kinds in one launch, are the first design's bits."""
    res = hybrid_scan_results[case]
    assert res["ok"], res


def test_hybrid_apply_both_is_one_launch(cuda):
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import HybridBAOptions
    from limap_tpu_torch.testing import hybrid_checks as HC
    state, ld, pd, I, C = HC.seeded_problem(seed=5, device="cuda")
    tl, tp = HC.kernel_terms(state, ld, pd, HybridBAOptions(solver="cg"), I,
                             C)
    v = torch.randn(tl.g.shape[0], device="cuda")
    n0, s0 = O.hybrid_apply.launches, O.hybrid_apply_scan.launches
    c0 = O.hybrid_apply.counts["line+point, apply"]
    O.hybrid_apply_both(tl, tp, v)
    assert O.hybrid_apply.launches == n0 + 1
    assert O.hybrid_apply.counts["line+point, apply"] == c0 + 1
    assert O.hybrid_apply_scan.launches == s0
    with pytest.raises(ValueError):
        O.hybrid_apply_both(tp, tl, v)


def test_hybrid_ba_kernels_count_only_launches(cuda):
    """O and P on a kind with no tracks launch nothing and count
    nothing."""
    from limap_tpu_torch.ops import hybrid_ba as O
    from limap_tpu_torch.parallel import HybridBAOptions
    from limap_tpu_torch.testing import hybrid_checks as HC
    state, ld, pd, I, C = HC.seeded_problem(seed=4, device="cuda")
    opts = HybridBAOptions()
    cut = tuple(x[:0] for x in pd)
    n0 = (O.hybrid_terms.launches, O.hybrid_apply.launches)
    t = O.hybrid_terms("point", state.point_params[:0], state.pose_params,
                       state.cam_fxfy, *cut[:3], (cut[3],), cut[4], opts,
                       torch.tensor(1e-3, device="cuda"), I, C, True)
    v = torch.ones(t.g.shape[0], device="cuda")
    assert torch.equal(O.hybrid_apply(t, v), torch.zeros_like(v))
    assert O.hybrid_apply(t, v, backsub=True).shape == (0, 3)
    assert (O.hybrid_terms.launches, O.hybrid_apply.launches) == n0


def test_hybrid_ba_over_one_nccl_rank_is_the_one_card_call(
        cuda, tmp_path, monkeypatch):
    """The step and the cost over make_mesh() of one NCCL rank issue
    their collectives and give the one-card call's numbers bit for bit
    (an all_reduce or all_gather of one rank copies)."""
    import torch.distributed as dist
    from limap_tpu_torch.parallel import (HybridBAOptions, distributed,
                                          make_hybrid_ba_cost,
                                          make_hybrid_ba_step, make_mesh)
    from limap_tpu_torch.parallel import mesh as M
    from limap_tpu_torch.testing import hybrid_checks as HC
    state, ld, pd, I, C = HC.seeded_problem(seed=3, device="cuda")
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    distributed.maybe_initialize(f"file://{tmp_path}/store", 1, 0)
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        for solver in ("dense", "cg"):
            opts = HybridBAOptions(solver=solver)
            a = b = state
            M.LOG.reset()
            for _ in range(3):
                a, ca = make_hybrid_ba_step(None, I, C, opts)(a, ld, pd)
                b, cb = make_hybrid_ba_step(mesh, I, C, opts)(b, ld, pd)
                assert torch.equal(ca, cb)
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert M.LOG.calls["all_reduce"] >= 3
            assert M.LOG.calls["all_gather"] == 3
            assert torch.equal(make_hybrid_ba_cost(None, opts)(a, ld, pd),
                               make_hybrid_ba_cost(mesh, opts)(b, ld, pd))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- R, S, T, U (item 14)
def _learned_cases():
    from limap_tpu_torch.testing import learned_checks as LC
    return ([("log_sinkhorn", f"{M}x{N}x{it}")
             for M, N, it, _ in LC.SINKHORN_CASES]
            + [("sample_descriptors", m) for m in ("clamp", "zero")]
            + [("sold2_candidates", c[0]) for c in LC.candidate_cases()]
            + [("sold2_refine_junctions", c[0]) for c in LC.refine_cases()])


@pytest.fixture(scope="module")
def learned_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from limap_tpu_torch.testing import learned_checks as LC
    return {(name, case): res for name, case, res in LC.check_all("cuda")}


@pytest.mark.parametrize("name,case", _learned_cases())
def test_learned_kernels_vs_plain(learned_results, name, case):
    res = learned_results[(name, case)]
    assert res["ok"], res


def _band_cases():
    from limap_tpu_torch.testing import learned_checks as LC
    return [c[0] for c in LC.SINKHORN_BAND_CASES]


@pytest.mark.parametrize("case", _band_cases())
def test_log_sinkhorn_bands_hold_to_plain_and_repeat(learned_results, case):
    """R's band design on each case: within the tolerance of plain, the
    same infinities, the same bits on a repeat; the first design held to
    plain on the same input."""
    res = next(r for (name, c), r in learned_results.items()
               if name == "log_sinkhorn bands" and c.startswith(case + " ("))
    assert res["ok"], res


def test_log_sinkhorn_plans_bands_in_shared_memory_and_global_past_it(cuda):
    from limap_tpu_torch.ops import log_sinkhorn as R
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pair = R.plan(556, 565)
    assert pair["ctas"] == sms and pair["v_in_shared_memory"]
    assert pair["rows_in_shared_memory"] == pair["rows_a_band"]
    assert R.plan(40, 30)["ctas"] == 41            # a CTA a row
    sg = R.plan(2048, 2048)
    assert sg["rows_in_shared_memory"] == sg["rows_a_band"]
    big = R.plan(4096, 4096)
    assert 0 < big["rows_in_shared_memory"] < big["rows_a_band"]
    assert R.plan(2000, 300, rows_cap=8)["rows_in_shared_memory"] == 8
    wide = R.plan(10, 40000)
    assert wide["v_in_shared_memory"]
    assert wide["rows_in_shared_memory"] == 0
    wider = R.plan(10, 70000)
    assert not wider["v_in_shared_memory"]
    assert wider["rows_in_shared_memory"] == 0
    from limap_tpu_torch.testing import learned_checks as LC
    s = torch.randn(10, 70000, device="cuda")
    err, tol, same = LC.compare_z(R.log_sinkhorn(s, 0.5, 5),
                                  R.log_sinkhorn_plain(s, 0.5, 5))
    assert err <= tol and same
    with pytest.raises(ValueError):
        R.launch_parts(torch.randn(30, 20, device="cuda"), 0.5, 10, 8)


def test_log_sinkhorn_scan_counts_apart(cuda):
    from limap_tpu_torch.ops import log_sinkhorn as R
    n0 = (R.log_sinkhorn.launches, R.log_sinkhorn_scan.launches)
    s = torch.randn(30, 20, device="cuda")
    z = R.log_sinkhorn(s, 0.5, 10)
    zs = R.log_sinkhorn_scan(s, 0.5, 10)
    R.launch(s, 0.5, 10)
    R.launch_parts(s, 0.5, 10, R.PART_SYNC)
    assert (R.log_sinkhorn.launches, R.log_sinkhorn_scan.launches) == (
        n0[0] + 1, n0[1] + 1)
    assert (z - zs).abs().max() <= 1e-4
    with pytest.raises(ValueError):
        R.log_sinkhorn_scan(s.cpu(), 0.5, 10)


def test_learned_kernels_count_launches_and_refuse_bad_inputs(cuda):
    from limap_tpu_torch.ops import log_sinkhorn as R
    from limap_tpu_torch.ops import sample_descriptors as S
    from limap_tpu_torch.ops import sold2_lines as TU
    n0 = (R.log_sinkhorn.launches, S.sample_descriptors.launches,
          TU.sold2_candidates.launches, TU.sold2_refine_junctions.launches)
    R.log_sinkhorn(torch.zeros(3, 4, device="cuda"), 0.5, 2)
    g = torch.zeros(4, 5, 8, device="cuda")
    S.sample_descriptors(g, torch.zeros(0, 2, device="cuda"), "clamp", 8)
    TU.sold2_refine_junctions(torch.zeros(0, 2, 2, dtype=torch.float64,
                                          device="cuda"),
                              torch.zeros(8, 8, dtype=torch.float64,
                                          device="cuda"))
    n1 = (R.log_sinkhorn.launches, S.sample_descriptors.launches,
          TU.sold2_candidates.launches, TU.sold2_refine_junctions.launches)
    assert n1 == (n0[0] + 1, n0[1], n0[2], n0[3])   # empty: no launch
    with pytest.raises(ValueError):
        R.log_sinkhorn(torch.zeros(3, 4, dtype=torch.float64,
                                   device="cuda"), 0.5)
    with pytest.raises(ValueError):
        S.sample_descriptors(g, torch.zeros(3, 2, dtype=torch.float64,
                                            device="cuda"), "clamp", 8)
    with pytest.raises(ValueError):
        S.sample_descriptors(torch.zeros(4, 5, 600, device="cuda"),
                             torch.zeros(3, 2, device="cuda"), "clamp", 8)
    with pytest.raises(ValueError):
        TU.sold2_candidates(torch.zeros(8, 8, device="cuda"),
                            torch.zeros(2, 2, dtype=torch.float64,
                                        device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"),
                            torch.ones(1, dtype=torch.int32, device="cuda"))


# ------------------------------------------------- V, W, X, Y (item 14)
def _zoo_cases():
    from limap_tpu_torch.testing import zoo_checks as ZC
    return ([("lbd_describe", c[0]) for c in ZC.lbd_cases()]
            + [("ncc_argmax", c[0]) for c in ZC.ncc_cases()]
            + [("tplsd_decode", c[0]) for c in ZC.decode_cases()]
            + [("l2d2_patches", c[0]) for c in ZC.patch_cases()])


@pytest.fixture(scope="module")
def zoo_results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from limap_tpu_torch.testing import zoo_checks as ZC
    return {(name, case): res for name, case, res in ZC.check_all("cuda")}


@pytest.mark.parametrize("name,case", _zoo_cases())
def test_zoo_kernels_vs_plain(zoo_results, name, case):
    res = zoo_results[(name, case)]
    assert res["ok"], res


def test_zoo_kernels_count_launches_and_refuse_bad_inputs(cuda):
    from limap_tpu_torch.ops import l2d2_patches as Y
    from limap_tpu_torch.ops import lbd_describe as V
    from limap_tpu_torch.ops import ncc_argmax as W
    from limap_tpu_torch.ops import tplsd_decode as X
    kernels = (V.lbd_describe, W.ncc_argmax_both, X.tplsd_decode,
               Y.l2d2_patches)
    n0 = tuple(k.launches for k in kernels)
    img = torch.rand(20, 30, device="cuda")
    V.lbd_describe(img, torch.zeros(0, 4, device="cuda"),
                   torch.zeros(0, dtype=torch.bool, device="cuda"))
    W.ncc_argmax_both(torch.ones(2, 8, device="cuda"),
                      torch.ones(3, 8, device="cuda"))
    X.tplsd_decode(img, torch.zeros(20, 30, 4, device="cuda"), 5)
    Y.l2d2_patches(img, torch.zeros(0, 6, device="cuda"),
                   torch.zeros(0, 4, dtype=torch.int32, device="cuda"))
    n1 = tuple(k.launches for k in kernels)
    # empty: no launch; W's one launch gives both directions
    assert n1 == (n0[0], n0[1] + 1, n0[2] + 1, n0[3])
    with pytest.raises(ValueError):
        W.ncc_argmax_both(torch.zeros(0, 8, device="cuda"),
                          torch.ones(3, 8, device="cuda"))
    with pytest.raises(ValueError):
        W.ncc_argmax_both(torch.zeros(3, 65, device="cuda"),
                          torch.zeros(3, 65, device="cuda"))
    with pytest.raises(ValueError):
        V.lbd_describe(img.double(), torch.zeros(1, 4, device="cuda"),
                       torch.ones(1, dtype=torch.bool, device="cuda"))


# ---- kernels I and B against their first designs (the yardsticks)
def _jointloc_cases():
    """Kernel I's seeded cases: (name, params0, data, cfg)."""
    for corners, configs in ((False, lm_checks.JOINTLOC_CONFIGS),
                             (True, lm_checks.JOINTLOC_CORNER_CONFIGS)):
        params0, data = lm_checks.seeded_jointloc(seed=2, corners=corners)
        for c in configs:
            yield (("corners, " if corners else "") + ", ".join(map(str, c)),
                   params0, data, lm_checks.loc_config(*c))


def _wide_jointloc(seed=3, n_lines=2000, n_points=12000, T=3):
    """Chains whose active matches do not fit in a block's shared memory
    (the kernel then reads them through their indices)."""
    from limap_tpu_torch.testing.localization import synthetic_problem
    rng = np.random.default_rng(seed)
    cam, pose_gt, p3, p2, l3, _, l2 = synthetic_problem(
        rng, n_points=n_points, n_lines=n_lines, outlier_ratio=0.1)
    params0 = torch.as_tensor(np.tile(np.concatenate(
        [pose_gt.qvec, pose_gt.tvec + 0.02]), (T, 1)), dtype=torch.float32,
        device="cuda")

    def f(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device="cuda")

    data = (f(l3[:, 0]), f(l3[:, 1]), f(l2[:, 0]), f(l2[:, 1]),
            f(rng.random((T, n_lines)) < 0.95, torch.bool), f(p3), f(p2),
            f(rng.random((T, n_points)) < 0.95, torch.bool), f(cam.kvec()))
    return params0, data


def test_jointloc_with_the_first_designs_team_is_its_first_design(cuda):
    """Kernel I with the first design's team (256 threads, match i on
    thread i mod 256) against lm_jointloc_scan, bit for bit: every trace
    row, the params, costs and accepts, on the seeded cases, on chains
    of phase 8's widths and on chains read through their indices; so the
    fused loop (one pass an iteration, the normal equations kept on a
    reject) changes no bit."""
    from limap_tpu_torch.ops import lm_jointloc as I
    from limap_tpu_torch.testing import loc_kernels
    failed = []
    for name, params0, data, cfg in _jointloc_cases():
        res = loc_kernels.jointloc_bits(params0, data, cfg)
        if not res["ok"]:
            failed.append((name, res))
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    for n in (32, 300):
        res = loc_kernels.jointloc_bits(*loc_kernels.lo_like(n), cfg)
        if not res["ok"]:
            failed.append((f"{n} active", res))
    params0, data = _wide_jointloc()
    assert not I.team_for(data[0].shape[0], data[5].shape[0])["staged"]
    res = loc_kernels.jointloc_bits(params0, data, cfg, 10)
    if not res["ok"]:
        failed.append(("through indices", res))
    assert not failed, failed


@pytest.mark.parametrize("warps,order", [(1, "balanced"), (1, "owner"),
                                         (2, "balanced"), (4, "balanced"),
                                         (8, "balanced"), (8, "owner")])
def test_jointloc_teams_hold_to_plain(cuda, warps, order):
    """Each team of kernel I against plain on the seeded cases, row by
    row, by check_jointloc's rules."""
    from limap_tpu_torch.ops import lm_jointloc as I
    o = I.OWNER if order == "owner" else I.BALANCED

    def solve(params0, *a, trace=False):
        res, tr, team = I.launch_parts(params0, a[:9], a[9], a[10],
                                       warps=warps, order=o, trace=True)
        assert team["warps"] == warps
        return res, tr

    failed = []
    for name, params0, data, cfg in _jointloc_cases():
        _, res = lm_checks.check_jointloc(params0, data, cfg, solve=solve)
        if not res["ok"]:
            failed.append((name, res))
    assert not failed, failed


def test_jointloc_through_indices_holds_to_plain(cuda):
    from limap_tpu_torch.ops import lm_jointloc as I
    params0, data = _wide_jointloc(T=2)
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    team = I.team_for(data[0].shape[0], data[5].shape[0])
    assert not team["staged"] and team["warps"] == I.MAX_WARPS
    res_ne, res = lm_checks.check_jointloc(params0, data, cfg, 10)
    assert res_ne["ok"] and res["ok"], (res_ne, res)


def test_jointloc_through_global_indices_holds_to_plain(cuda):
    """Chains of more active matches than a block's shared memory holds
    even as indices (~57,000): the indices go to a global scratch; the
    solve holds to plain row by row, and with the first design's team to
    the first design bit for bit."""
    from limap_tpu_torch.ops import lm_jointloc as I
    from limap_tpu_torch.testing import loc_kernels
    params0, data = _wide_jointloc(n_lines=8000, n_points=52000, T=2)
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    team = I.team_for(data[0].shape[0], data[5].shape[0])
    assert team["matches_in"] == "indices in global memory"
    res_ne, res = lm_checks.check_jointloc(params0, data, cfg, 10)
    assert res_ne["ok"] and res["ok"], (res_ne, res)
    bits = loc_kernels.jointloc_bits(params0, data, cfg, 10)
    assert bits["ok"], bits


def test_jointloc_chains_pick_their_teams_on_the_card(cuda):
    """Each chain's team as the kernel picked it equals chain_warps (the
    rule on the host), on chains of 9 to 1,164 active matches in one
    launch, and the solve holds to plain row by row."""
    from limap_tpu_torch.ops import lm_jointloc as I
    from limap_tpu_torch.testing import loc_kernels
    cfg = lm_checks.loc_config("2d_perpendicular_dist2", "none", "huber",
                               1.0, 1.0)
    parts = [loc_kernels.lo_like(n, T=2) for n in (9, 200, 400, 1164)]
    params0 = torch.cat([p for p, _ in parts])
    data = list(parts[0][1])
    data[4] = torch.cat([d[4] for _, d in parts])
    data[7] = torch.cat([d[7] for _, d in parts])
    data = tuple(data)
    res, _, team = I.launch_parts(params0, data, cfg, 10)
    torch.cuda.synchronize()
    assert team["chain_warps"].tolist() == I.chain_warps(data[4], data[7])
    assert sorted(set(team["chain_warps"].tolist())) == [1, 4, 8]
    _, held = lm_checks.check_jointloc(params0, data, cfg, 10)
    assert held["ok"], held


@pytest.mark.parametrize("n_roots", [3, 4, 8])
@pytest.mark.parametrize("seed,degenerate", kernel_checks.SEEDS)
def test_trace_roots_equals_its_first_design_bit_for_bit(cuda, seed,
                                                         degenerate,
                                                         n_roots):
    """Kernel B (a warp an instance, its trees in the planned phases and
    in the one-level plan) against trace_roots_scan: rotations and flags
    bit for bit, degenerate (rank-deficient) instances included."""
    from limap_tpu_torch.ops import trace_roots as B
    from limap_tpu_torch.ops.trace_roots import alpha_grid
    from limap_tpu_torch.testing import loc_kernels
    args = [torch.as_tensor(x, device="cuda") for x in
            kernel_checks.trace_roots_inputs(seed, degenerate=degenerate)]
    args.append(torch.as_tensor(alpha_grid(256), device="cuda"))
    res = loc_kernels.trace_roots_bits(args, 48, n_roots)
    assert res["ok"], res
    R1, ok1 = B.launch_parts(*args, 48, n_roots, [(1, 1, 48)])
    Rs, oks = B.trace_roots_scan(*args, 48, n_roots)
    assert torch.equal(R1.view(torch.int32), Rs.view(torch.int32))
    assert torch.equal(ok1, oks)


def test_first_designs_count_their_own_launches(cuda):
    from limap_tpu_torch.ops import lm_jointloc as I
    from limap_tpu_torch.ops import trace_roots as B
    from limap_tpu_torch.ops.trace_roots import alpha_grid
    params0, data = lm_checks.seeded_jointloc(T=3)
    cfg = lm_checks.loc_config(*lm_checks.JOINTLOC_CONFIGS[-1])
    n = (I.solve.launches, I.solve_scan.launches)
    I.solve_scan(params0, *data, cfg, num_iterations=3)
    I.launch_parts(params0, data, cfg, 3)
    I.prepared(params0, data, cfg, 3)[2]()
    assert (I.solve.launches, I.solve_scan.launches) == (n[0], n[1] + 1)
    args = [torch.as_tensor(x, device="cuda") for x in
            kernel_checks.trace_roots_inputs(0, B=64)]
    args.append(torch.as_tensor(alpha_grid(256), device="cuda"))
    n = (trace_roots.launches, B.trace_roots_scan.launches)
    B.trace_roots_scan(*args, 48, 4)
    B.launch_parts(*args, 48, 4)
    torch.cuda.synchronize()
    assert (trace_roots.launches, B.trace_roots_scan.launches) == \
        (n[0], n[1] + 1)
    with pytest.raises(ValueError):
        I.solve_scan(params0.cpu(), *(x.cpu() for x in data), cfg)
    with pytest.raises(ValueError):
        B.trace_roots_scan(*(x.cpu() for x in args), 48, 4)
