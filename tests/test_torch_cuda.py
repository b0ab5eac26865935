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
    (the same correctly rounded fp32 operations in the same order), one
    launch counted."""
    from limap_tpu_torch.ops import mesh_distance as md
    _, p, t = mesh_cases()[case]
    pc = torch.as_tensor(p, device="cuda")
    tc = torch.as_tensor(t, device="cuda")
    n0 = md.mesh_min_dist.launches
    got = md.mesh_min_dist(pc, tc)
    ref = md.mesh_min_dist_plain(pc, tc)
    torch.cuda.synchronize()
    assert md.mesh_min_dist.launches == n0 + 1
    assert torch.equal(got, ref), float((got - ref).abs().max())


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
            if solver == "dense":
                assert moved.get(f"{kind}, apply", 0) == 0
            else:
                assert moved[f"{kind}, apply"] > 0
        assert O.hybrid_apply.launches - n0[1] == sum(
            v for k, v in moved.items() if "," in k)


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
    kernels = (V.lbd_describe, W.ncc_argmax, X.tplsd_decode, Y.l2d2_patches)
    n0 = tuple(k.launches for k in kernels)
    img = torch.rand(20, 30, device="cuda")
    V.lbd_describe(img, torch.zeros(0, 4, device="cuda"),
                   torch.zeros(0, dtype=torch.bool, device="cuda"))
    W.ncc_argmax(torch.zeros(0, 8, device="cuda"),
                 torch.ones(3, 8, device="cuda"))
    X.tplsd_decode(img, torch.zeros(20, 30, 4, device="cuda"), 5)
    Y.l2d2_patches(img, torch.zeros(0, 6, device="cuda"),
                   torch.zeros(0, 4, dtype=torch.int32, device="cuda"))
    n1 = tuple(k.launches for k in kernels)
    assert n1 == (n0[0], n0[1], n0[2] + 1, n0[3])   # empty: no launch
    with pytest.raises(ValueError):
        W.ncc_argmax(torch.zeros(3, 65, device="cuda"),
                     torch.zeros(3, 65, device="cuda"))
    with pytest.raises(ValueError):
        V.lbd_describe(img.double(), torch.zeros(1, 4, device="cuda"),
                       torch.ones(1, dtype=torch.bool, device="cuda"))
