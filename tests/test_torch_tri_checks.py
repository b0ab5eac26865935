"""The comparisons that hold the triangulator's kernels (F, tri_propose;
G, tri_score) to their plain versions (limap_tpu_torch/testing/
tri_checks.py), run on the CPU: they accept the plain version's own
output and differences that sit within rounding of a threshold, and
refuse faults."""

import dataclasses

import pytest
import torch

from limap_tpu_torch.ops import tri_propose, tri_score
from limap_tpu_torch.testing import tri_checks as tc
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def seeded():
    tri, matches = tc.seeded_inputs(device="cpu", n_views=4, n_lines=40)
    ids = tri.img_ids
    rows = [tri.id2idx[i] for i in ids]
    per_key, per_val, nbr_rows, K, Tc = tri._gather_edges(
        rows, [matches[i] for i in ids])
    words, meta, _ = tri._fill_group(per_key, per_val, nbr_rows, rows, 0,
                                     len(rows), K, Tc)
    args = (tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed,
            torch.as_tensor(words), torch.as_tensor(meta))
    return tri, matches, args


def test_comparisons_accept_plain():
    results = list(tc.check_all(device="cpu"))
    assert len(results) == 8
    for name, case, res in results:
        assert res["ok_to_plain"], (name, case, res)
        assert res.get("flips", 0) == 0 and res.get("score_flips", 0) == 0
    ex = [r for n, c, r in results if n == "tri_propose exhaustive"]
    assert ex[0]["survivors_max"] > 64 and ex[0]["lines_without"] > 0


def test_propose_comparison_refuses_faults(seeded):
    _, _, args = seeded
    tri, ok = tri_propose.propose_plain(*args)
    # an ok flipped far from every threshold
    n, t = [int(x) for x in torch.nonzero(ok)[0]]
    bad = ok.clone()
    bad[n, t] = False
    res = tc.compare_propose(*args, (tri, bad), (tri, ok))
    assert res["flips"] == 1 and not res["ok_to_plain"]
    # a row moved by 1 mm a metre of depth
    moved = tri.clone()
    moved[n, t, 0] += 1e-3 * moved[n, t, 6].abs().clamp(min=1)
    assert not tc.compare_propose(*args, (moved, ok), (tri, ok))[
        "ok_to_plain"]


def test_propose_comparison_accepts_a_flip_on_its_threshold(seeded):
    """With the angle threshold set to one candidate's own ray-plane
    angle (float64), flipping that candidate is within rounding."""
    _, _, args = seeded
    cfg, L, K, l2d, cam, words, meta = args
    tri, ok = tri_propose.propose_plain(*args)
    n, t = [int(x) for x in torch.nonzero(ok)[0]]
    row, a, ng_row, b, _, _ = tri_propose.decode_words(words, meta, L, K)
    l1, v1, l2, v2 = tc._rows(l2d, cam, row[n:n + 1], a[n:n + 1],
                              ng_row[n:n + 1, t], b[n:n + 1, t])
    from limap_tpu_torch.triangulation import functions as trifun
    n2 = trifun.get_normal_direction(l2, v2)
    c = torch.abs(torch.sum(n2 * v1.ray_direction(l1.start), -1))
    angle = float(90.0 - torch.rad2deg(torch.arccos(torch.clamp(c, 0, 1))))
    on = dataclasses.replace(cfg, line_tri_angle_threshold=angle)
    bad = ok.clone()
    bad[n, t] = False
    res = tc.compare_propose(on, *args[1:], (tri, bad), (tri, ok))
    assert res["flips"] == 1 and res["ok_to_plain"], res


def test_exhaustive_comparison_refuses_a_dropped_survivor(seeded):
    tri, matches, _ = seeded
    nbrs = [[tri.id2idx[n] for n in sorted(matches[i])] for i in tri.img_ids]
    K = len(nbrs[0])
    meta = tri._device(tri._meta(nbrs, [tri.id2idx[i] for i in tri.img_ids],
                                 K))
    args = (tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed, meta)
    counts = tri_propose.count_exhaustive_plain(*args)
    W = tri_propose.bucket_width(int(counts.max()))
    out = tri_propose.propose_exhaustive_plain(*args, W)
    assert tc.compare_exhaustive(*args, counts, counts, out, out)[
        "ok_to_plain"]
    words, rows, ok = (x.clone() for x in out)
    n = int(torch.argmax(counts))
    c = int(counts[n])
    words[n, :c - 1], rows[n, :c - 1] = words[n, 1:c].clone(), \
        rows[n, 1:c].clone()
    words[n, c - 1], ok[n, c - 1] = -1, False
    bad_counts = counts.clone()
    bad_counts[n] -= 1
    res = tc.compare_exhaustive(*args, bad_counts, counts, (words, rows, ok),
                                out)
    assert res["flips"] == 1 and not res["ok_to_plain"]


def _scored(args):
    tri, ok = tri_propose.propose_plain(*args)
    return tri, ok, tri_score.score_plain(*args, tri, ok, return_scores=True)


def test_score_comparison_refuses_faults(seeded):
    _, _, args = seeded
    tri, ok, out = _scored(args)
    floats, ints, scores = out
    assert tc.compare_score(*args, tri, ok, out, out)["ok_to_plain"]
    # a score off by a whole pair, with no pair of its line on a gate
    bad = scores.clone()
    n, i = [int(x) for x in torch.nonzero(ok & (scores > 0.7))[0]]
    bad[n, i] -= 0.6
    res = tc.compare_score(*args, tri, ok, (floats, ints, bad), out)
    assert res["score_flips"] == 1 and not res["ok_to_plain"], res
    # a packed edge dropped
    lines = torch.nonzero(ints.reshape(-1, ints.shape[-1])[:, -1] > 1)
    m = int(lines[0])
    bad_ints = ints.clone().reshape(-1, ints.shape[-1])
    bad_ints[m, 0] = bad_ints[m, 1]
    res = tc.compare_score(*args, tri, ok,
                           (floats, bad_ints.reshape(ints.shape), scores),
                           out)
    assert res["ints_differ_with_equal_sets"] == 1 and not res["ok_to_plain"]
    # another best proposal, far from a tie
    bad_f = floats.clone().reshape(-1, 10)
    bad_f[m, 0] += 1.0
    res = tc.compare_score(*args, tri, ok,
                           (bad_f.reshape(floats.shape), ints, scores), out)
    assert res["rows_unequal"] == 1 and not res["ok_to_plain"]


def test_score_comparison_accepts_a_pair_on_its_gate(seeded):
    """With the 2D overlap threshold set to one pair's own bioverlap
    (float64), a score that differs by that pair is within rounding."""
    _, _, args = seeded
    cfg, L, K = args[:3]
    tri, ok, out = _scored(args)
    floats, ints, scores = out
    n, i = [int(x) for x in torch.nonzero(ok & (scores > 0.7))[0]]
    _, _, ng_row, b, slot, _ = tri_propose.decode_words(args[5], args[6], L,
                                                        K)
    j = int(torch.nonzero(ok[n] & (slot[n] != slot[n, i]))[0])
    from limap_tpu_torch.base import line_dists as ld
    from limap_tpu_torch.base import line_geometry as lgeo
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.lines import Segments
    t = tri[n].double()
    cam = args[4].double()[ng_row[n, j]]
    proj = lgeo.project_segments(
        Segments(t[i, 0:3], t[i, 3:6]),
        CameraViewsBatch(cam[0:4], cam[4:8], cam[8:11]))
    seg = args[3].double().reshape(-1, 6)[ng_row[n, j] * L + b[n, j]]
    bio = float(ld.compute_bioverlap(proj, Segments(seg[0:2], seg[2:4])))
    on = dataclasses.replace(cfg, linker2d=dataclasses.replace(
        cfg.linker2d, th_overlap=bio))
    bad = scores.clone()
    bad[n, i] -= 0.6
    res = tc.compare_score(on, *args[1:], tri, ok, (floats, ints, bad), out)
    # within the score's tolerance, or a flip explained by its gate
    assert res["score_flips_unexplained"] == 0 and res["ok_to_plain"], res


def _bioverlap(args, tri, n, i, j, dtype):
    from limap_tpu_torch.base import line_dists as ld
    from limap_tpu_torch.base import line_geometry as lgeo
    from limap_tpu_torch.base.camera import CameraViewsBatch
    from limap_tpu_torch.base.lines import Segments
    L, K = args[1], args[2]
    _, _, ng_row, b, _, _ = tri_propose.decode_words(args[5], args[6], L, K)
    t = tri[n].to(dtype)
    cam = args[4].to(dtype)[ng_row[n, j]]
    proj = lgeo.project_segments(
        Segments(t[i, 0:3], t[i, 3:6]),
        CameraViewsBatch(cam[0:4], cam[4:8], cam[8:11]))
    seg = args[3].to(dtype).reshape(-1, 6)[ng_row[n, j] * L + b[n, j]]
    return float(ld.compute_bioverlap(proj, Segments(seg[0:2], seg[2:4])))


def test_score_tolerance_leaves_out_a_slot_flipped_at_a_gate(seeded):
    """With the 2D overlap threshold between one pair's float32 and
    float64 bioverlap, the pair passes its gates in one precision only:
    its slot's maximum differs by a whole pair score, the tolerance
    leaves that slot out, and a score off by it is explained by the
    pair's gate alone."""
    _, _, args = seeded
    cfg, L, K = args[:3]
    tri, ok, (_, _, scores) = _scored(args)
    _, _, ng_row, b, slot, _ = tri_propose.decode_words(args[5], args[6], L,
                                                        K)
    T = args[5].shape[-1]

    def flipped(n, i, j):
        """The config with the overlap threshold between the pair's two
        bioverlaps, and the jump of its slot's maximum (None if none)."""
        b32, b64 = (_bioverlap(args, tri, n, i, j, dt)
                    for dt in (torch.float32, torch.float64))
        if b32 == b64:
            return None, 0.0
        on = dataclasses.replace(cfg, linker2d=dataclasses.replace(
            cfg.linker2d, th_overlap=0.5 * (b32 + b64)))
        (p32, _), (p64, _) = [tri_score._score_chunk(
            on, K, T, args[3].to(dt), args[4].to(dt), ng_row[n:n + 1],
            b[n:n + 1], slot[n:n + 1], tri[n:n + 1].to(dt), ok[n:n + 1],
            per_slot_only=True) for dt in (torch.float32, torch.float64)]
        k = int(slot[n, j])
        return on, float(p64[0, i, k] - p32[0, i, k].double())

    pairs = ((n, i, j) for n, i in torch.nonzero(ok & (scores > 0.7)).tolist()
             for j in torch.nonzero(ok[n] & (slot[n] != slot[n, i]))[:, 0]
             .tolist())
    n, i, on, jump = next((n, i, on, jump) for n, i, j in pairs
                          for on, jump in [flipped(n, i, j)]
                          if abs(jump) > 0.5)
    tol = tc.score_tolerance(on, *args[1:], tri, ok)
    assert float(tol[n, i]) < 0.01
    out = tri_score.score_plain(on, *args[1:], tri, ok, return_scores=True)
    bad = out[2].clone()
    bad[n, i] += jump
    res = tc.compare_score(on, *args[1:], tri, ok, (out[0], out[1], bad),
                           out)
    assert res["score_flips"] == 1 and res["ok_to_plain"], res


def test_work_counts_are_nested(seeded):
    _, _, args = seeded
    tri, ok = tri_propose.propose_plain(*args)
    work = tc.words_work(*args, ok)
    # form (a) writes a row for every candidate, so triangulates each
    assert work["candidate"] == work["triangulated"] == work["row"]
    assert work["candidate"] >= work["angle"] >= work["valid"] \
        >= work["survivor"] > 0
    pairs = tc.score_work(args[0], args[1], args[2], args[5], args[6], tri,
                          ok)
    assert pairs["pair"] >= pairs["angle"] >= pairs["scaleinv"] > 0
    assert tc.operations(work, tc.ops_f(args[0])) > 0


def test_exhaustive_work_counts_each_line_once(seeded):
    """Form (b): the rays of a line are counted once a line, the
    epipolar lines once a (line, slot), however many candidates share
    them."""
    tri, matches, _ = seeded
    ids = tri.img_ids
    rows = [tri.id2idx[i] for i in ids]
    nbrs = [[tri.id2idx[n] for n in sorted(matches[i])] for i in ids]
    K = tri._slot_count(nbrs)
    meta = tri._device(tri._meta(nbrs, rows, K))
    args = (tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed, meta)
    counts = tri_propose.count_exhaustive_plain(*args)
    work = tc.exhaustive_work(*args, counts)
    valid = tri._l2d_packed[..., 4] > 0.5
    n_valid = int(valid[rows].sum())
    assert work["line"] == n_valid
    assert work["neighbour_line"] == int(
        valid[sorted({r for nb in nbrs for r in nb})].sum())
    assert work["line_slot"] <= n_valid * K
    assert work["candidate"] == sum(
        int(valid[r].sum()) * int(valid[nb].sum())
        for r, nb in zip(rows, nbrs))
    assert work["candidate"] >= work["angle"] >= work["triangulated"] \
        >= work["valid"] >= work["row"] == work["survivor"] == \
        int(counts.sum()) > 0
