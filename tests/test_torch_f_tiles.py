"""The layout of kernel F's exhaustive passes (ops/tri_propose.py), on the
CPU: each (line, slot)'s survivor count, turned into offsets by
``slot_offsets`` as the wrapper does, puts every survivor of the plain
write (``propose_exhaustive_plain``) in its place, slot-major and then by
neighbour line, on seeded scenes with empty slots, a neighbour of -1 and
lines without survivors.  The kernels' bit-equality to the first design
is a card test (tests/test_torch_cuda.py).  Imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from limap_tpu_torch.ops import tri_propose
from limap_tpu_torch.testing import tri_checks as tc
from torch_threads import two_torch_threads  # noqa: F401


def _scene(case):
    """(triangulator, K, meta) of a seeded case; "holes" gives every
    image fewer neighbours than slots (K = 4, the rest -1) and the first
    image a -1 between two neighbours."""
    tri, matches = tc.seeded_inputs(device="cpu", n_views=5, n_lines=36,
                                    seed=3)
    if case == "endpoints":
        tri.cfg = dataclasses.replace(tri.cfg,
                                      use_endpoints_triangulation=True)
    ids = tri.img_ids
    rows = [tri.id2idx[i] for i in ids]
    nbrs = [[tri.id2idx[n] for n in sorted(matches[i])] for i in ids]
    if case == "holes":
        nbrs = [nb[:2 + (j % 3)] for j, nb in enumerate(nbrs)]
        K = 4
    else:
        K = tri._slot_count(nbrs)
    meta = torch.as_tensor(tri._meta(nbrs, rows, K))
    if case == "holes":
        meta[0, 1] = -1
    return tri, K, meta


CASES = ["0.3 px", "holes", "endpoints"]


@pytest.fixture(scope="module")
def layouts():
    out = {}
    for case in CASES:
        tri, K, meta = _scene(case)
        args = (tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed, meta,
                tri.ranges)
        slot_counts = tri_propose.count_exhaustive(*args, per_slot=True)
        counts = tri_propose.count_exhaustive_plain(*args)
        W = tri_propose.bucket_width(int(counts.max()))
        out[case] = (tri, K, meta, slot_counts, counts,
                     tri_propose.propose_exhaustive_plain(*args[:6], W,
                                                          tri.ranges))
    return out


@pytest.mark.parametrize("case", CASES)
def test_slot_counts_add_up_to_the_line_counts(layouts, case):
    tri, K, meta, slot_counts, counts, _ = layouts[case]
    assert slot_counts.shape == (meta.shape[0] * tri.L, K)
    assert slot_counts.dtype == torch.int32
    offsets, totals = tri_propose.slot_offsets(slot_counts)
    assert torch.equal(totals, counts)
    assert torch.equal(offsets[:, 0], torch.zeros_like(offsets[:, 0]))
    assert torch.equal(offsets[:, 1:], torch.cumsum(slot_counts, 1)[:, :-1]
                       .to(torch.int32))
    # a slot without a neighbour has no survivor
    empty = (meta[:, :K] < 0).repeat_interleave(tri.L, 0)
    assert not slot_counts[empty].any()
    if case == "holes":
        assert empty.any()


@pytest.mark.parametrize("case", CASES)
def test_offsets_put_every_plain_survivor_in_its_place(layouts, case):
    tri, K, meta, slot_counts, counts, (words, rows, ok) = layouts[case]
    offsets, totals = tri_propose.slot_offsets(slot_counts)
    N, W = words.shape
    pos = torch.arange(W)[None].expand(N, W)
    # each line's survivors fill its first totals[n] places, nothing after
    assert torch.equal(ok, pos < totals[:, None].long())
    assert torch.equal(words[~ok], torch.full_like(words[~ok], -1))
    assert not rows[~ok].any()
    slot = (words & 0x7F).long()
    b = (words >> 7).long()
    n_idx = torch.arange(N)[:, None].expand(N, W)
    # place = the slot's offset + the survivor's rank in its slot
    rank = pos - offsets[n_idx.clamp(max=N - 1), slot.clamp(max=K - 1)]
    assert (rank[ok] >= 0).all()
    assert (rank[ok] < slot_counts[n_idx, slot.clamp(max=K - 1)][ok]).all()
    # slot-major, then by neighbour line, without a repeat
    key = slot * (1 << 20) + b
    later = key[:, 1:] > key[:, :-1]
    assert later[ok[:, 1:]].all()
    # a neighbour of -1 never appears
    ng = meta[torch.arange(N)[:, None] // tri.L, slot.clamp(max=K - 1)]
    assert (ng[ok] >= 0).all()


def test_some_lines_have_no_survivor_and_some_many(layouts):
    _, _, _, _, counts, _ = layouts["0.3 px"]
    assert (counts == 0).any() and int(counts.max()) > 16


def test_offsets_of_no_slot():
    offsets, totals = tri_propose.slot_offsets(
        torch.zeros((3, 0), dtype=torch.int32))
    assert offsets.shape == (3, 0) and torch.equal(
        totals, torch.zeros(3, dtype=torch.int32))


def test_the_write_refuses_slot_counts_of_another_shape(layouts):
    tri, K, meta, slot_counts, counts, _ = layouts["0.3 px"]
    with pytest.raises(ValueError, match="slot_counts"):
        tri_propose.propose_exhaustive(
            tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed, meta,
            tri_propose.bucket_width(int(counts.max())), tri.ranges,
            slot_counts=slot_counts[:, :-1].contiguous())


def test_the_triangulator_gives_the_write_its_slot_counts(monkeypatch):
    """The exhaustive runner counts per slot once and hands each group's
    rows of those counts to the write, and the same tables to both
    passes (None on the CPU)."""
    tri, matches = tc.seeded_inputs(device="cpu", n_views=3, n_lines=20)
    seen, tables = [], []
    write = tri_propose.propose_exhaustive
    count = tri_propose.count_exhaustive

    def spy(*args, slot_counts=None, **kw):
        seen.append(slot_counts)
        tables.append(kw.get("tables", "absent"))
        return write(*args, slot_counts=slot_counts, **kw)

    def count_spy(*args, **kw):
        tables.append(kw.get("tables", "absent"))
        return count(*args, **kw)

    monkeypatch.setattr(tri_propose, "propose_exhaustive", spy)
    monkeypatch.setattr(tri_propose, "count_exhaustive", count_spy)
    tri.triangulate_all_exhaustive({i: sorted(m) for i, m in
                                    matches.items()})
    assert seen and all(s is not None for s in seen)
    assert sum(s.shape[0] for s in seen) == len(tri.img_ids) * tri.L
    assert len(tables) == len(seen) + 1 and all(t is None for t in tables)
    assert np.isfinite(tri.exhaustive_stats["survivors_total"])


def test_tables_are_the_card_s_alone_and_checked(layouts):
    """The table launch has no CPU form (the plain version reads no
    tables); tables for another line count are refused by both passes,
    on either device."""
    tri, K, meta, slot_counts, counts, _ = layouts["0.3 px"]
    assert tri_propose.exhaustive_tables(tri.L, tri._l2d_packed,
                                         tri._cam_packed) is None
    I = tri._cam_packed.shape[0]
    e = lambda *shape: torch.zeros(shape)
    wrong = tri_propose.ExhaustiveTables(tri.L + 1, e(I * (tri.L + 1), 12),
                                         e(I * (tri.L + 1), 12), e(I, 20))
    args = (tri.cfg, tri.L, K, tri._l2d_packed, tri._cam_packed, meta)
    with pytest.raises(ValueError, match="tables"):
        tri_propose.count_exhaustive(*args, tri.ranges, tables=wrong)
    with pytest.raises(ValueError, match="tables"):
        tri_propose.propose_exhaustive(
            *args, tri_propose.bucket_width(int(counts.max())), tri.ranges,
            slot_counts=slot_counts, tables=wrong)
    short = tri_propose.ExhaustiveTables(tri.L, e(I * tri.L, 12),
                                         e(I * tri.L, 11), e(I, 20))
    with pytest.raises(ValueError, match="rest"):
        tri_propose.count_exhaustive(*args, tri.ranges, tables=short)
