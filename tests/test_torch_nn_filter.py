"""The tensor-core filter of the port's nearest-neighbour kernel, as far
as the CPU reaches it: the operands the wrapper lays out
(prepare_cloud_operand, prepare_query_operand), the values the kernel's
mma instructions compute (filter_values_plain), the error bound E that
makes the filter safe, and a torch emulation of the kernel's whole
filter-then-confirm scan against the plain version, the JAX evaluator
and the Pallas kernel in interpret mode.  The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from limap_tpu.evaluation.evaluator import _min_dist_to_points
from limap_tpu.ops.pallas.nn_distance import min_dist_pallas
from limap_tpu_torch.ops import nn_distance as nnd

SCENES = ["1m", "10m", "100m", "1000m", "offcentre"]
SIZES = [(1, 5), (70, 300), (257, 1025), (513, 2049), (33, 4097)]


def scene(kind, S, M, seed=0):
    """Queries and cloud (numpy fp32) of extent ``kind``; every fourth
    query sits within 1e-3 of the extent from a cloud point."""
    rng = np.random.default_rng(seed)
    scale = 10.0 if kind == "offcentre" else float(kind[:-1])
    p = rng.uniform(-scale, scale, (M, 3))
    q = rng.uniform(-scale, scale, (S, 3))
    near = np.arange(0, S, 4)
    q[near] = p[rng.integers(0, M, near.size)] \
        + rng.normal(0, 1e-3 * scale, (near.size, 3))
    if kind == "offcentre":
        p += (1000.0, -500.0, 2000.0)
        q += (1000.0, -500.0, 2000.0)
    return q.astype(np.float32), p.astype(np.float32)


def operands(q, p):
    B, centre, p_max, delta = nnd.prepare_cloud_operand(torch.as_tensor(p))
    A, ss, err = nnd.prepare_query_operand(torch.as_tensor(q), centre, p_max)
    return A, ss, err, B, centre, p_max, delta


def tf32_scene(S, M, seed=0):
    """A cloud of TF32 values with a symmetric bounding box (the centring
    and the rounding leave it as it is, delta = 0), and queries that are
    cloud points."""
    rng = np.random.default_rng(seed)
    p = nnd.tf32_round(torch.as_tensor(
        rng.uniform(-10, 10, (M, 3)).astype(np.float32))).numpy()
    p = np.concatenate([p, [[-16, -16, -16], [16, 16, 16]]]).astype(np.float32)
    return p[rng.integers(0, M, S)].copy(), p


def low_bits(x):
    return x.contiguous().view(torch.int32) & 0x1fff


# ---- (a) the operands ----

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, 1e6])
def test_tf32_split(scale):
    x = torch.as_tensor((np.random.default_rng(0).normal(size=4096)
                         * scale).astype(np.float32))
    hi, lo = nnd.tf32_split(x)
    assert not low_bits(hi).any() and not low_bits(lo).any()
    # hi is the nearest of the values 2^-10 apart (relative), lo the rest
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -20 * x.abs().double()).all()
    assert (resid <= 2.0 ** -22 * x.abs().double()).all()


@pytest.mark.parametrize("M", [1, 5, 1023, 1024, 1025, 2049])
def test_cloud_operand_layout(M):
    _, p = scene("offcentre", 4, M, seed=M)
    B, centre, p_max, delta = nnd.prepare_cloud_operand(torch.as_tensor(p))
    M_pad = B.shape[0]
    assert B.shape == (M_pad, 8) and B.dtype == torch.float32
    assert M_pad % nnd.CLOUD_PAD == 0 and M <= M_pad < M + nnd.CLOUD_PAD
    assert not low_bits(B).any()
    np.testing.assert_allclose(centre.numpy(),
                               (p.min(0).astype(np.float64) + p.max(0)) / 2,
                               rtol=1e-6)
    pc = torch.as_tensor(p) - centre
    assert torch.equal(B[:M, 0:3], B[:M, 3:6])
    assert torch.equal(B[:M, 0:3], nnd.tf32_round(pc))
    moved = (B[:M, 0:3].double() - pc.double()).norm(dim=1)
    assert (moved <= 2.0 ** -11 * pc.double().norm(dim=1)).all()
    assert delta.shape == (1,) and delta.dtype == torch.float32
    assert float(moved.max()) <= float(delta) \
        <= max(float(moved.max()) * (1 + 2.0 ** -19), 2e-30)
    pp = B[:M, 0:3].double().square().sum(1)
    assert ((B[:M, 6].double() + B[:M, 7].double() - pp).abs()
            <= 2.0 ** -20 * pp).all()
    assert float(p_max) == pytest.approx(
        float(pc.double().norm(dim=1).max()))
    # pad rows: nothing but a norm no threshold reaches
    assert (B[M:, 6] > 0.99 * nnd.PAD_NORM).all()
    assert not B[M:, :6].any() and not B[M:, 7].any()


@pytest.mark.parametrize("S", [1, 70, 255, 256, 257])
def test_query_operand_layout(S):
    q, p = scene("offcentre", S, 64, seed=S)
    A, ss, err, _, centre, p_max, _ = operands(q, p)
    S_pad = A.shape[0]
    assert A.shape == (S_pad, 8) and ss.shape == err.shape == (S_pad,)
    assert S_pad % nnd.QUERY_PAD == 0 and S <= S_pad < S + nnd.QUERY_PAD
    assert not low_bits(A).any()
    sc = torch.as_tensor(q) - centre
    assert (A[:S, 6:8] == 1).all()
    s2 = -0.5 * (A[:S, 0:3].double() + A[:S, 3:6].double())
    assert ((s2 - sc.double()).abs() <= 2.0 ** -20 * sc.abs().double()).all()
    ss64 = sc.double().square().sum(1)
    np.testing.assert_allclose(ss[:S].double(), ss64, rtol=2.0 ** -23)
    np.testing.assert_allclose(
        err[:S].double(), nnd.ERROR_FACTOR * 2.0 ** -21
        * (ss64.sqrt() + p_max) ** 2, rtol=1e-6)
    assert not A[S:].any() and not ss[S:].any() and not err[S:].any()


# ---- (b) the filter values against float64 ----

def filter_error_units(q, p):
    """max over pairs of |e_fp32 - (||p~||^2 - 2 s'.p~)| in units of
    2^-21 (||s'|| + ||p~||)^2, and the same against E_row."""
    A, ss, err, B, centre, _, _ = operands(q, p)
    S, M = q.shape[0], p.shape[0]
    e = nnd.filter_values_plain(A, B)[:S, :M].double()
    sc = (torch.as_tensor(q) - centre).double()
    pc = B[:M, 0:3].double()
    truth = pc.square().sum(1)[None] - 2.0 * sc @ pc.T
    diff = (e - truth).abs()
    radius = (sc.norm(dim=1)[:, None] + pc.norm(dim=1)[None]) ** 2
    return (float((diff / (2.0 ** -21 * radius)).max()),
            float((diff / err[:S, None].double()).max()))


@pytest.mark.parametrize("kind", SCENES)
def test_filter_values_within_error_bound(kind):
    q, p = scene(kind, 300, 3000, seed=1)
    units, share = filter_error_units(q, p)
    # fp32 accumulation on the CPU rounds to nearest; the tensor cores
    # truncate, which the bound's derivation charges 2.25 of its 8 units:
    # what the CPU can measure has to fit into half of E
    assert units <= 1.0, units
    assert share <= 0.5, share


# ---- (c) the guarantee: the nearest point always passes the filter ----

def nearest_passes(q, p):
    A, ss, err, B, _, _, delta = operands(q, p)
    S, M = q.shape[0], p.shape[0]
    tq, tp = torch.as_tensor(q), torch.as_tensor(p)
    d2 = ((tq[:, None] - tp[None]) ** 2).sum(-1)          # the confirm's
    d2_min, j = d2.min(1)
    np.testing.assert_array_equal(
        torch.sqrt(d2_min), nnd.nn_min_dist_plain(tq, tp))
    e = nnd.filter_values_plain(A, B)[:S, :M]
    e_near = e[torch.arange(S), j].double() + ss[:S].double()
    # the threshold of a row that has confirmed the nearest point, with
    # half of E left to the tensor cores' truncating accumulation
    bound = nnd.filter_threshold(d2_min.double(), torch.zeros(S).double(),
                                 0.5 * err[:S].double(), delta.double())
    slack = bound - e_near
    assert (slack >= 0).all(), float(slack.min())
    # and every point as near as the nearest one passes as well
    ties = d2 <= d2_min[:, None]
    e_all = e.double() + ss[:S, None].double()
    bound = bound[:, None]
    assert (e_all[ties] <= bound.expand_as(e_all)[ties]).all()


# the same examples in every run, and no example database on disk
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       log_scale=st.floats(-1.0, 3.5),
       shift=st.sampled_from([0.0, 1.0, 100.0]),
       S=st.integers(1, 40), M=st.integers(1, 600),
       mode=st.sampled_from(["random", "zero", "duplicates", "near_ties",
                             "tf32"]))
def test_nearest_point_passes_filter(seed, log_scale, shift, S, M, mode):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** log_scale
    p = rng.uniform(-scale, scale, (M, 3)) + shift * scale
    q = rng.uniform(-scale, scale, (S, 3)) + shift * scale
    if mode != "random":
        q = p[rng.integers(0, M, S)].copy()          # d = 0
    if mode == "duplicates":
        p = np.concatenate([p, p[rng.integers(0, M, M)]])
    if mode == "near_ties":
        # clusters of points 1e-5 of the extent around each query
        p = np.concatenate(
            [p] + [q + rng.normal(0, 1e-5 * scale, q.shape)
                   for _ in range(4)])
    if mode == "tf32":
        q, p = tf32_scene(S, M, seed)
    nearest_passes(q.astype(np.float32), p.astype(np.float32))


# ---- (d) the whole scan, emulated ----

def filter_scan(q, p):
    """The kernel's scan in torch: tiles of 8 points in order, four lanes
    a query row that each judge two points of a tile against their own
    threshold, an exact confirm of what passes, the lanes' minima shared
    after every stage of CLOUD_PAD points.  Returns (distances, number of
    confirmed pairs)."""
    A, ss, err, B, _, _, delta = operands(q, p)
    S, M = q.shape[0], p.shape[0]
    tq, tp = torch.as_tensor(q), torch.as_tensor(p)
    inf = torch.tensor(float("inf"))
    e = nnd.filter_values_plain(A, B)[:S].reshape(S, -1, 4, 2)
    d2 = torch.full((S, B.shape[0]), float("inf"))
    d2[:, :M] = ((tq[:, None] - tp[None]) ** 2).sum(-1)
    real = (torch.arange(B.shape[0]) < M).reshape(-1, 4, 2)
    d2 = d2.reshape(S, -1, 4, 2)
    best = torch.full((S, 4), float("inf"))
    confirms = 0
    for tile in range(e.shape[1]):
        thr = nnd.filter_threshold(best, ss[:S, None], err[:S, None], delta)
        passed = (e[:, tile] < thr[:, :, None]) & real[tile]
        confirms += int(passed.sum())
        best = torch.minimum(best, torch.where(passed, d2[:, tile],
                                               inf).amin(-1))
        if (tile + 1) % (nnd.CLOUD_PAD // 8) == 0:
            best = best.amin(1, keepdim=True).expand(S, 4)
    return torch.sqrt(torch.clamp(best.amin(1), min=0.0)), confirms


@pytest.mark.parametrize("S,M", SIZES)
def test_filter_scan_vs_plain_and_jax(S, M):
    rng = np.random.default_rng(S + M)
    q = rng.normal(size=(S, 3)).astype(np.float32)
    p = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    d, confirms = filter_scan(q, p)
    plain = nnd.nn_min_dist_plain(torch.as_tensor(q), torch.as_tensor(p))
    # the confirm is the plain version's arithmetic on the same pairs
    np.testing.assert_allclose(d.numpy(), plain.numpy(), rtol=1e-6, atol=0)
    # the filter does filter: far fewer exact distances than pairs
    assert confirms <= max(0.2 * S * M, 64 * S)
    xla = np.asarray(_min_dist_to_points(jnp.asarray(q), jnp.asarray(p)))
    # same difference form, another summation order
    np.testing.assert_allclose(d.numpy(), xla, rtol=1e-5, atol=1e-6)
    pallas = np.asarray(min_dist_pallas(jnp.asarray(q), jnp.asarray(p), True))
    # the Pallas kernel's expanded form cancels near zero: the atol of
    # the reference's own test_pallas_nn.py
    np.testing.assert_allclose(d.numpy(), pallas, atol=1e-4)


@pytest.mark.parametrize("kind", SCENES + ["zero", "clusters", "tf32"])
def test_filter_scan_adversarial(kind):
    if kind == "zero":          # the cloud holds the queries, twice
        q, p = scene("10m", 64, 700, seed=2)
        p = np.concatenate([p, q, q, p[:50]])
    elif kind == "clusters":    # 1e-4 m clusters around each query
        q, p = scene("10m", 64, 700, seed=3)
        rng = np.random.default_rng(4)
        p = np.concatenate([p] + [
            (q + rng.normal(0, 1e-4, q.shape)).astype(np.float32)
            for _ in range(6)])
    elif kind == "tf32":        # delta = 0, d = 0
        q, p = tf32_scene(64, 1500, seed=6)
    else:
        q, p = scene(kind, 64, 1500, seed=5)
    d, _ = filter_scan(q, p)
    plain = nnd.nn_min_dist_plain(torch.as_tensor(q), torch.as_tensor(p))
    np.testing.assert_array_equal(d.numpy(), plain.numpy())


def test_too_small_an_error_bound_is_caught(monkeypatch):
    """With E cut to a thousandth the scan misses nearest points: the
    checks above can tell a safe bound from an unsafe one."""
    monkeypatch.setattr(nnd, "ERROR_FACTOR", nnd.ERROR_FACTOR * 1e-3)
    q, p = tf32_scene(64, 1500, seed=5)
    with pytest.raises(AssertionError):
        nearest_passes(q, p)


def test_kernel_entries_refuse_cpu_tensors():
    q, p = torch.zeros((8, 3)), torch.zeros((5, 3))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nnd.nn_min_dist_scalar(q, p)
    A, _, _, B, _, _, _ = operands(q.numpy(), p.numpy())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nnd.filter_tile_values(A, B)


def test_fragment_order_is_the_lanes_view():
    """Word w of lane 4 g + t in the group of two 8-point tiles is word
    t (w even) or t + 4 (w odd) of point g of tile w // 2."""
    B = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    F = nnd.fragment_order(B).reshape(4, 32, 4)
    assert F.is_contiguous() and sorted(F.flatten().tolist()) \
        == B.flatten().tolist()
    for pair, lane, w in [(0, 0, 0), (0, 5, 1), (1, 31, 2), (3, 18, 3)]:
        g, t = lane >> 2, lane & 3
        point = pair * 16 + (w // 2) * 8 + g
        assert F[pair, lane, w] == B[point, t + 4 * (w % 2)]
