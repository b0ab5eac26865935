"""The port's TP-LSD and HAWPv3 against the JAX package on the CPU.

TP-LSD: the seeded weights, the forward at 64 x 64 (maps within 1e-4 of
their largest magnitude, JAX's convolutions at HIGHEST precision), the
decoding (kernel X's plain version) bit-equal to JAX's on JAX's maps,
with ties, and the input normalization within 2 grey levels of JAX's
OpenCV one (util/cv2_ops' uint8 resize and blur are within one level).

HAWPv3: the port pads the stem convolution 3 on each side, as upstream;
the JAX package pads (2, 3).  Its forward is held to a reference composed
from JAX's own pieces with the stem padded (3, 3) (maps within 1e-4), and
a second test shows that JAX's hawp_forward differs from that reference.
The decoding on JAX's maps: candidates within 2e-5 relative, junctions
and segments equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.line2d import hawpv3 as JH
from limap_tpu.line2d import tp_lsd as JT
from limap_tpu.line2d.sold2 import nets as ref_nets
from limap_tpu_torch import convert
from limap_tpu_torch.line2d import hawpv3 as PH
from limap_tpu_torch.line2d import tp_lsd as PT
from limap_tpu_torch.testing import zoo
from torch_threads import two_torch_threads  # noqa: F401

MAP_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    ref_nets.set_conv_precision(jax.lax.Precision.HIGHEST)
    yield
    ref_nets.set_conv_precision(None)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).random((1, 64, 64, 1)).astype(
        np.float32)


# ---------------------------------------------------------------- TP-LSD
@pytest.fixture(scope="module")
def tplsd_maps(image):
    p = JT.init_params(0)
    c, d = JT.tplsd_forward(p, jnp.asarray(image))
    return p, np.asarray(c), np.asarray(d)


def test_tplsd_weights_and_forward_match_jax(image, tplsd_maps):
    p, c, d = tplsd_maps
    sd = convert.tplsd_state_dict(p)
    for k, v in PT.init_params(0).items():
        assert torch.equal(v, sd[k]), k
    net = PT.load_torch_state_dict(sd)
    gc, gd = PT.tplsd_forward(net, torch.as_tensor(image))
    np.testing.assert_allclose(gc.numpy(), c, atol=MAP_RTOL * np.abs(c).max())
    np.testing.assert_allclose(gd.numpy(), d, atol=MAP_RTOL * np.abs(d).max())


@pytest.mark.parametrize("levels,max_segs", [(0, 64), (0, 400), (6, 50)])
def test_tplsd_decode_equals_jax(tplsd_maps, levels, max_segs):
    _, c, d = tplsd_maps
    c = c[0]
    if levels:      # equal scores everywhere: lax.top_k's tie order
        c = np.floor(c * levels) / levels
    rs, rn = JT.tplsd_decode(jnp.asarray(c), jnp.asarray(d[0]), max_segs)
    ps, pn = PT.tplsd_decode(torch.as_tensor(c), torch.as_tensor(d[0]),
                             max_segs)
    assert int(rn) == int(pn)
    assert np.array_equal(np.asarray(rs), ps.numpy())


def test_tplsd_preprocessing_within_two_grey_levels():
    from limap_tpu_torch.testing import pipeline
    rng = np.random.default_rng(2)
    scene = pipeline.build_scene(n_views=1, hw=(96, 128))[1][0]
    for img in (rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
                np.repeat(scene[..., None], 3, -1)):
        a, b = JT.preprocess_tplsd(img), PT.preprocess_tplsd(img)
        assert a.shape == b.shape == (96, 128, 3)
        assert np.abs(a - b).max() <= 2.0 / 255 + 1e-6


def test_tplsd_detector_end_to_end(image):
    """The detector's output is JAX's decoding of the port's maps (the
    maps themselves are held above: a peak is an equality with its
    window's maximum, which rounding decides on plateaus, so the two
    packages' maps are not decoded against each other)."""
    pd = PT.TPLSDDetector({"max_segs": 64, "device": "cpu"})
    img = image[0, ..., 0]
    center, disp = pd.maps(img)
    ref, n = JT.tplsd_decode(jnp.asarray(center.numpy()),
                             jnp.asarray(disp.numpy()), 64)
    got = pd.detect_array(img)
    assert got.shape == (int(n), 5) and len(got) > 10
    assert np.array_equal(got, np.asarray(ref)[:int(n)])


# ---------------------------------------------------------------- HAWPv3
def padded_reference(p, image):
    """JAX's hawp_forward, composed from its own pieces, with the stem
    convolution padded (3, 3) as upstream pads it."""
    P = "backbone"
    x = ref_nets.conv(p, f"{P}.conv1", image, stride=2,
                      padding=((3, 3), (3, 3)))
    x = ref_nets.relu(JH._bn(p, f"{P}.bn1", x))
    x = JH._bottleneck(p, f"{P}.layer1.0", x, True)
    x = JH._pool(x)
    x = JH._bottleneck(p, f"{P}.layer2.0", x, True)
    x = JH._bottleneck(p, f"{P}.layer3.0", x, False)
    for s in range(JH.NUM_STACKS):
        y = JH._hourglass(p, f"{P}.hg.{s}", JH.DEPTH, x)
        for b in range(JH.NUM_BLOCKS):
            y = JH._bottleneck(p, f"{P}.res.{s}.{b}", y, False)
        y = ref_nets.relu(JH._bn(p, f"{P}.fc.{s}.1", ref_nets.conv(
            p, f"{P}.fc.{s}.0", y, padding="VALID")))
        outs = [ref_nets.conv(p, f"{P}.score.{s}.heads.{m}.2",
                              ref_nets.relu(ref_nets.conv(
                                  p, f"{P}.score.{s}.heads.{m}.0", y)),
                              padding="VALID")
                for m in range(len(sum(JH.HEAD_SIZE, [])))]
        score = jnp.concatenate(outs, axis=-1)
        if s < JH.NUM_STACKS - 1:
            x = x + ref_nets.conv(p, f"{P}.fc_.{s}", y, padding="VALID") \
                + ref_nets.conv(p, f"{P}.score_.{s}", score, padding="VALID")
    return {"md": jax.nn.sigmoid(score[..., 0:3]),
            "dis": jax.nn.sigmoid(score[..., 3:4]),
            "res": jax.nn.sigmoid(score[..., 4:5]),
            "jloc": jax.nn.softmax(score[..., 5:7], axis=-1)[..., 1:2],
            "joff": jax.nn.sigmoid(score[..., 7:9]) - 0.5}


@pytest.fixture(scope="module")
def hawp(image):
    p = JH.init_params(0)
    ref = jax.device_get(padded_reference(p, jnp.asarray(image)))
    return p, ref


def test_hawpv3_forward_matches_the_padded_reference(image, hawp):
    p, ref = hawp
    sd = convert.hawpv3_state_dict(p)
    for k, v in PH.init_params(0).items():
        assert torch.equal(v, sd[k]), k
    net = PH.load_torch_state_dict(sd)
    got = PH.hawp_forward(net, torch.as_tensor(image))
    for k, a in ref.items():
        a = np.asarray(a)
        assert got[k].shape == a.shape == (1, 16, 16, a.shape[-1])
        np.testing.assert_allclose(got[k].numpy(), a,
                                   atol=MAP_RTOL * max(np.abs(a).max(), 1))


def test_jax_hawp_forward_pads_the_stem_otherwise(image, hawp):
    """The JAX package's SAME padding of the 7x7 stride-2 stem is (2, 3):
    its maps are not the padded reference's (ROADMAP.md section 3)."""
    p, ref = hawp
    jax_out = jax.device_get(JH.hawp_forward(p, jnp.asarray(image)))
    diff = max(float(np.abs(np.asarray(jax_out[k]) - np.asarray(ref[k]))
                     .max()) for k in ref)
    assert diff > 100 * MAP_RTOL


def test_hawpv3_forward_is_the_heads_of_its_scores(image):
    net = PH.load_torch_state_dict(PH.init_params(0))
    x = torch.as_tensor(image)
    with torch.no_grad():
        score = net.scores(x)
    assert score.shape == (1, 16, 16, 9)
    got, want = PH.hawp_forward(net, x), PH.heads(score)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_hawpv3_maps_check_allows_what_the_scores_move():
    """testing/zoo.py::hawp_maps_excess, the card-vs-CPU check of
    HAWPv3's maps: scores moved by at most e (some of them ~1e5) keep
    every map within what e allows (<= 1), and at scores of 0, where the
    sigmoids are steepest, a move of e takes almost all of it, so the
    allowance is not loose."""
    rng = np.random.default_rng(5)
    b = rng.normal(0, 3, (1, 8, 8, 9)).astype(np.float32)
    b[0, :2] *= 3e4
    e = 1e-2
    a = (b + rng.uniform(-e, e, b.shape)).astype(np.float32)
    assert zoo.hawp_maps_excess(torch.as_tensor(a), torch.as_tensor(b)) \
        <= 1.0
    b = np.zeros((1, 4, 4, 9), np.float32)
    a = b.copy()
    a[0, 1, 2, 0] = e
    excess = zoo.hawp_maps_excess(torch.as_tensor(a), torch.as_tensor(b))
    assert 0.9 < excess <= 1.0


def random_maps(seed=0, h=24, w=32):
    rng = np.random.default_rng(seed)
    return {"md": rng.random((h, w, 3)).astype(np.float32),
            "dis": rng.random((h, w, 1)).astype(np.float32),
            "res": rng.random((h, w, 1)).astype(np.float32) * 0.2,
            "jloc": (rng.random((h, w, 1)) ** 4).astype(np.float32),
            "joff": (rng.random((h, w, 2)) - 0.5).astype(np.float32)}


@pytest.mark.parametrize("seed,h,w", [(0, 24, 32), (1, 64, 80)])
def test_hawpv3_decoding_matches_jax(seed, h, w):
    m = random_maps(seed, h, w)
    t = {k: torch.as_tensor(v) for k, v in m.items()}
    cj = JH.hafm_decoding(m["md"], m["dis"], m["res"])
    cp = PH.hafm_decoding(t["md"], t["dis"], t["res"]).numpy()
    assert cp.shape == cj.shape
    # numpy's and torch's float32 cos, sin and tan differ by ulps, and tan
    # amplifies them near +-pi/2
    assert (np.abs(cj - cp) / np.maximum(np.abs(cj), 1)).max() <= 2e-5
    jj, sj = JH.decode_junctions(m["jloc"], m["joff"])
    jp, sp = PH.decode_junctions(t["jloc"], t["joff"])
    assert len(jj) == (300 if h == 64 else len(jj)) and len(jj) > 50
    assert np.array_equal(jj, jp.numpy()) and np.array_equal(sj, sp.numpy())
    cj = cj.reshape(-1, 4)
    ref = JH.match_lines_to_junctions(cj, jj, sj)
    got = PH.match_lines_to_junctions(torch.as_tensor(cj), jp, sp).numpy()
    assert len(ref) > 50
    assert np.array_equal(ref, got)


def test_hawpv3_snap_in_chunks_keeps_the_first_junction(monkeypatch):
    """Chunked snapping equals one pass; equidistant junctions give the
    first index, as numpy's argmin."""
    m = random_maps(3)
    cand = PH.hafm_decoding(*(torch.as_tensor(m[k])
                              for k in ("md", "dis", "res"))).reshape(-1, 4)
    juncs, js = PH.decode_junctions(torch.as_tensor(m["jloc"]),
                                    torch.as_tensor(m["joff"]))
    whole = PH.match_lines_to_junctions(cand, juncs, js)
    monkeypatch.setattr(PH, "SNAP_CHUNK", 97)
    assert torch.equal(PH.match_lines_to_junctions(cand, juncs, js), whole)
    pts = torch.tensor([[1.0, 1.0]])
    two = torch.tensor([[0.0, 1.0], [2.0, 1.0]])
    assert int(PH._nearest(pts, two)[1][0]) == 0
