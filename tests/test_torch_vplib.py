"""The port's VP detection (limap_tpu_torch/vplib, kernel J's plain
version in ops/vp_detect.py) against the JAX package's (limap_tpu/vplib)
on the CPU.

J's core fed the hypotheses JAX's ``jax.random`` draws: labels equal and
VP counts equal; VPs up to sign within 1e-5 plus twice the JAX
package's own error.  The port refits in float64; the JAX package's
float32 eigensolver errs by up to ~1e-3 on these ill-conditioned moment
matrices, so each VP is also held to the float64 refit of the same
inliers within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limap_tpu.vplib import JLinkage as RefJLinkage
from limap_tpu.vplib import JLinkageConfig as RefConfig
from limap_tpu.vplib import VPResult as RefResult
from limap_tpu.vplib import vptrack as ref_vptrack
from limap_tpu_torch.base.camera import Camera, CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.base.linetrack import LineTrack
from limap_tpu_torch.ops import vp_detect
from limap_tpu_torch.testing import vp_checks
from limap_tpu_torch.vplib import (GlobalVPTrackConstructor, JLinkage,
                                   JLinkageConfig, ProgressiveX,
                                   ProgressiveXConfig, VPResult, VPTrack,
                                   get_vp_detector,
                                   merge_vptracks_by_direction)
from limap_tpu_torch.vplib.jlinkage import segment_tensors

from test_vplib import segments_toward_vp
from torch_threads import two_torch_threads  # noqa: F401


def jax_hypotheses(key, n, n_hyp):
    """The line pairs JAX's detector draws from ``key``
    (limap_tpu/vplib/jlinkage.py:96-100)."""
    k1, k2 = jax.random.split(key)
    ia = jax.random.randint(k1, (n_hyp,), 0, n)
    ib = jax.random.randint(k2, (n_hyp,), 0, n)
    ib = jnp.where(ib == ia, (ib + 1) % n, ib)
    return (torch.as_tensor(np.array(ia), dtype=torch.int32),
            torch.as_tensor(np.array(ib), dtype=torch.int32))


def scene(rng, n_per=25, n_vps=3):
    vps = [np.array([2000.0, 240.0, 1.0]), np.array([320.0, -3000.0, 1.0]),
           np.array([1.0, 0.02, 0.0])][:n_vps]
    return np.concatenate([segments_toward_vp(rng, v, n_per) for v in vps]
                          + [segments_toward_vp(rng, np.array([1.0, .7, 0]),
                                                3, noise=20.0)])


@pytest.mark.parametrize("seed", range(4))
def test_core_fed_jax_hypotheses_equals_reference(seed):
    rng = np.random.default_rng(seed)
    segs = scene(rng)
    cfg = RefConfig(min_length=30, inlier_threshold=2.0, min_num_supports=10)
    ref = RefJLinkage(cfg, seed=seed).compute_vp_labels(segs)
    # the reference's key flow: one split for the detector, one for the
    # image, then the kernel's split
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    ia, ib = jax_hypotheses(sub, len(segs), cfg.n_hypotheses)
    t = segment_tensors(segs, cfg.min_length, "cpu")
    labels, vps, n_found = vp_detect.detect(
        *t, torch.tensor([0, len(segs)]), ia[None], ib[None],
        cfg.max_num_vps, cfg.min_num_supports, cfg.inlier_threshold)
    assert int(n_found[0]) == ref.count_vps() >= 2
    np.testing.assert_array_equal(labels.numpy(), ref.labels)
    coords = t[0].double()
    for k in range(ref.count_vps()):
        m = torch.as_tensor(ref.labels == k)
        _, vecs = torch.linalg.eigh(coords[m].T @ coords[m])
        f64 = vp_detect.sign_normalize(vecs[:, 0]).numpy()
        port = vps[0, k].double().numpy()
        jax_err = min(np.abs(ref.vps[k] - f64).max(),
                      np.abs(ref.vps[k] + f64).max())
        assert np.abs(port - f64).max() <= 1e-6
        assert min(np.abs(port - ref.vps[k]).max(),
                   np.abs(port + ref.vps[k]).max()) <= 1e-5 + 2 * jax_err


def test_jlinkage_two_vps(rng):
    vp1 = np.array([2000.0, 240.0, 1.0])
    vp2 = np.array([320.0, -3000.0, 1.0])
    segs = np.concatenate([
        segments_toward_vp(rng, vp1, 25), segments_toward_vp(rng, vp2, 25),
        segments_toward_vp(rng, np.array([1.0, 0.7, 0.0]), 3, noise=20.0)])
    det = JLinkage(JLinkageConfig(min_length=30, inlier_threshold=2.0,
                                  min_num_supports=10), device="cpu")
    res = det.compute_vp_labels(segs)
    assert res.count_vps() >= 2
    lab1, lab2 = res.labels[:25], res.labels[25:50]
    m1 = np.bincount(lab1[lab1 >= 0]).argmax()
    m2 = np.bincount(lab2[lab2 >= 0]).argmax()
    assert m1 != m2 and (lab1 == m1).mean() > 0.8 and (lab2 == m2).mean() > 0.8
    for true_vp, m in [(vp1, m1), (vp2, m2)]:
        v = res.GetVPbyCluster(m)
        t = true_vp / np.linalg.norm(true_vp)
        assert abs(abs(v / np.linalg.norm(v) @ t) - 1.0) < 1e-4


def test_jlinkage_too_few_lines(rng):
    segs = segments_toward_vp(rng, np.array([2000.0, 240, 1]), 4)
    res = JLinkage(device="cpu").compute_vp_labels(segs)
    assert res.count_vps() == 0 and (res.labels == -1).all()


def test_all_images_in_one_call_equal_one_by_one(rng):
    """detect_vp_all_images runs every image in one call of J; each
    image gives what the same hypotheses give it alone, and an image of
    too few lines gets no VP."""
    segs = {3: scene(rng), 5: scene(rng, 15, 2), 7: scene(rng)[:6],
            9: np.zeros((0, 4))}
    cfg = JLinkageConfig(min_length=30, inlier_threshold=2.0,
                         min_num_supports=8)
    det = JLinkage(cfg, seed=4, device="cpu")
    n0 = vp_detect.detect.launches
    res = det.detect_vp_all_images(segs)
    assert vp_detect.detect.launches == n0     # CPU: the plain version
    assert list(res) == [3, 5, 7, 9]
    assert res[7].count_vps() == 0 and len(res[7].labels) == 6
    assert res[9].count_vps() == 0 and len(res[9].labels) == 0
    gen = torch.Generator().manual_seed(4)
    from limap_tpu_torch.vplib.jlinkage import draw_hypotheses
    for img_id in (3, 5):
        ia, ib = draw_hypotheses(gen, len(segs[img_id]), cfg.n_hypotheses)
        t = segment_tensors(segs[img_id], cfg.min_length, "cpu")
        labels, vps, n = vp_detect.detect_image_plain(
            *t, ia, ib, cfg.max_num_vps, cfg.min_num_supports,
            cfg.inlier_threshold)
        np.testing.assert_array_equal(res[img_id].labels, labels.numpy())
        np.testing.assert_array_equal(res[img_id].vps, vps[:n].double())


def test_two_copies_of_a_line_make_no_hypothesis(rng):
    """Two copies of one line cross to an exactly zero vector; that
    "VP" would put every line through it, so the hypothesis is not ok
    (the JAX package's fused multiply-add leaves rounding noise there
    instead; ROADMAP.md section 3)."""
    segs = scene(rng, 20, 2)
    segs = np.concatenate([segs, segs[:1]])           # a copy of line 0
    t = segment_tensors(segs, 30.0, "cpu")
    n = len(segs)
    ia = torch.tensor([0, 0, 20], dtype=torch.int32)
    ib = torch.tensor([n - 1, 5, 27], dtype=torch.int32)
    hyp, ok = vp_detect.hypotheses(t[0], t[3], ia, ib)
    assert ok.tolist() == [False, True, True]
    assert float(hyp[0].abs().max()) == 0.0
    labels, vps, n_found = vp_detect.detect_image_plain(
        *t, ia, ib, 3, 5, 2.0)
    # the two pencils, not one "VP" that takes every line
    assert n_found == 2 and int(labels[0]) == int(labels[-1]) >= 0
    assert int(labels[20]) >= 0 and int(labels[20]) != int(labels[0])


def test_seeded_kernel_cases_compare_on_cpu():
    results = list(vp_checks.check_all(device="cpu"))
    assert len(results) == 4
    for case, res in results:
        assert res["ok"], (case, res)
    # the threshold case labels the lines exactly on it
    assert dict(results)["on the threshold and tied counts"]["labelled"] == 64


def test_comparison_refuses_faults():
    case, inputs, max_vps, min_sup, th = next(vp_checks.seeded_cases("cpu"))
    out = vp_detect.detect_plain(*inputs, max_vps, min_sup, th)
    assert vp_checks.compare_detect(out, out)["ok"]
    labels, vps, n = (x.clone() for x in out)
    labels[int((labels >= 0).nonzero()[0])] += 1
    assert not vp_checks.compare_detect((labels, vps, n), out)["ok"]
    labels, vps, n = (x.clone() for x in out)
    vps[0, 0, 0] += 1e-4
    assert not vp_checks.compare_detect((labels, vps, n), out)["ok"]


def test_merge_vptracks_by_direction():
    t1 = VPTrack([1.0, 0, 0], [(0, 0)])
    t2 = VPTrack([0.9999, 0.004, 0], [(1, 0)])
    t3 = VPTrack([0, 1.0, 0], [(2, 0)])
    out = merge_vptracks_by_direction([t1, t2, t3], th_angle_merge=1.0)
    ref = ref_vptrack.merge_vptracks_by_direction(
        [ref_vptrack.VPTrack(t.direction, t.supports) for t in (t1, t2, t3)],
        th_angle_merge=1.0)
    assert sorted(t.length() for t in out) == [1, 2]
    for a, b in zip(out, ref):
        assert a.supports == b.supports
        np.testing.assert_allclose(a.direction, b.direction, atol=1e-12)


def test_global_vptrack_constructor_equals_reference():
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cols = ImageCollection({0: Camera(K=K, hw=(480, 640), cam_id=0)},
                           {k: CameraImage(0, CameraPose(
                               tvec=(0.3 * k, 0.0, 0.0))) for k in range(6)})
    from limap_tpu.base.image_collection import ImageCollection as RefCols
    ref_cols = RefCols.from_dict(cols.as_dict())
    d = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    results = {k: VPResult(np.arange(8) % 2, (K @ d.T).T) for k in range(6)}
    tracks = [LineTrack(image_id_list=list(range(6)),
                        line_id_list=[j] * 6) for j in range(8)]
    port = GlobalVPTrackConstructor()
    port.Init(results)
    ref = ref_vptrack.GlobalVPTrackConstructor()
    ref.Init({k: RefResult(r.labels, r.vps) for k, r in results.items()})
    a = port.cluster_line_tracks(tracks, cols)
    b = ref.cluster_line_tracks(tracks, ref_cols)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert x.supports == y.supports
        np.testing.assert_allclose(x.direction, y.direction, atol=1e-12)


def test_progressivex_finds_vps(rng):
    vp1 = np.array([2000.0, 240.0])
    vp2 = np.array([320.0, -1500.0])
    segs = []
    for vp in (vp1, vp2):
        for _ in range(30):
            p0 = rng.random(2) * [640, 480]
            d = (vp - p0) / np.linalg.norm(vp - p0)
            segs.append(np.concatenate([p0, p0 + d * (30 + rng.random()
                                                       * 40)]))
    det = ProgressiveX(ProgressiveXConfig(min_length=10.0,
                                          inlier_threshold=2.0),
                       device="cpu")
    res = det.compute_vp_labels(np.asarray(segs))
    assert res.count_vps() >= 2
    first, second = res.labels[:30], res.labels[30:]
    first, second = first[first >= 0], second[second >= 0]
    assert len(first) > 20 and len(second) > 20
    assert np.bincount(first).max() > 0.9 * len(first)
    assert np.bincount(second).max() > 0.9 * len(second)


def test_get_vp_detector():
    assert isinstance(get_vp_detector({"method": "jlinkage",
                                       "min_length": 25}, device="cpu"),
                      JLinkage)
    assert get_vp_detector({"method": "jlinkage", "min_length": 25},
                           device="cpu").cfg.min_length == 25
    assert isinstance(get_vp_detector({"method": "progressive-x"},
                                      device="cpu"), ProgressiveX)
    with pytest.raises(NotImplementedError):
        get_vp_detector({"method": "lsd-vp"}, device="cpu")
