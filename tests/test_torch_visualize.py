"""The port's visualization against the JAX package's (the counterpart of
tests/test_visualize.py): the backend-free geometry builders return the
same arrays (exactly: both are the same float64 numpy arithmetic), the
range helpers the same selections, the track visualizer the same report,
the bipartite OBJ export the same file, and the matplotlib plots draw.
open3d and pyvista are imported only inside the viewers."""

import matplotlib
from torch_threads import two_torch_threads  # noqa: F401

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import limap_tpu.visualize as jvis  # noqa: E402
import limap_tpu.visualize.vis_bipartite as jbip  # noqa: E402
from limap_tpu.base.camera import Camera as JCamera  # noqa: E402
from limap_tpu.base.camera import CameraPose as JPose  # noqa: E402
from limap_tpu.base.image_collection import CameraImage as JImage  # noqa
from limap_tpu.base.image_collection import \
    ImageCollection as JCollection  # noqa: E402
from limap_tpu.base.linetrack import LineTrack as JTrack  # noqa: E402
import limap_tpu_torch.visualize as pvis  # noqa: E402
import limap_tpu_torch.visualize.vis_bipartite as pbip  # noqa: E402
from limap_tpu_torch.base.camera import Camera, CameraPose  # noqa: E402
from limap_tpu_torch.base.image_collection import (  # noqa: E402
    CameraImage, ImageCollection)
from limap_tpu_torch.base.linetrack import LineTrack  # noqa: E402


def _tracks(cls, n=6):
    out = []
    for i in range(n):
        k = 2 + i
        out.append(cls(line=np.array([[i, 0.0, 5.0], [i, 1.0, 5.0]]),
                       image_id_list=list(range(k)), line_id_list=[i] * k,
                       line2d_list=[np.zeros((2, 2))] * k))
    return out


def _collection(cam, pose, image, col):
    K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    rng = np.random.default_rng(0)
    imgs = {k: image(0, pose(R=np.eye(3), tvec=np.array([k, 0.0, 0])
                             + rng.normal(0, 0.1, 3))) for k in range(4)}
    return col({0: cam(K=K, hw=(100, 120), cam_id=0)}, imgs)


def test_exports_the_jax_names():
    assert sorted(pvis.__all__) == sorted(jvis.__all__)
    assert all(hasattr(pvis, n) for n in pvis.__all__)


def test_geometry_builders_return_the_same_arrays():
    rng = np.random.default_rng(1)
    lines = list(rng.normal(size=(9, 2, 3)) * 3)
    ranges = (np.array([-4, -4, -4.0]), np.array([4, 4, 4.0]))
    for kw in ({}, {"ranges": ranges, "scale": 2.0},
               {"colors": pvis.track_colors(9)}):
        a = jvis.build_line_set(lines, **kw)
        b = pvis.build_line_set(lines, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(jvis.track_colors(32, 3),
                                  pvis.track_colors(32, 3))
    K = np.array([[80.0, 0, 40], [0, 90.0, 30], [0, 0, 1]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    np.testing.assert_array_equal(
        jvis.camera_frustum_lines(K, (60, 80), R, [1.0, 2, 3], 0.5),
        pvis.camera_frustum_lines(K, (60, 80), R, [1.0, 2, 3], 0.5))
    jc = _collection(JCamera, JPose, JImage, JCollection)
    pc = _collection(Camera, CameraPose, CameraImage, ImageCollection)
    box = (np.array([-0.5, -1, -1.0]), np.array([1.5, 1, 1.0]))
    for kw in ({}, {"ranges": box}, {"scale": 2.0,
                                     "scale_cam_geometry": 3.0}):
        a, b = jvis.build_camera_set(jc, **kw), pvis.build_camera_set(pc,
                                                                      **kw)
        assert a.shape[0] > 0
        np.testing.assert_allclose(a, b, atol=1e-6)   # float32 rotations


def test_ranges_and_filters():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)) * [1, 2, 3]
    lines = rng.normal(size=(40, 2, 3))
    np.testing.assert_array_equal(
        jvis.compute_robust_range_points(pts, (0.1, 0.9), 1.5),
        pvis.compute_robust_range_points(pts, (0.1, 0.9), 1.5))
    np.testing.assert_array_equal(jvis.compute_robust_range_lines(lines),
                                  pvis.compute_robust_range_lines(lines))
    ranges = pvis.compute_robust_range_lines(lines, (0.2, 0.8), 1.0)
    counts = np.arange(40)
    for x, y in zip(jvis.filter_ranges(lines, counts, ranges),
                    pvis.filter_ranges(lines, counts, ranges)):
        np.testing.assert_array_equal(x, y)
    assert [jvis.test_line_inside_ranges(x, ranges) for x in lines] \
        == [pvis.test_line_inside_ranges(x, ranges) for x in lines]
    assert [jvis.test_point_inside_ranges(x, ranges) for x in pts] \
        == [pvis.test_point_inside_ranges(x, ranges) for x in pts]


def test_trackvis_report_and_selections(capsys):
    jv = jvis.BaseTrackVisualizer(_tracks(JTrack))
    pv = pvis.BaseTrackVisualizer(_tracks(LineTrack))
    js, ps = jv.report(), pv.report()
    out = capsys.readouterr().out
    assert js == ps and out.count("[Track Report]") == 2
    ranges = (np.array([-1, -1, 0.0]), np.array([2.5, 2, 10.0]))
    for call in (lambda v: v.get_lines_np(4), lambda v: v.get_counts_np(),
                 lambda v: v.get_lines_for_images([6])[0],
                 lambda v: v.get_lines_within_ranges(ranges)[0]):
        np.testing.assert_array_equal(np.asarray(call(jv)),
                                      np.asarray(call(pv)))
    assert isinstance(pvis.get_track_visualizer(_tracks(LineTrack)),
                      pvis.BaseTrackVisualizer)
    with pytest.raises(ImportError):
        pvis.get_track_visualizer(_tracks(LineTrack), backend="open3d")


class _Bipartite:
    """The 3D bipartite surface the OBJ export reads."""

    def __init__(self, rng):
        self.lines = {k: rng.normal(size=(2, 3)) for k in (0, 3, 5)}
        self.points = {k: rng.normal(size=3) for k in range(4)}

    def get_line_ids(self):
        return list(self.lines)

    def line(self, i):
        return self.lines[i]

    def get_point_ids(self):
        return list(self.points)

    def point(self, i):
        return self.points[i]

    def neighbor_lines(self, i):
        return [0, 5] if i % 2 else [3]


@pytest.mark.parametrize("max_edges", [None, 3])
def test_bipartite_obj_is_the_same_file(tmp_path, max_edges):
    bpt = _Bipartite(np.random.default_rng(3))
    jbip.save_bipartite3d_obj(str(tmp_path / "j.obj"), bpt, max_edges)
    pbip.save_bipartite3d_obj(str(tmp_path / "p.obj"), bpt, max_edges)
    assert (tmp_path / "p.obj").read_text() \
        == (tmp_path / "j.obj").read_text()


def test_matplotlib_match_plots(tmp_path):
    import matplotlib.pyplot as plt

    imgs = [np.zeros((40, 60), np.uint8), np.zeros((40, 60), np.uint8)]
    fig = pvis.plot_images(imgs, titles=["a", "b"])
    kpts = np.array([[5.0, 5], [20, 20]])
    pvis.plot_matches(kpts, kpts + 2)
    lines = [np.array([[[5.0, 5], [20, 20]], [[10.0, 30], [40, 8]]])] * 2
    pvis.plot_lines(lines)
    pvis.plot_color_line_matches(lines, correct_matches=[True, False])
    pvis.plot_color_lines(lines, [np.array([0])] * 2, [np.array([1])] * 2)
    pvis.save_plot(str(tmp_path / "m.png"))
    assert (tmp_path / "m.png").stat().st_size > 0
    plt.close(fig)
