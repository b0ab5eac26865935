"""3D line-map visualization: backend-agnostic geometry builders +
optional Open3D / PyVista adapters.

All geometry assembly (line sets with per-track colors / widths, camera
frusta, range culling) is pure NumPy and testable without a GUI stack;
the Open3D / PyVista glue are thin adapters that import their backend
lazily.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from limap_tpu_torch.visualize.vis_utils import (test_line_inside_ranges,
                                                 test_point_inside_ranges)


def _as_line_array(line) -> np.ndarray:
    """LineTrack.line / Segments row / raw [2, 3] -> [2, 3]."""
    if hasattr(line, "as_array"):
        return np.asarray(line.as_array())
    return np.asarray(line, np.float64).reshape(2, 3)


def track_colors(n: int, seed: int = 0) -> np.ndarray:
    """n visually distinct RGB colors in [0, 1] (golden-angle hue walk
    — the per-track coloring of the viewers)."""
    h = (np.arange(n) * 0.61803398875 + seed * 0.1) % 1.0
    s = np.full(n, 0.85)
    v = np.full(n, 0.95)
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    table = np.stack([
        np.stack([v, t, p], 1), np.stack([q, v, p], 1),
        np.stack([p, v, t], 1), np.stack([p, q, v], 1),
        np.stack([t, p, v], 1), np.stack([v, p, q], 1)], 0)
    return table[i % 6, np.arange(n)]


def build_line_set(lines, colors=None, ranges=None, scale: float = 1.0):
    """Cull + pack lines into (points [2M, 3], segments [M, 2] int,
    colors [M, 3]) — the layout every 3D backend consumes
    (:func:`open3d_get_line_set`)."""
    pts, seg, cols, kept = [], [], [], []
    if colors is None:
        colors = np.zeros((len(lines), 3))
    colors = np.asarray(colors, np.float64)
    if colors.ndim == 1:
        colors = np.tile(colors[None], (len(lines), 1))
    c = 0
    for i, line in enumerate(lines):
        arr = _as_line_array(line)
        if ranges is not None and not test_line_inside_ranges(arr, ranges):
            continue
        pts.append(arr[0] * scale)
        pts.append(arr[1] * scale)
        seg.append([2 * c, 2 * c + 1])
        cols.append(colors[i])
        kept.append(i)
        c += 1
    if not pts:
        return (np.zeros((0, 3)), np.zeros((0, 2), np.int32),
                np.zeros((0, 3)), [])
    return (np.stack(pts), np.asarray(seg, np.int32), np.stack(cols),
            kept)


def camera_frustum_lines(K: np.ndarray, hw, R: np.ndarray,
                         tvec: np.ndarray,
                         scale: float = 1.0) -> np.ndarray:
    """Frustum wireframe of one camera as [8, 2, 3] world-space
    segments (apex->corners + image-plane rectangle); the geometry of
    o3d's create_camera_visualization, computed here so it is testable
    and backend-free."""
    h, w = hw
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    corners_px = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]],
                          np.float64)
    corners_cam = (Kinv @ corners_px.T).T * scale
    C = -np.asarray(R).T @ np.asarray(tvec)
    corners_w = (np.asarray(R).T @ corners_cam.T).T + C
    segs = []
    for k in range(4):
        segs.append([C, corners_w[k]])
        segs.append([corners_w[k], corners_w[(k + 1) % 4]])
    return np.asarray(segs)


def build_camera_set(imagecols, ranges=None, scale: float = 1.0,
                     scale_cam_geometry: float = 1.0) -> np.ndarray:
    """All camera frusta of an ImageCollection as [N*8, 2, 3] segments
    (:func:`open3d_get_cameras`)."""
    segs = []
    for img_id in imagecols.get_img_ids():
        image = imagecols.images[img_id]
        cam = imagecols.cameras[image.cam_id]
        center = image.pose.center()
        if ranges is not None and not test_point_inside_ranges(
                center * scale, ranges):
            continue
        segs.append(camera_frustum_lines(
            cam.K(), (cam.h(), cam.w()), image.pose.R(),
            image.pose.tvec * scale,
            scale=0.005 * scale_cam_geometry * scale))
    return (np.concatenate(segs) if segs
            else np.zeros((0, 2, 3)))


# ------------------------------------------------------------- open3d
def open3d_get_line_set(lines, color=None, ranges=None,
                        scale: float = 1.0, colors=None):
    import open3d as o3d

    if colors is None:
        colors = color if color is not None else [0.0, 0.0, 0.0]
    pts, seg, cols, _ = build_line_set(lines, colors, ranges, scale)
    ls = o3d.geometry.LineSet()
    ls.points = o3d.utility.Vector3dVector(pts)
    ls.lines = o3d.utility.Vector2iVector(seg)
    ls.colors = o3d.utility.Vector3dVector(cols)
    return ls


def open3d_get_points(points, color=None, ranges=None,
                      scale: float = 1.0):
    import open3d as o3d

    color = color if color is not None else [0.0, 0.0, 0.0]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if ranges is not None and len(points):
        keep = np.array([test_point_inside_ranges(p, ranges)
                         for p in points])
        points = points[keep]
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(points * scale)
    pcd.colors = o3d.utility.Vector3dVector(
        np.tile(np.asarray(color, np.float64)[None], (len(points), 1)))
    return pcd


def open3d_get_cameras(imagecols, color=None, ranges=None,
                       scale_cam_geometry: float = 1.0,
                       scale: float = 1.0):
    import open3d as o3d

    color = color if color is not None else [1.0, 0.0, 0.0]
    segs = build_camera_set(imagecols, ranges, scale, scale_cam_geometry)
    ls = o3d.geometry.LineSet()
    ls.points = o3d.utility.Vector3dVector(segs.reshape(-1, 3))
    ls.lines = o3d.utility.Vector2iVector(
        np.arange(len(segs) * 2, dtype=np.int32).reshape(-1, 2))
    ls.colors = o3d.utility.Vector3dVector(
        np.tile(np.asarray(color, np.float64)[None], (len(segs), 1)))
    return ls


def open3d_vis_3d_lines(lines, ranges=None, scale: float = 1.0,
                        colors=None, width: int = 2):
    """Interactive Open3D viewer."""
    import open3d as o3d

    vis = o3d.visualization.Visualizer()
    vis.create_window(height=1080, width=1920)
    vis.add_geometry(open3d_get_line_set(lines, ranges=ranges,
                                         scale=scale, colors=colors))
    vis.run()
    vis.destroy_window()


# ------------------------------------------------------------ pyvista
def pyvista_vis_3d_lines(lines, img_hw=(600, 800), width: int = 2,
                         ranges=None, scale: float = 1.0, colors=None,
                         show: bool = True):
    """PyVista viewer, with optional per-line
    colors.  Returns the plotter for composition/testing."""
    import pyvista as pv

    plotter = pv.Plotter(window_size=[img_hw[1], img_hw[0]])
    pts, seg, cols, _ = build_line_set(
        lines, colors if colors is not None else [1.0, 0.0, 0.0],
        ranges, scale)
    for k in range(len(seg)):
        plotter.add_lines(pts[seg[k]], color=tuple(cols[k]),
                          width=width)
    if show:
        plotter.show()
    return plotter
