"""Point-line bipartite visualization (2D overlays + 3D export).

The interactive open3d views degrade gracefully to OBJ/PLY export when
open3d is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from limap_tpu_torch.visualize.vis_utils import draw_points, draw_segments


def draw_bipartite2d(image: np.ndarray, bpt2d,
                     point_color=(0, 0, 255), line_color=(0, 255, 0),
                     edge_color=(255, 0, 0)) -> np.ndarray:
    """Overlay lines, points and their association edges on an image."""
    import cv2

    img = image.copy()
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    segs = []
    for lid in bpt2d.get_line_ids():
        seg = np.asarray(bpt2d.line(lid)).reshape(-1)
        segs.append(seg[:4])
    img = draw_segments(img, np.asarray(segs).reshape(-1, 4), line_color)
    for pid in bpt2d.get_point_ids():
        p = bpt2d.point(pid)
        xy = np.asarray(getattr(p, "p", p), np.float64).reshape(2)
        degree = bpt2d.pdegree(pid)
        img = draw_points(img, xy[None, :],
                          point_color if degree == 0 else edge_color)
        for lid in bpt2d.neighbor_lines(pid):
            seg = np.asarray(bpt2d.line(lid)).reshape(-1)[:4]
            mid = 0.5 * (seg[:2] + seg[2:4])
            cv2.line(img, (int(xy[0]), int(xy[1])),
                     (int(mid[0]), int(mid[1])), edge_color, 1)
    return img


def save_bipartite3d_obj(fname: str, bpt3d,
                         max_edges: Optional[int] = None) -> None:
    """Export a 3D bipartite as an OBJ wireframe: line tracks as
    segments, points as small tetrahedra, association edges as
    segments."""
    verts = []
    lines = []

    def add_seg(a, b):
        verts.append(a)
        verts.append(b)
        lines.append((len(verts) - 1, len(verts)))

    for lid in bpt3d.get_line_ids():
        tr = bpt3d.line(lid)
        line = np.asarray(getattr(tr, "line", tr)).reshape(2, 3)
        add_seg(line[0], line[1])
    n_edges = 0
    for pid in bpt3d.get_point_ids():
        p = bpt3d.point(pid)
        xyz = np.asarray(getattr(p, "p", p), np.float64).reshape(3)
        for lid in bpt3d.neighbor_lines(pid):
            tr = bpt3d.line(lid)
            line = np.asarray(getattr(tr, "line", tr)).reshape(2, 3)
            mid = 0.5 * (line[0] + line[1])
            add_seg(xyz, mid)
            n_edges += 1
            if max_edges is not None and n_edges >= max_edges:
                break
    with open(fname, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for (a, b) in lines:
            f.write(f"l {a + 1} {b + 1}\n")


def open3d_draw_bipartite3d(bpt3d):  # pragma: no cover - needs GUI
    """Interactive open3d view;
    raises a clear error when open3d is unavailable."""
    try:
        import open3d as o3d
    except ImportError as exc:
        raise RuntimeError(
            "open3d is not installed; use save_bipartite3d_obj() for "
            "offline inspection") from exc
    geoms = []
    pts = np.asarray(bpt3d.get_point_cloud())
    if len(pts):
        pcd = o3d.geometry.PointCloud(
            o3d.utility.Vector3dVector(pts))
        geoms.append(pcd)
    segs = np.asarray(bpt3d.get_line_cloud())
    if len(segs):
        ls = o3d.geometry.LineSet()
        v = segs.reshape(-1, 3)
        ls.points = o3d.utility.Vector3dVector(v)
        ls.lines = o3d.utility.Vector2iVector(
            np.arange(len(v)).reshape(-1, 2))
        geoms.append(ls)
    o3d.visualization.draw_geometries(geoms)
