"""Track visualizers: stats report + Open3D / PyVista viewers.

The geometry (line sets with per-track colors,
camera frusta, range culling) comes from the backend-free builders in
vis_lines.py, so every selection path is testable without a GUI stack;
the viewers import open3d / pyvista lazily.
"""

from __future__ import annotations

from typing import List

import numpy as np

from limap_tpu_torch.evaluation.evaluator import report_track_stats
from limap_tpu_torch.visualize.vis_lines import (build_camera_set,
                                                 build_line_set, track_colors)
from limap_tpu_torch.visualize.vis_utils import (compute_robust_range_lines,
                                                 test_line_inside_ranges)


class BaseTrackVisualizer:
    """Track statistics and the selection of tracks to show."""

    def __init__(self, tracks):
        self.tracks = list(tracks)
        self.counts = [t.count_images() for t in self.tracks]
        self.counts_lines = [t.count_lines() for t in self.tracks]
        self.lines = [t.line for t in self.tracks]

    # ------------------------------------------------------- reporting
    def report(self) -> dict:
        stats = self.report_stats()
        self.report_avg_supports(n_visible_views=3)
        self.report_avg_supports(n_visible_views=4)
        return stats

    def report_stats(self) -> dict:
        counts = np.asarray(self.counts)
        ns = {f"N{k}": int((counts >= k).sum())
              for k in (2, 4, 6, 8, 10, 20, 50)}
        print(f"[Track Report] (N2, N4, N6, N8, N10, N20, N50) = "
              f"({ns['N2']}, {ns['N4']}, {ns['N6']}, {ns['N8']}, "
              f"{ns['N10']}, {ns['N20']}, {ns['N50']})")
        stats = report_track_stats(self.tracks)
        stats.update(ns)
        return stats

    def report_avg_supports(self, n_visible_views: int = 4) -> dict:
        counts = np.asarray(self.counts)
        counts_lines = np.asarray(self.counts_lines)
        sel = counts >= n_visible_views
        arr, arr_lines = counts[sel], counts_lines[sel]
        out = {"n_tracks": int(sel.sum()),
               "avg_supporting_images": float(arr.mean()) if len(arr)
               else 0.0,
               "avg_supporting_lines": float(arr_lines.mean())
               if len(arr_lines) else 0.0}
        print(f"average supporting images (>= {n_visible_views}): "
              f"{arr.sum()} / {len(arr)} = "
              f"{out['avg_supporting_images']:.2f}")
        print(f"average supporting lines (>= {n_visible_views}): "
              f"{arr_lines.sum()} / {len(arr_lines)} = "
              f"{out['avg_supporting_lines']:.2f}")
        return out

    # ------------------------------------------------------ selections
    def get_counts_np(self) -> np.ndarray:
        return np.asarray(self.counts)

    def get_lines_np(self, n_visible_views: int = 0) -> np.ndarray:
        lines = [np.asarray(line) for i, line in enumerate(self.lines)
                 if self.counts[i] >= n_visible_views]
        return np.stack(lines) if lines else np.zeros((0, 2, 3))

    def get_lines_n_visible_views(self, n_visible_views: int) -> List:
        return [line for i, line in enumerate(self.lines)
                if self.counts[i] >= n_visible_views]

    def get_lines_for_images(self, image_list):
        lines, counts = [], []
        for tid, line in enumerate(self.lines):
            if any(self.tracks[tid].HasImage(img_id)
                   for img_id in image_list):
                lines.append(np.asarray(line))
                counts.append(self.counts[tid])
        return (np.asarray(lines) if lines else np.zeros((0, 2, 3)),
                np.asarray(counts))

    def get_lines_within_ranges(self, ranges):
        lines, counts = [], []
        for tid, line in enumerate(self.lines):
            if test_line_inside_ranges(np.asarray(line), ranges):
                lines.append(np.asarray(line))
                counts.append(self.counts[tid])
        return (np.asarray(lines) if lines else np.zeros((0, 2, 3)),
                np.asarray(counts))

    # ----------------------------------------------------------- misc
    def save_obj(self, fname: str, n_visible_views: int = 4) -> None:
        from limap_tpu_torch.util import io as limapio

        limapio.save_obj(fname, self.get_lines_np(n_visible_views))

    def vis_all_lines(self, n_visible_views=4, width=2, **kwargs):
        raise NotImplementedError

    def vis_reconstruction(self, imagecols, **kwargs):
        raise NotImplementedError


class Open3DTrackVisualizer(BaseTrackVisualizer):
    """Open3D viewer (camera frusta + per-track colors)."""

    def _line_set(self, n_visible_views, ranges=None, scale=1.0,
                  per_track_colors=True):
        import open3d as o3d

        lines = self.get_lines_n_visible_views(n_visible_views)
        colors = (track_colors(len(lines)) if per_track_colors
                  else np.zeros((len(lines), 3)))
        pts, seg, cols, _ = build_line_set(lines, colors, ranges, scale)
        ls = o3d.geometry.LineSet()
        ls.points = o3d.utility.Vector3dVector(pts)
        ls.lines = o3d.utility.Vector2iVector(seg)
        ls.colors = o3d.utility.Vector3dVector(cols)
        return ls

    def vis_all_lines(self, n_visible_views=4, width=2, ranges=None,
                      scale=1.0, per_track_colors=True):
        import open3d as o3d

        vis = o3d.visualization.Visualizer()
        vis.create_window(height=1080, width=1920)
        vis.add_geometry(self._line_set(n_visible_views, ranges, scale,
                                        per_track_colors))
        vis.run()
        vis.destroy_window()

    def vis_reconstruction(self, imagecols, n_visible_views=4,
                           ranges=None, scale=1.0, cam_scale=1.0,
                           per_track_colors=False):
        import open3d as o3d

        lines = self.get_lines_n_visible_views(n_visible_views)
        lranges = compute_robust_range_lines(lines)
        scale_cam_geometry = float(
            np.abs(lranges[1] - lranges[0]).max())
        vis = o3d.visualization.Visualizer()
        vis.create_window(height=1080, width=1920)
        vis.add_geometry(self._line_set(n_visible_views, ranges, scale,
                                        per_track_colors))
        cam_segs = build_camera_set(
            imagecols, ranges=ranges, scale=scale,
            scale_cam_geometry=scale_cam_geometry * cam_scale)
        cams = o3d.geometry.LineSet()
        cams.points = o3d.utility.Vector3dVector(
            cam_segs.reshape(-1, 3))
        cams.lines = o3d.utility.Vector2iVector(
            np.arange(len(cam_segs) * 2,
                      dtype=np.int32).reshape(-1, 2))
        cams.paint_uniform_color([1.0, 0.0, 0.0])
        vis.add_geometry(cams)
        vis.run()
        vis.destroy_window()


class PyVistaTrackVisualizer(BaseTrackVisualizer):
    """PyVista viewer."""

    def __init__(self, tracks):
        super().__init__(tracks)
        self.plotter = None

    def reset(self, img_hw=(600, 800)):
        import pyvista as pv

        self.plotter = pv.Plotter(window_size=[img_hw[1], img_hw[0]])
        return self.plotter

    def _ensure_plotter(self):
        if self.plotter is None:
            self.reset()
        return self.plotter

    def vis_all_lines(self, n_visible_views=4, width=2, scale=1.0,
                      show=True):
        p = self._ensure_plotter()
        lines = self.get_lines_n_visible_views(n_visible_views)
        pts, seg, cols, _ = build_line_set(
            lines, track_colors(len(lines)), None, scale)
        for k in range(len(seg)):
            p.add_lines(pts[seg[k]], color=tuple(cols[k]), width=width)
        if show:
            p.show()
        return p

    def vis_all_lines_image(self, img_id, img_hw=(600, 800),
                            n_visible_views=4, width=2, show=True):
        p = self._ensure_plotter()
        for tid, line in enumerate(self.lines):
            if self.counts[tid] < n_visible_views:
                continue
            color = ("#00ff00" if self.tracks[tid].HasImage(img_id)
                     else "#ff0000")
            p.add_lines(np.asarray(line), color, width=width)
        if show:
            p.show()
        return p

    def vis_additional_lines(self, lines, img_hw=(600, 800), width=2,
                             show=True):
        p = self._ensure_plotter()
        for line in self.lines:
            p.add_lines(np.asarray(line), "#ff0000", width=width)
        for line in lines:
            p.add_lines(np.asarray(line), "#00ff00", width=width)
        if show:
            p.show()
        return p


def get_track_visualizer(tracks, backend: str = "auto"):
    """Pick an available backend ("open3d" | "pyvista" | base)."""
    if backend in ("auto", "open3d"):
        try:
            import open3d  # noqa: F401

            return Open3DTrackVisualizer(tracks)
        except ImportError:
            if backend == "open3d":
                raise
    if backend in ("auto", "pyvista"):
        try:
            import pyvista  # noqa: F401

            return PyVistaTrackVisualizer(tracks)
        except ImportError:
            if backend == "pyvista":
                raise
    return BaseTrackVisualizer(tracks)
