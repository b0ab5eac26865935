"""2D drawing and range helpers."""

from __future__ import annotations

import numpy as np


def random_color(rng=None):
    rng = rng or np.random.default_rng()
    return tuple(int(c) for c in rng.integers(64, 255, 3))


# ------------------------------------------------- range culling utils
def test_point_inside_ranges(point, ranges) -> bool:
    """Whether the point lies strictly inside the ranges."""
    point = np.asarray(point)
    return bool(np.all(point > ranges[0]) and np.all(point < ranges[1]))


def test_line_inside_ranges(line, ranges) -> bool:
    """Both endpoints inside the ranges; accepts [2, 3] arrays or objects
    with .start/.end."""
    if hasattr(line, "start"):
        s, e = np.asarray(line.start), np.asarray(line.end)
    else:
        arr = np.asarray(line).reshape(2, 3)
        s, e = arr[0], arr[1]
    return (test_point_inside_ranges(s, ranges)
            and test_point_inside_ranges(e, ranges))


def compute_robust_range(arr, range_robust=(0.05, 0.95),
                         k_stretch: float = 2.0):
    """Percentile range stretched by k."""
    arr_sorted = np.sort(np.asarray(arr).reshape(-1))
    N = arr_sorted.shape[0]
    start = arr_sorted[int(round((N - 1) * range_robust[0]))]
    end = arr_sorted[int(round((N - 1) * range_robust[1]))]
    mid = (start + end) / 2.0
    half = k_stretch * (end - start) / 2.0
    return mid - half, mid + half


def compute_robust_range_points(points, range_robust=(0.05, 0.95),
                                k_stretch: float = 2.0) -> np.ndarray:
    pts = np.asarray(points).reshape(-1, 3)
    lo_hi = [compute_robust_range(pts[:, k], range_robust, k_stretch)
             for k in range(3)]
    return np.asarray([[r[0] for r in lo_hi], [r[1] for r in lo_hi]])


def compute_robust_range_lines(lines, range_robust=(0.05, 0.95),
                               k_stretch: float = 2.0) -> np.ndarray:
    arrs = [np.asarray(line.as_array() if hasattr(line, "as_array")
                       else line).reshape(2, 3) for line in lines]
    return compute_robust_range_points(np.concatenate(arrs),
                                       range_robust, k_stretch)


def filter_ranges(lines_np, counts_np, ranges):
    """The lines inside the ranges, and their counts."""
    keep = [i for i in range(len(lines_np))
            if test_line_inside_ranges(lines_np[i], ranges)]
    return (np.asarray([lines_np[i] for i in keep]),
            np.asarray([counts_np[i] for i in keep]))


def draw_segments(img: np.ndarray, segs: np.ndarray,
                  color=(0, 255, 0), thickness: int = 1) -> np.ndarray:
    import cv2
    out = img.copy()
    if out.ndim == 2:
        out = cv2.cvtColor(out, cv2.COLOR_GRAY2BGR)
    for s in np.asarray(segs):
        p1 = tuple(np.round(s[:2]).astype(int))
        p2 = tuple(np.round(s[2:4]).astype(int))
        cv2.line(out, p1, p2, color, thickness)
    return out


def draw_points(img: np.ndarray, points: np.ndarray,
                color=(0, 0, 255), radius: int = 2) -> np.ndarray:
    import cv2
    out = img.copy()
    if out.ndim == 2:
        out = cv2.cvtColor(out, cv2.COLOR_GRAY2BGR)
    for p in np.asarray(points):
        cv2.circle(out, tuple(np.round(p[:2]).astype(int)), radius, color,
                   -1)
    return out


def draw_matches(img1: np.ndarray, segs1: np.ndarray, img2: np.ndarray,
                 segs2: np.ndarray, matches: np.ndarray) -> np.ndarray:
    """Side-by-side match visualization."""
    import cv2
    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]

    def to_bgr(im):
        return cv2.cvtColor(im, cv2.COLOR_GRAY2BGR) if im.ndim == 2 else im

    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[:img1.shape[0], :img1.shape[1]] = to_bgr(img1)
    canvas[:img2.shape[0], img1.shape[1]:] = to_bgr(img2)
    off = img1.shape[1]
    rng = np.random.default_rng(0)
    for a, b in np.asarray(matches).reshape(-1, 2):
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        s1 = segs1[int(a)]
        s2 = segs2[int(b)]
        cv2.line(canvas, tuple(np.round(s1[:2]).astype(int)),
                 tuple(np.round(s1[2:4]).astype(int)), color, 2)
        cv2.line(canvas,
                 tuple((np.round(s2[:2]) + [off, 0]).astype(int)),
                 tuple((np.round(s2[2:4]) + [off, 0]).astype(int)), color, 2)
        m1 = 0.5 * (s1[:2] + s1[2:4])
        m2 = 0.5 * (s2[:2] + s2[2:4]) + [off, 0]
        cv2.line(canvas, tuple(np.round(m1).astype(int)),
                 tuple(np.round(m2).astype(int)), color, 1)
    return canvas
