"""LSD detector via OpenCV, on the host.  ``cv2`` is imported when a
detector is built, so the module imports anywhere and the detector
raises ``ImportError`` on a machine without OpenCV."""

from __future__ import annotations

import numpy as np

from limap_tpu_torch.line2d.base import BaseDetector, register_detector


@register_detector("lsd")
class LSDDetector(BaseDetector):
    releases_gil = True

    def __init__(self, options=None):
        super().__init__(options)
        import cv2
        self._lsd = cv2.createLineSegmentDetector(cv2.LSD_REFINE_ADV)

    def get_module_name(self):
        return "lsd"

    def detect(self, camview) -> np.ndarray:
        img = camview.read_image(set_gray=True)
        if img is None:
            return np.zeros((0, 5))
        lines, widths, precs, nfas = self._lsd.detect(img)
        if lines is None:
            return np.zeros((0, 5))
        segs = lines.reshape(-1, 4).astype(np.float64)
        lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1)
        score = np.sqrt(lengths)
        if nfas is not None and len(nfas) == len(segs):
            score = np.sqrt(lengths) * np.abs(nfas.reshape(-1))
        return np.concatenate([segs, score[:, None]], axis=1)

    def detect_array(self, img: np.ndarray) -> np.ndarray:
        """Detect on an in-memory grayscale array."""
        lines, _, _, nfas = self._lsd.detect(img)
        if lines is None:
            return np.zeros((0, 5))
        segs = lines.reshape(-1, 4).astype(np.float64)
        lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1)
        return np.concatenate([segs, np.sqrt(lengths)[:, None]], axis=1)

    def detect_all_images(self, output_folder, imagecols,
                          skip_exists: bool = False):
        """Threaded folder-level detection.  One cv2 LSD instance per
        thread: a shared instance segfaults."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from limap_tpu_torch.util import io as limapio

        seg_folder = self.get_segments_folder(output_folder)
        if not skip_exists:
            limapio.delete_folder(seg_folder)
        limapio.check_makedirs(seg_folder)
        tl = threading.local()

        def work(img_id):
            if skip_exists and limapio.exists_txt_segments(seg_folder,
                                                           img_id):
                return
            if not hasattr(tl, "det"):
                tl.det = LSDDetector(
                    {"max_num_2d_segs": self.max_num_2d_segs})
            segs = tl.det.detect(imagecols.camview(img_id))
            if self.do_merge_lines and len(segs):
                from limap_tpu_torch.line2d.line_utils import merge_lines
                merged = merge_lines(segs)
                lengths = np.linalg.norm(
                    merged[:, 2:4] - merged[:, :2], axis=1)
                segs = np.concatenate(
                    [merged, np.sqrt(lengths)[:, None]], axis=1)
            segs, _ = self.take_longest_k(segs, self.max_num_2d_segs)
            limapio.save_txt_segments(seg_folder, img_id, segs)

        with ThreadPoolExecutor(max_workers=2) as ex:
            list(ex.map(work, imagecols.get_img_ids()))
        all_segs = limapio.read_all_segments_from_folder(seg_folder)
        return {i: all_segs[i] for i in imagecols.get_img_ids()}
