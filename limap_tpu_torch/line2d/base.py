"""Front-end base classes + registries (detector / extractor / matcher).

Stages cache their results in LIMAP's folder conventions
(segments_{id}.txt, descinfo_{id}.npz, matches_{id}.npy), so they stay
idempotent and resumable.  A method that runs on a device takes it as
``options["device"]`` (``None`` means cuda), which the factories fill
from their ``device`` argument.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from limap_tpu_torch.util import io as limapio

DETECTOR_REGISTRY: Dict[str, type] = {}
EXTRACTOR_REGISTRY: Dict[str, type] = {}
MATCHER_REGISTRY: Dict[str, type] = {}


def register_detector(name):
    def deco(cls):
        DETECTOR_REGISTRY[name] = cls
        return cls
    return deco


def register_extractor(name):
    def deco(cls):
        EXTRACTOR_REGISTRY[name] = cls
        return cls
    return deco


def register_matcher(name):
    def deco(cls):
        MATCHER_REGISTRY[name] = cls
        return cls
    return deco


class BaseDetector:
    """Abstract detector/extractor."""

    # whether detect_array spends its time in native host code that
    # releases the interpreter lock, so threads overlap it
    releases_gil = False

    def __init__(self, options: Optional[dict] = None):
        options = options or {}
        self.max_num_2d_segs = options.get("max_num_2d_segs", 3000)
        self.do_merge_lines = options.get("do_merge_lines", False)
        self.set_gray = True
        self.weight_path = options.get("weight_path")

    # --- to implement ---
    def get_module_name(self) -> str:
        raise NotImplementedError

    def detect(self, camview) -> np.ndarray:
        """-> (N, 5) array x1 y1 x2 y2 score."""
        raise NotImplementedError

    def extract(self, camview, segs) -> dict:
        raise NotImplementedError

    # --- shared machinery ---
    def get_segments_folder(self, output_folder):
        return os.path.join(output_folder, "segments")

    def get_descinfo_folder(self, output_folder):
        return os.path.join(output_folder, "descinfos",
                            self.get_module_name())

    def get_descinfo_fname(self, descinfo_folder, img_id):
        return os.path.join(descinfo_folder, f"descinfo_{img_id}.npz")

    def save_descinfo(self, descinfo_folder, img_id, descinfo):
        limapio.check_makedirs(descinfo_folder)
        np.savez_compressed(
            self.get_descinfo_fname(descinfo_folder, img_id), **descinfo)

    def read_descinfo(self, descinfo_folder, img_id):
        return dict(np.load(self.get_descinfo_fname(descinfo_folder, img_id),
                            allow_pickle=True))

    def take_longest_k(self, segs, max_num_2d_segs=3000):
        """Cap detections at the longest K."""
        indexes = np.arange(segs.shape[0])
        if max_num_2d_segs in (None, -1) or segs.shape[0] <= max_num_2d_segs:
            return segs, indexes
        length2 = ((segs[:, 2] - segs[:, 0]) ** 2
                   + (segs[:, 3] - segs[:, 1]) ** 2)
        indexes = np.argsort(-length2, kind="stable")[:max_num_2d_segs]
        return segs[indexes], indexes

    def detect_all_images(self, output_folder, imagecols,
                          skip_exists: bool = False):
        seg_folder = self.get_segments_folder(output_folder)
        if not skip_exists:
            limapio.delete_folder(seg_folder)
        limapio.check_makedirs(seg_folder)
        for img_id in imagecols.get_img_ids():
            if skip_exists and limapio.exists_txt_segments(seg_folder, img_id):
                continue
            segs = self.detect(imagecols.camview(img_id))
            if self.do_merge_lines and len(segs):
                from limap_tpu_torch.line2d.line_utils import merge_lines
                merged = merge_lines(segs)
                lengths = np.linalg.norm(merged[:, 2:4] - merged[:, :2],
                                         axis=1)
                segs = np.concatenate(
                    [merged, np.sqrt(lengths)[:, None]], axis=1)
            segs, _ = self.take_longest_k(segs, self.max_num_2d_segs)
            limapio.save_txt_segments(seg_folder, img_id, segs)
        all_segs = limapio.read_all_segments_from_folder(seg_folder)
        return {i: all_segs[i] for i in imagecols.get_img_ids()}

    def extract_all_images(self, output_folder, imagecols, all_2d_segs,
                           skip_exists: bool = False):
        folder = self.get_descinfo_folder(output_folder)
        limapio.check_makedirs(folder)
        for img_id in imagecols.get_img_ids():
            fname = self.get_descinfo_fname(folder, img_id)
            if skip_exists and os.path.isfile(fname):
                continue
            descinfo = self.extract(imagecols.camview(img_id),
                                    all_2d_segs[img_id])
            self.save_descinfo(folder, img_id, descinfo)
        return folder

    def detect_and_extract_all_images(self, output_folder, imagecols,
                                      skip_exists: bool = False):
        """Detection then description of every image: (segments by
        image id, descriptor folder)."""
        all_segs = self.detect_all_images(output_folder, imagecols,
                                          skip_exists)
        folder = self.extract_all_images(output_folder, imagecols, all_segs,
                                         skip_exists)
        return all_segs, folder


class BaseMatcher:
    """Abstract matcher."""

    def __init__(self, extractor: BaseDetector,
                 options: Optional[dict] = None):
        options = options or {}
        self.extractor = extractor
        self.topk = options.get("topk", 10)
        self.n_neighbors = options.get("n_neighbors", 20)
        self.weight_path = options.get("weight_path")

    def get_module_name(self) -> str:
        raise NotImplementedError

    def match_pair(self, descinfo1, descinfo2) -> np.ndarray:
        """-> (M, 2) index pairs."""
        raise NotImplementedError

    def get_matches_folder(self, output_folder):
        return os.path.join(output_folder,
                            f"matches_{self.get_module_name()}")

    def save_match(self, matches_folder, img_id, matches: Dict[int,
                                                               np.ndarray]):
        limapio.check_makedirs(matches_folder)
        np.save(os.path.join(matches_folder, f"matches_{img_id}.npy"),
                matches, allow_pickle=True)

    def read_match(self, matches_folder, img_id) -> Dict[int, np.ndarray]:
        return np.load(os.path.join(matches_folder, f"matches_{img_id}.npy"),
                       allow_pickle=True).item()

    def match_all_neighbors(self, output_folder, image_ids, neighbors,
                            descinfo_folder, skip_exists: bool = False):
        matches_folder = self.get_matches_folder(output_folder)
        limapio.check_makedirs(matches_folder)
        cache = {}

        def get_descinfo(img_id):
            if img_id not in cache:
                cache[img_id] = self.extractor.read_descinfo(descinfo_folder,
                                                             img_id)
            return cache[img_id]

        for img_id in image_ids:
            fname = os.path.join(matches_folder, f"matches_{img_id}.npy")
            if skip_exists and os.path.isfile(fname):
                continue
            matches = {}
            for ng in neighbors[img_id]:
                matches[ng] = self.match_pair(get_descinfo(img_id),
                                              get_descinfo(ng))
            self.save_match(matches_folder, img_id, matches)
        return matches_folder

    def match_all_exhaustive_pairs(self, output_folder, image_ids,
                                   descinfo_folder,
                                   skip_exists: bool = False):
        """Match every image with every other one."""
        neighbors = {i: [j for j in image_ids if j != i] for i in image_ids}
        return self.match_all_neighbors(output_folder, image_ids, neighbors,
                                        descinfo_folder, skip_exists)


# ----------------------------------------------------------- factories
# Methods the reference package registers and this one does not have yet
# (learned detectors, descriptors and matchers; ROADMAP.md queue 1
# item 14).
NOT_PORTED = {
    "detector": ("deeplsd", "hawpv3", "sold2", "tp_lsd",
                 "superpoint_endpoints"),
    "extractor": ("dense_naive", "gluestick", "l2d2", "lbd", "linetr",
                  "sold2", "superpoint_endpoints"),
    "matcher": ("dense_ncc", "dense_roma", "gluestick", "l2d2", "lbd",
                "linetr", "sold2", "superglue_endpoints",
                "sinkhorn_endpoints"),
}


def _lookup(kind: str, registry: Dict[str, type], method: str) -> type:
    import limap_tpu_torch.line2d.endpoints  # noqa: F401  (registers)
    import limap_tpu_torch.line2d.lsd  # noqa: F401
    import limap_tpu_torch.line2d.tpu_lsd  # noqa: F401
    if method in registry:
        return registry[method]
    if method in NOT_PORTED[kind]:
        raise NotImplementedError(
            f"{kind} {method!r} is not ported yet (ROADMAP.md queue 1 "
            "item 14)")
    raise NotImplementedError(f"unknown {kind} {method!r}")


def get_detector(cfg_detector: dict, max_num_2d_segs: int = 3000,
                 do_merge_lines: bool = False, weight_path=None,
                 device=None) -> BaseDetector:
    cls = _lookup("detector", DETECTOR_REGISTRY, cfg_detector["method"])
    options = dict(cfg_detector)
    options.update(max_num_2d_segs=max_num_2d_segs,
                   do_merge_lines=do_merge_lines, weight_path=weight_path,
                   device=device)
    return cls(options)


def detect_arrays_parallel(cfg_detector: dict, imgs: dict,
                           n_workers: int = 2, **det_kwargs) -> dict:
    """Detection over {img_id: array}.  A host detector whose native
    code releases the interpreter lock (cv2's LSD) fans out over a small
    thread pool, one detector instance per thread (a cv2 LSD shared
    across threads segfaults).  A device detector is a stream of small
    launches made from Python, which two threads only slow down
    (measured on an H100: 73 ms an image with two threads, 22 ms with
    one), so it runs in the calling thread.
    Returns {img_id: [N, >=4] segments} (longest-k capped)."""
    det = get_detector(cfg_detector, **det_kwargs)
    if not det.releases_gil:
        return {i: det.take_longest_k(det.detect_array(img))[0]
                for i, img in imgs.items()}

    import threading
    from concurrent.futures import ThreadPoolExecutor

    tl = threading.local()

    def work(img):
        if not hasattr(tl, "det"):
            tl.det = get_detector(cfg_detector, **det_kwargs)
        return tl.det.take_longest_k(tl.det.detect_array(img))[0]

    ids = list(imgs.keys())
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        out = list(ex.map(work, (imgs[i] for i in ids)))
    return dict(zip(ids, out))


def get_extractor(cfg_extractor: dict, weight_path=None,
                  device=None) -> BaseDetector:
    cls = _lookup("extractor", EXTRACTOR_REGISTRY, cfg_extractor["method"])
    options = dict(cfg_extractor)
    options.update(weight_path=weight_path, device=device)
    return cls(options)


def get_matcher(cfg_matcher: dict, extractor: BaseDetector,
                n_neighbors: int = 20, weight_path=None,
                device=None) -> BaseMatcher:
    cls = _lookup("matcher", MATCHER_REGISTRY, cfg_matcher["method"])
    options = dict(cfg_matcher)
    options.update(n_neighbors=n_neighbors, weight_path=weight_path,
                   device=device)
    return cls(extractor, options)
