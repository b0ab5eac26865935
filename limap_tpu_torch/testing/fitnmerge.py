"""Fit and merge from pixels and depth on the rendered scene of
:mod:`limap_tpu_torch.testing.pipeline` (posed 800x600 views of a wall of
lines): each view also gets the analytic depth map of the wall plane,
and ``line_fitnmerge`` maps from the images and the depths with the
default fit-and-merge config (``tpu_lsd``, 64 samples and 32 hypotheses
a segment).

    python -m limap_tpu_torch.testing.fitnmerge [N_VIEWS] [DEVICE]

prints one JSON line (stage seconds, counts, quality); DEVICE defaults
to cuda, and ``cpu`` must be asked for.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.depth_reader_base import ArrayDepthReader
from limap_tpu_torch.testing import pipeline


def wall_depth(view) -> np.ndarray:
    """The depth [H, W] float32 of the plane z = WALL_Z seen from a
    ``CameraView``; pixels whose ray misses the plane read 0 (invalid)."""
    fx, fy, cx, cy = view.cam.kvec()
    h, w = view.h(), view.w()
    R = view.pose.R()
    C = view.pose.center()
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1)
    dz = rays @ R[:, 2]         # world z of R^T ray; camera depth of it is 1
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = (pipeline.WALL_Z - C[2]) / dz
    return np.where(dz > 0, depth, 0.0).astype(np.float32)


def build_scene(n_views=pipeline.N_VIEWS, n_lines=pipeline.N_GT_LINES,
                seed=0, hw=(pipeline.H, pipeline.W),
                n_neighbors=pipeline.N_NEIGHBORS, image_dir=None):
    """:func:`pipeline.build_scene` plus a depth reader a view:
    (imagecols, imgs, nbrs, gt, depths {img_id: ArrayDepthReader})."""
    imagecols, imgs, nbrs, gt = pipeline.build_scene(
        n_views, n_lines, seed, hw, n_neighbors, image_dir)
    depths = {i: ArrayDepthReader(wall_depth(imagecols.camview(i)))
              for i in imagecols.get_img_ids()}
    return imagecols, imgs, nbrs, gt, depths


def config(output_dir, n_neighbors=pipeline.N_NEIGHBORS) -> dict:
    """The default fit-and-merge config with the scene's neighbours."""
    from limap_tpu_torch.util.config import default_fitnmerge_config
    cfg = default_fitnmerge_config()
    cfg.update(output_dir=output_dir, n_neighbors=n_neighbors)
    return cfg


def summarize(tracks, output_dir, gt) -> dict:
    """Counts and quality of a run, and its stage seconds from
    ``fitnmerge_metrics.json``."""
    from limap_tpu_torch.util import io as limapio
    with open(os.path.join(output_dir, "fitnmerge_metrics.json")) as f:
        stages = json.load(f)["stages_s"]
    segs = limapio.read_all_segments_from_folder(os.path.join(
        output_dir, "line_detections", "tpu_lsd", "segments"))
    fitted = np.load(os.path.join(output_dir, "fitted_3d_segs.npy"),
                     allow_pickle=True).item()
    return {"stages_s": stages, "n_tracks_all": len(tracks),
            "avg_segs": float(np.mean([len(v) for v in segs.values()])),
            "n_fitted": int(sum((np.abs(v).sum((1, 2)) > 0).sum()
                                for v in fitted.values())),
            "quality": pipeline.quality_eval(tracks, gt)}


def run(n_views=pipeline.N_VIEWS, device=None, scene=None, workdir=None):
    """One ``line_fitnmerge`` run on the scene (default: the protocol
    scene at ``n_views``), its images as .npy under ``workdir``.  Returns
    :func:`summarize`'s dict with the ``linetracks``."""
    from limap_tpu_torch.runners import line_fitnmerge
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = workdir or tmp
        if scene is None:
            scene = build_scene(n_views, image_dir=os.path.join(workdir,
                                                                "images"))
        imagecols, _, nbrs, gt, depths = scene
        out = os.path.join(workdir, "fitnmerge")
        tracks = line_fitnmerge(config(out, len(nbrs[0])), imagecols, depths,
                                neighbors=nbrs, device=device)
        res = summarize(tracks, out, gt)
    res["linetracks"] = tracks
    return res


def main(n_views: int = pipeline.N_VIEWS, device=None) -> None:
    r = run(int(n_views), device=device)
    r.pop("linetracks")
    print(json.dumps({"device": str(resolve_device(device)),
                      "n_views": int(n_views), **r}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
