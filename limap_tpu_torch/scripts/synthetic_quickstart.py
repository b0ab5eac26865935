"""Quickstart on the synthetic rendered scene.

The reference's quickstart downloads the Hypersim ``ai_001_001`` scene
and runs its triangulation runner on the first 100 views.  Without a
network, this quickstart renders the deterministic scene of
``limap_tpu_torch/testing/pipeline.py`` (posed 800x600 views of a wall of
120 lines, images as ``.npy``), runs the whole ``line_triangulation``
runner on it (detection, matching, triangulation, filters, BA, saved
tracks) with ``pipeline.runner_config``, and scores the tracks against
the GT segments (length recall and precision at tau).

    python -m limap_tpu_torch.scripts.synthetic_quickstart \\
        [--n_views 100] [--output_dir outputs/quickstart] [--device cpu] \\
        [--section.key value ...]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    from limap_tpu_torch.runners import line_triangulation
    from limap_tpu_torch.testing import pipeline
    from limap_tpu_torch.util.config import update_config

    parser = argparse.ArgumentParser(
        description="line triangulation on the synthetic rendered scene")
    parser.add_argument("--n_views", type=int, default=pipeline.N_VIEWS)
    parser.add_argument("--output_dir", type=str,
                        default="outputs/quickstart")
    parser.add_argument("--device", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)

    imagecols, _, nbrs, gt = pipeline.build_scene(
        args.n_views, image_dir=os.path.join(args.output_dir, "images"))
    cfg = update_config(pipeline.runner_config(args.output_dir), unknown, {})
    tracks = line_triangulation(cfg, imagecols, neighbors=nbrs,
                                device=args.device)
    q = pipeline.quality_eval(tracks, gt)
    q["gt_lines"] = len(gt)
    print(json.dumps({"quickstart_quality": q}, indent=1))
    out = os.path.join(args.output_dir, "quality.json")
    with open(out, "w") as f:
        json.dump(q, f, indent=1)
    print(f"tracks: {len(tracks)}; quality written to {out}")
    return tracks, q


if __name__ == "__main__":
    main()
