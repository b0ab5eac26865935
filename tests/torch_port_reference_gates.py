"""Quality reference for chip_smoke.py's full-width phase: runs the JAX
package's slice (triangulate -> tracks -> filters + remerge -> line BA)
on the protocol scene of bench.py (100 views x 1500 lines x 20
neighbours, max_tris_per_node=32) on the CPU, and scores its lines
against a GT cloud of 500 points per GT segment with 1000 samples per
line at taus (0.01, 0.05, 0.10).

The nearest-neighbour distances come from an exact k-d tree (scipy), so
the scoring does not depend on either package's kernel.  Prints one JSON
line.  Run from the repo root:

    JAX_PLATFORMS=cpu python tests/torch_port_reference_gates.py
"""

import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from limap_tpu.base.line_linker import LineLinker3dConfig  # noqa: E402
from limap_tpu.base.linetrack import batch_to_tracks  # noqa: E402
from limap_tpu.merging.merging import (compact_track_batch,  # noqa: E402
                                       filter_chain_batch)
from limap_tpu.optimize.line_ba import (LineBAConfig,  # noqa: E402
                                        get_output_tracks,
                                        solve_line_bundle_adjustment)
from limap_tpu.triangulation.triangulator import (  # noqa: E402
    GlobalLineTriangulator, TriangulatorConfig)
from limap_tpu_torch.testing import synthetic  # noqa: E402

TAUS = (0.01, 0.05, 0.1)
F2D = {"th_angular_2d": 10.0, "th_perp_2d": 10.0, "th_sv_angular_3d": 70.0,
       "th_sv_num_supports": 3, "th_overlap": 0.05,
       "th_overlap_num_supports": 3}


def main(n_views=100, n_lines=1500, n_neighbors=20):
    t0 = time.perf_counter()
    imagecols, segs, nbrs = bench.build_scene(n_views, n_lines, n_neighbors)
    views = imagecols.batch()
    tri = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=32))
    tri.init(segs, imagecols)
    tri.triangulate_all(nbrs)
    tb, host = tri.compute_track_batch(return_host=True)
    tb, host = filter_chain_batch(tb, views, F2D, LineLinker3dConfig(),
                                  host=host)
    tb, host = compact_track_batch(host.refresh(tb, with_line=True),
                                   return_host=True)
    cfg = LineBAConfig(max_num_iterations=20)
    refined, _ = solve_line_bundle_adjustment(tb, views, cfg)
    tb = get_output_tracks(tb, views, refined, cfg.num_outliers_aggregator)
    tracks = [t for t in batch_to_tracks(tb, host=host) if t.count_lines()]
    t_map = time.perf_counter() - t0

    # the same GT draw as bench.build_scene, and the GT cloud chip_smoke
    # evaluates against
    gt = synthetic.build_scene(n_views, n_lines, n_neighbors,
                               device="cpu")[3]
    cloud = synthetic.gt_point_cloud(gt, 500)
    lines = np.stack([tr.line for tr in tracks]).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 1000, dtype=np.float32)
    samples = lines[:, None, 0] + ts[None, :, None] * (
        lines[:, None, 1] - lines[:, None, 0])
    d, _ = cKDTree(cloud).query(samples.reshape(-1, 3), workers=2)
    d = d.reshape(len(lines), -1)
    lengths = np.linalg.norm(lines[:, 1] - lines[:, 0], axis=1)
    out = {"n_tracks": len(tracks), "map_s": t_map,
           "gt_length": float(np.linalg.norm(gt[:, 1] - gt[:, 0],
                                             axis=1).sum())}
    for tau in TAUS:
        ratios = (d <= tau).mean(1)
        out[f"recall_{tau}"] = float((ratios * lengths).sum())
        out[f"precision_{tau}"] = float((ratios > 0).mean() * 100.0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
