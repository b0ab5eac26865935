"""GlobalLineTriangulator options against the JAX package on a small
scene: endpoint triangulation, the degree filter (host clustering path),
the valid-connection cap, half-pixel shift with a length filter, and
scene ranges.  Edge tables and track supports must match exactly.

0.2 px of endpoint noise keeps proposal scores off the fullscore_th
boundary and best proposals apart (see test_torch_stages)."""

import numpy as np
import pytest

from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

from test_torch_edge_cases import jax_collection
from test_torch_stages import noisy_scene

RANGES = (np.array([-6.0, -6.0, 4.0]), np.array([6.0, 6.0, 15.0]))
OPTIONS = {
    "endpoints": dict(use_endpoints_triangulation=True),
    "min_outer_edges": dict(min_num_outer_edges=2),
    "max_valid_conns": dict(max_valid_conns=2),
    "halfpix_min_length": dict(add_halfpix=True, min_length_2d=40.0),
    "ranges": {},
}


@pytest.fixture(scope="module")
def scene():
    return noisy_scene(n_views=8, n_lines=40, n_neighbors=4, noise=0.2,
                       seed=5)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_reference(scene, name):
    imagecols, segs, nbrs, _ = scene
    cfg = dict(max_tris_per_node=8, **OPTIONS[name])
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    jt = JTri(JCfg(**cfg))
    pt.init(segs, imagecols)
    jt.init(segs, jax_collection(imagecols))
    if name == "ranges":
        pt.set_ranges(RANGES)
        jt.set_ranges(RANGES)
    pt.triangulate_all(nbrs)
    jt.triangulate_all(nbrs)
    _, outs, Tc = jt._dev_results
    ref = np.concatenate([np.asarray(o[2]) for o in outs])[
        :len(imagecols.images)]
    np.testing.assert_array_equal(pt._tables()[1].numpy(), ref)

    pb = pt.compute_track_batch()
    jb = jt.compute_track_batch()
    assert int(pb.track_mask.sum()) == int(np.asarray(jb.track_mask).sum())
    assert int(pb.track_mask.sum()) > 3
    for f in ("img_index", "line_ids", "mask", "track_mask"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_allclose(pb.line2d.start.numpy(),
                               np.asarray(jb.line2d.start))
