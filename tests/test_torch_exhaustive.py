"""The exhaustive matcher and the bucket program (kernels F and G
through their plain versions) against the JAX package on the CPU; the
oracle comparison is in test_torch_exhaustive_oracle.py.

JAX's exhaustive path sends every (line, neighbour line) pair through
the matcher path's bucket, which keeps a line's first max_tris_per_node
raw candidates before any cull.  Where that does not overflow, the port
must give JAX's tracks; where it does (5 views x 40 lines), the port
follows the oracle, which culls each proposal before keeping it and caps
nothing, and a test keeps JAX's collapse on record.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from limap_tpu.testing import reference_oracle as oracle
from limap_tpu.triangulation.triangulator import \
    GlobalLineTriangulator as JTri
from limap_tpu.triangulation.triangulator import \
    TriangulatorConfig as JCfg
from limap_tpu_torch.base.image_collection import \
    ImageCollection as PCollection
from limap_tpu_torch.ops import tri_propose, tri_score
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig,
                                                        bucket_program)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_oracle_parity import (make_gt_lines, make_views,  # noqa: E402
                                project_all, to_imagecols)
from test_torch_edge_cases import jax_collection  # noqa: E402
from test_torch_stages import noisy_scene  # noqa: E402

# the oracle scene's linkers are the triangulation config's defaults
ORACLE_CFG = dict(
    min_length_2d=0.0, line_tri_angle_threshold=1.0, min_num_outer_edges=0,
    linker2d=oracle.Linker2dCfg(th_angle=5.0, th_perp=2.0, th_overlap=0.05),
    linker3d=oracle.Linker3dCfg(th_angle=10.0, th_overlap=0.05,
                                th_smartoverlap=0.1, th_smartangle=2.0,
                                th_perp=1.0, th_innerseg=1.0,
                                th_scaleinv=0.015))
# a support whose best proposal is within TIE_EPS of its second best may
# take the other one under float32 rounding (as chip_smoke's card-to-CPU
# check); its track's line then moves by up to TIE_LINE_TOL
TIE_EPS = 1e-3
TIE_LINE_TOL = 5e-2


def _supports(track):
    return tuple(sorted(zip(map(int, track.image_id_list),
                            map(int, track.line_id_list))))


def _line_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a[::-1] - b).max())


def _scene(n_views, n_lines, noise, seed=0):
    rng = np.random.default_rng(seed)
    views = make_views(rng, n_views)
    gt = make_gt_lines(rng, n_lines)
    segs = project_all(views, gt, noise, rng)
    nbrs = {i: [j for j in range(n_views) if j != i] for i in range(n_views)}
    return views, segs, nbrs


def _port_exhaustive(views, segs, nbrs, per_image, **cfg):
    pic = PCollection.from_dict(to_imagecols(views).as_dict())
    pt = GlobalLineTriangulator(TriangulatorConfig(**cfg), device="cpu")
    pt.init(segs, pic)
    if per_image:
        for i in sorted(nbrs):
            pt.triangulate_image_exhaustive(i, nbrs[i])
    else:
        pt.triangulate_all_exhaustive(nbrs)
    return pt


def _jax_exhaustive(views, segs, nbrs, **cfg):
    jt = JTri(JCfg(**cfg))
    jt.init(segs, to_imagecols(views))
    for i in sorted(nbrs):
        jt.triangulate_image_exhaustive(i, nbrs[i])
    return jt


def _best_gaps(pt, nbrs):
    """Each node's gap between its best and second-best proposal scores,
    from the plain kernels on the triangulator's own inputs."""
    gaps = {}
    K = max(len(v) for v in nbrs.values())
    for i in sorted(nbrs):
        row = pt.id2idx[i]
        meta = torch.as_tensor(pt._meta(
            [[pt.id2idx[n] for n in sorted(nbrs[i])]], [row], K))
        args = (pt.cfg, pt.L, K, pt._l2d_packed, pt._cam_packed)
        W = tri_propose.bucket_width(int(
            tri_propose.count_exhaustive(*args, meta).max()))
        words, tri, ok = tri_propose.propose_exhaustive(*args, meta, W)
        _, _, scores = tri_score.score(*args, words.reshape(1, pt.L, W),
                                       meta, tri, ok, return_scores=True)
        top = torch.sort(scores, 1, descending=True).values
        for a in range(len(segs_of(pt, i))):
            gaps[(i, a)] = float(top[a, 0] - top[a, 1]) if W > 1 else 1.0
    return gaps


def segs_of(pt, img_id):
    return pt.lines2d[pt.id2idx[img_id]][:int(pt.n_lines[pt.id2idx[img_id]])]


# ------------------------------------------------------- bucket program
def test_bucket_program_plain_matches_jax():
    """Kernels F and G through their plain versions against JAX's bucket
    program on the same edge words: equal edge tables, best scores within
    1e-3 and best rows within 5 mm (the proposal tolerance of the stage
    tests) on the rows any consumer reads (best score > 0)."""
    imagecols, segs, nbrs, _ = noisy_scene(n_views=8, n_lines=40,
                                           n_neighbors=4, noise=0.2, seed=5)
    pt = GlobalLineTriangulator(TriangulatorConfig(max_tris_per_node=16),
                                device="cpu")
    jt = JTri(JCfg(max_tris_per_node=16))
    pt.init(segs, imagecols)
    jt.init(segs, jax_collection(imagecols))
    rows = [pt.id2idx[i] for i in pt.img_ids]
    mlist = [nbrs[i] for i in pt.img_ids]
    per_key, per_val, nbr_rows, K, Tc = pt._gather_edges(rows, mlist)
    words, meta, _ = pt._fill_group(per_key, per_val, nbr_rows, rows, 0,
                                    len(rows), K, Tc)
    pf, pi = bucket_program(pt.cfg, pt.L, K, Tc, pt._l2d_packed,
                            pt._cam_packed, torch.as_tensor(words),
                            torch.as_tensor(meta))
    kern = jt._get_bucket_kernel(K, Tc)
    jf, ji = kern(jt._l2d_packed, jt._cam_packed,
                  jnp.asarray(words.reshape(-1)), jnp.asarray(meta.reshape(-1)),
                  None, None, None)
    jf, ji = np.asarray(jf), np.asarray(ji)
    pf, pi = pf.numpy(), pi.numpy()
    read = (jf[..., 9] > 0) | (pf[..., 9] > 0)
    assert read.sum() > 100
    np.testing.assert_array_equal(pi[read], ji[read])
    np.testing.assert_allclose(pf[read][:, 9], jf[read][:, 9], atol=1e-3)
    np.testing.assert_allclose(pf[read][:, :8], jf[read][:, :8], atol=5e-3)


def test_exhaustive_plain_form_matches_words_form():
    """Form (b)'s survivors are form (a)'s ok proposals of the full match
    table, in the order slot, then neighbour line."""
    views, segs, nbrs = _scene(4, 6, 0.1)
    pt = _port_exhaustive(views, segs, nbrs, per_image=False)
    K = 3
    ids = sorted(nbrs)
    rows = [pt.id2idx[i] for i in ids]
    meta = torch.as_tensor(pt._meta(
        [[pt.id2idx[n] for n in sorted(nbrs[i])] for i in ids], rows, K))
    args = (pt.cfg, pt.L, K, pt._l2d_packed, pt._cam_packed)
    counts = tri_propose.count_exhaustive(*args, meta)
    W = tri_propose.bucket_width(int(counts.max()))
    words_b, tri_b, ok_b = tri_propose.propose_exhaustive(*args, meta, W)
    full = {i: {n: np.stack(np.meshgrid(np.arange(6), np.arange(6),
                                        indexing="ij"), -1).reshape(-1, 2)
                for n in nbrs[i]} for i in ids}
    per_key, per_val, nbr_rows, _, _ = pt._gather_edges(
        rows, [full[i] for i in ids])
    words_a, meta_a, _ = pt._fill_group(per_key, per_val, nbr_rows, rows, 0,
                                        len(rows), K, 3 * 6)
    tri_a, ok_a = tri_propose.propose(*args, torch.as_tensor(words_a),
                                      torch.as_tensor(meta_a))
    wa = torch.as_tensor(words_a).reshape(len(rows) * pt.L, -1)
    assert torch.equal(counts, ok_a.sum(1).to(torch.int32))
    assert int(counts.sum()) > 40
    for n in range(len(rows) * pt.L):
        c = int(counts[n])
        assert torch.equal(words_b[n, :c], wa[n][ok_a[n]])
        assert torch.equal(tri_b[n, :c], tri_a[n][ok_a[n]])
        assert bool(ok_b[n, :c].all()) and not bool(ok_b[n, c:].any())


# ------------------------------------------------------------ exhaustive
def test_exhaustive_matches_jax_without_overflow():
    """4 views x 6 lines: 18 candidates a line, under JAX's bucket of
    64, so JAX keeps every candidate and the port must give its tracks."""
    views, segs, nbrs = _scene(4, 6, 0.1)
    jt = _jax_exhaustive(views, segs, nbrs, fullscore_th=0.5)
    assert jt.overflow_edges == 0
    for per_image in (True, False):
        pt = _port_exhaustive(views, segs, nbrs, per_image,
                              fullscore_th=0.5)
        ptr = {_supports(t): t for t in pt.compute_line_tracks()}
        jtr = {_supports(t): t for t in jt.compute_line_tracks()}
        assert set(ptr) == set(jtr) and len(ptr) >= 5
        for s in ptr:
            assert _line_err(ptr[s].line, jtr[s].line) < 1e-3
        # the batch route gives the same tracks
        batch = pt.compute_track_batch()
        assert int(batch.track_mask.sum()) == len(ptr)


def test_exhaustive_runner_matches_jax(rng, tmp_path):
    """Both packages' line_triangulation with use_exhaustive_matcher on
    the toy rendered scene of tests/test_pipeline_e2e.py, from the same
    PNGs: the same supports, lines within 1 mm."""
    from limap_tpu.runners import line_triangulation as jrun
    from limap_tpu.util.config import load_config
    from limap_tpu_torch.runners import line_triangulation as prun
    from test_pipeline_e2e import make_scene
    imagecols, gt, _ = make_scene(rng, tmp_path)
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfgs", "triangulation", "default.yaml")

    def cfg(out):
        c = load_config(cfg_path)
        c.update(output_dir=str(tmp_path / out), max_image_dim=-1,
                 n_visible_views=3, n_neighbors=4)
        tri = c["triangulation"]
        tri["filtering2d"]["th_sv_num_supports"] = 2
        tri["filtering2d"]["th_overlap_num_supports"] = 2
        tri["fullscore_th"] = 0.5
        tri["use_exhaustive_matcher"] = True
        c["refinement"]["min_num_images"] = 3
        return c

    jtracks = jrun(cfg("jax"), imagecols)
    ptracks = prun(cfg("port"), PCollection.from_dict(imagecols.as_dict()),
                   device="cpu")
    assert not os.path.exists(tmp_path / "port" / "line_matchings")
    jt = {_supports(t): t for t in jtracks}
    pt = {_supports(t): t for t in ptracks}
    assert set(pt) == set(jt)
    assert sum(t.count_images() >= 3 for t in ptracks) >= len(gt) - 1
    for s in pt:
        assert _line_err(pt[s].line, jt[s].line) < 1e-3
