"""Global multi-view line triangulator: proposals, scoring and track
building.

With a matcher, every image's candidate match edges are bucketed on the
host into up to ``Tc`` slots per line (``[G, L, Tc]`` int32 edge words,
``(b << 7) | slot``, -1 = empty).  With the exhaustive matcher, kernel
F enumerates each line against every line of each neighbour and keeps
the survivors of its culls, all of them, compacted per line.  Either way
kernel G then scores all pairs of proposals of a line against each
other (the reference's O(tris^2) loop), keeps one support per neighbour
image, picks the best proposal per line and packs its valid edges.
Results stay on the device until the clustering step (edge gate +
connected components, or the host strategies) has run.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.base.line_linker import (LineLinker2dConfig,
                                              LineLinker3dConfig, score_3d)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import (LineTrack,
                                             batch_from_flat_supports,
                                             tracks_to_batch)
from limap_tpu_torch.merging.aggregator import aggregate_tracks
from limap_tpu_torch.merging.strategies import (
    compute_track_labels_avg, compute_track_labels_exhaustive)
from limap_tpu_torch.ops import hostops, tri_propose, tri_score
from limap_tpu_torch.ops.connected_components import connected_components
from limap_tpu_torch.util import dataclass_from_dict, shape_bucket

# bytes of proposal rows (tri, ok, words, scores: 46 a proposal) one
# group of images may hold on the device
GROUP_BYTES = 2e9
PROPOSAL_BYTES = 46


@dataclasses.dataclass(frozen=True)
class TriangulatorConfig:
    """Base + global line triangulator configuration (defaults of the
    reference's cfgs/triangulation/default.yaml)."""

    add_halfpix: bool = False
    use_vp: bool = False
    use_endpoints_triangulation: bool = False
    disable_many_points_triangulation: bool = False
    disable_one_point_triangulation: bool = False
    disable_algebraic_triangulation: bool = False
    disable_vp_triangulation: bool = False
    min_length_2d: float = 0.0
    line_tri_angle_threshold: float = 1.0
    IoU_threshold: float = 0.1
    sensitivity_threshold: float = 70.0
    var2d: float = 2.0
    fullscore_th: float = 1.0
    max_valid_conns: int = 1000
    min_num_outer_edges: int = 0
    merging_strategy: str = "greedy"
    num_outliers_aggregator: int = 2
    max_tris_per_node: int = 64
    linker2d: LineLinker2dConfig = dataclasses.field(
        default_factory=lambda: LineLinker2dConfig(
            th_angle=5.0, th_perp=2.0, th_overlap=0.05))
    linker3d: LineLinker3dConfig = dataclasses.field(
        default_factory=lambda: LineLinker3dConfig(
            th_angle=10.0, th_overlap=0.05, th_smartoverlap=0.1,
            th_smartangle=2.0, th_perp=1.0, th_innerseg=1.0,
            th_scaleinv=0.015))

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TriangulatorConfig":
        """Known fields of ``d``; the linkers come from its
        ``linker2d_config`` / ``linker3d_config`` entries."""
        d = dict(d or {})
        extra = {}
        for field, linker in (("linker2d", LineLinker2dConfig),
                              ("linker3d", LineLinker3dConfig)):
            d.pop(field, None)
            if field + "_config" in d:
                extra[field] = linker.from_dict(d[field + "_config"])
        return dataclass_from_dict(cls, d, **extra)


def bucket_program(cfg: TriangulatorConfig, L: int, K: int, T: int,
                   l2d_packed: torch.Tensor, cam_packed: torch.Tensor,
                   words: torch.Tensor, meta: torch.Tensor,
                   ranges=None, vp=None):
    """Triangulate, score and select over one group of G images: kernel
    F on the bucketed edge words, then kernel G.

    l2d_packed [I, L, 6] (sx, sy, ex, ey, ok, pad); cam_packed [I, 12]
    (kvec, qvec, tvec, pad); words [G, L, T] int32 edge words; meta
    [G, K + 1] int32 (neighbour rows, then the image's own row); vp
    [I, L, 4] (each line's VP, then 1 where it has one) or None.
    Returns floats [G, L, 10] (best start, end, depths, uncertainty,
    score) and ints [G, L, T + 1] (packed valid edges as global node
    ids, -1 padded, then their count).  With the VP banks G scores the
    B x T proposals of a line side by side, its words repeated once a
    bank.
    """
    tri, ok = tri_propose.propose(cfg, L, K, l2d_packed, cam_packed, words,
                                  meta, ranges, vp)
    B = ok.shape[1] // T if T else 1
    return tri_score.score(cfg, L, K, l2d_packed, cam_packed,
                           words.repeat(1, 1, B) if B > 1 else words, meta,
                           tri, ok, pack=T)


class GlobalLineTriangulator:
    """Image-incremental triangulator over kernels F and G.

      tri = GlobalLineTriangulator(cfg, device=...)
      tri.init(all_2d_segs, imagecols)
      tri.triangulate_all(matches_by_image)    # or, without a matcher,
      tri.triangulate_all_exhaustive(neighbors)
      batch = tri.compute_track_batch()        # or compute_line_tracks()

    ``triangulate_all_mesh(matches_by_image, mesh)`` splits
    ``triangulate_all``'s images over the ranks of a mesh.
    """

    def __init__(self, cfg: TriangulatorConfig = TriangulatorConfig(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ranges = None
        self.vp = None

    def init(self, all_2d_segs: Dict[int, np.ndarray],
             imagecols: ImageCollection) -> None:
        if not imagecols.IsUndistorted():
            raise ValueError("undistort images first")
        self.imagecols = imagecols
        self.img_ids = imagecols.get_img_ids()
        self.id2idx = imagecols.img_id_to_index()
        self.views = imagecols.batch(self.device)
        I = len(self.img_ids)
        L = shape_bucket(max((len(all_2d_segs[i]) for i in self.img_ids),
                             default=1))
        self.L = L
        lines = np.zeros((I, L, 4), np.float32)
        mask = np.zeros((I, L), bool)
        for row, img_id in enumerate(self.img_ids):
            segs = np.asarray(all_2d_segs[img_id], np.float32)
            if len(segs):
                lines[row, :len(segs)] = segs[:, :4]
                mask[row, :len(segs)] = True
        if self.cfg.add_halfpix:
            lines[mask] += 0.5
        self.lines2d = lines
        lengths = np.linalg.norm(lines[..., 2:4] - lines[..., :2], axis=-1)
        packed = np.zeros((I, L, 6), np.float32)
        packed[..., :4] = lines
        packed[..., 4] = mask & (lengths > self.cfg.min_length_2d)
        self._l2d_packed = torch.as_tensor(packed, device=self.device)
        vb = self.views
        self._cam_packed = torch.cat(
            [vb.kvec, vb.qvec, vb.tvec,
             torch.zeros((I, 1), device=self.device)], dim=1)
        self.n_lines = mask.sum(1)
        self.vp = None
        self._outs = []
        self._host = None
        self.overflow_edges = 0
        self.exhaustive_stats = None

    def set_ranges(self, ranges) -> None:
        if ranges is not None:
            self.ranges = tuple(
                torch.as_tensor(np.asarray(r), dtype=torch.float32,
                                device=self.device) for r in ranges)

    def init_vp_results(self, vpresults) -> None:
        """Each line's VP from {img_id: VPResult} (per-line labels and
        the image's VPs), as the [I, L, 4] table the VP banks read."""
        I, L = len(self.img_ids), self.L
        vp = np.zeros((I, L, 4), np.float32)
        for row, img_id in enumerate(self.img_ids):
            res = vpresults.get(img_id)
            if res is None:
                continue
            labels = np.asarray(res.labels)[:L]
            sel = labels >= 0
            vp[row, :len(labels)][sel, :3] = np.asarray(res.vps)[labels[sel]]
            vp[row, :len(labels)][sel, 3] = 1.0
        self.vp = torch.as_tensor(vp, device=self.device)

    def _banks(self) -> int:
        return len(tri_propose.banks(self.cfg, self.vp))

    # -------------------------------------------------------- bucketing
    def _gather_edges(self, rows: List[int], matches_list: List[dict]):
        """Per-image candidate edges (slot-major, stable), the global slot
        count K and the bucket width Tc."""
        L = self.L
        K = self._slot_count(matches_list)
        per_key, per_val, nbr_rows = [], [], []
        max_count = 1
        for matches in matches_list:
            neighbors = sorted(matches.keys())
            nbr_rows.append([self.id2idx[ng] for ng in neighbors])
            kk, vv = [], []
            for s_i, ng in enumerate(neighbors):
                m = np.asarray(matches[ng]).reshape(-1, 2)
                if not len(m):
                    continue
                kk.append(m[:, 0].astype(np.int64))
                vv.append((m[:, 1].astype(np.int32) << 7) | s_i)
            if kk:
                k = np.concatenate(kk)
                per_key.append(k)
                per_val.append(np.concatenate(vv))
                max_count = max(max_count,
                                int(np.bincount(k, minlength=L).max()))
            else:
                per_key.append(np.zeros(0, np.int64))
                per_val.append(np.zeros(0, np.int32))
        # bucket width: the cover of the most edges of a line, capped at
        # max_tris_per_node
        Tc = min(self.cfg.max_tris_per_node,
                 tri_propose.bucket_width(max_count))
        return per_key, per_val, nbr_rows, K, Tc

    @staticmethod
    def _slot_count(neighbor_lists) -> int:
        K = max((len(m) for m in neighbor_lists), default=1) or 1
        if K > 127:
            raise ValueError("at most 127 neighbours per image: the edge "
                             "word keeps the slot in 7 bits")
        return K

    def _meta(self, nbr_rows, rows, K):
        """[g, K + 1] int32: neighbour rows by slot (-1 padded), then the
        image's own row."""
        meta = np.full((len(rows), K + 1), -1, np.int32)
        for i, (nr, row) in enumerate(zip(nbr_rows, rows)):
            meta[i, :len(nr)] = nr
            meta[i, K] = row
        return meta

    def _fill_group(self, per_key, per_val, nbr_rows, rows, g0, g1, K, Tc):
        """Dense [g, L, Tc] edge words and [g, K + 1] meta for images
        [g0, g1)."""
        L = self.L
        g = g1 - g0
        kk = [per_key[i] + (i - g0) * L for i in range(g0, g1)]
        key = np.concatenate(kk) if kk else np.zeros(0, np.int64)
        vals = np.concatenate(per_val[g0:g1]) if g else np.zeros(0, np.int32)
        words, overflow = hostops.bucket_scene(key, vals, g * L, Tc)
        meta = self._meta(nbr_rows[g0:g1], rows[g0:g1], K)
        return words.reshape(g, L, Tc), meta, overflow

    def _groups(self, n: int, width: int):
        """Image ranges [g0, g1) holding at most GROUP_BYTES of proposal
        rows of bucket width ``width``, equalized over the groups."""
        per_img = self.L * max(width, 1) * PROPOSAL_BYTES
        size = int(max(1, min(n, GROUP_BYTES // per_img)))
        size = -(-n // -(-n // size)) if n else 1
        return [(g0, min(g0 + size, n)) for g0 in range(0, n, size)]

    def _device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ---------------------------------------------------- triangulation
    def _run_matched(self, rows, matches_list):
        """Kernel F form (a) + kernel G over groups of images; returns the
        outputs and the dropped edges."""
        per_key, per_val, nbr_rows, K, Tc = self._gather_edges(
            rows, matches_list)
        overflow = 0
        outs = []
        for g0, g1 in self._groups(len(rows), self._banks() * Tc):
            words, meta, ovf = self._fill_group(per_key, per_val, nbr_rows,
                                                rows, g0, g1, K, Tc)
            overflow += ovf
            floats, ints = bucket_program(
                self.cfg, self.L, K, Tc, self._l2d_packed, self._cam_packed,
                self._device(words), self._device(meta), self.ranges,
                self.vp)
            outs.append((rows[g0:g1], floats, ints))
        return outs, overflow

    def _record(self, outs, overflow, reset):
        if reset:
            self._outs = []
            self.overflow_edges = 0
        self._outs += outs
        self.overflow_edges += overflow
        self._host = None
        if overflow:
            warnings.warn(
                f"{overflow} candidate edges dropped by the "
                f"max_tris_per_node={self.cfg.max_tris_per_node} bucket; "
                f"raise it for full recall", stacklevel=3)

    def triangulate_all(self, matches_by_image: Dict[int, Dict[int,
                                                               np.ndarray]]
                        ) -> None:
        """Triangulate and score every image with matches, in groups of
        images sized by ``GROUP_BYTES``; the results stay on the device
        and replace earlier ones."""
        rows, matches_list = self._matched_rows(matches_by_image)
        if rows:
            self._record(*self._run_matched(rows, matches_list), reset=True)

    def _matched_rows(self, matches_by_image):
        """The rows of the images with matches, in image order, and their
        matches."""
        rows, matches_list = [], []
        for img_id in self.img_ids:
            m = matches_by_image.get(img_id)
            if m is not None:
                rows.append(self.id2idx[img_id])
                matches_list.append(m)
        return rows, matches_list

    def triangulate_all_mesh(self, matches_by_image, mesh,
                             axis: Optional[str] = None) -> None:
        """``triangulate_all`` with the images split over the ranks of a
        mesh (``parallel/mesh.py``): every image's edges are bucketed
        once, the rows padded to a multiple of d ranks by repeating the
        last one, and rank r runs kernels F and G on its contiguous block
        (in groups sized by ``GROUP_BYTES``).  A row's results depend on
        that row alone, so the per-node results, gathered in rank order
        without the padding, are the one-card call's, and every rank then
        builds the same tracks.  ``mesh`` None runs on this process's
        device alone; a mesh of more than one dimension needs ``axis``."""
        from limap_tpu_torch.parallel.mesh import (all_gather_rows, block,
                                                   rank_mesh)
        ranks = rank_mesh(mesh, axis)
        if ranks is None:
            return self.triangulate_all(matches_by_image)
        rows, matches_list = self._matched_rows(matches_by_image)
        if not rows:
            return
        per_key, per_val, nbr_rows, K, Tc = self._gather_edges(
            rows, matches_list)
        n = len(rows)
        words, meta, overflow = self._fill_group(per_key, per_val, nbr_rows,
                                                 rows, 0, n, K, Tc)
        d = ranks.size()
        m = -(-n // d)
        r = np.minimum(np.arange(m * d), n - 1)[block(m * d, ranks)]
        outs = []
        for g0, g1 in self._groups(m, self._banks() * Tc):
            outs.append(bucket_program(
                self.cfg, self.L, K, Tc, self._l2d_packed, self._cam_packed,
                self._device(words[r[g0:g1]]), self._device(meta[r[g0:g1]]),
                self.ranges, self.vp))
        floats = torch.cat([f for f, _ in outs])
        ints = torch.cat([i for _, i in outs])
        floats, ints = all_gather_rows(
            (floats, ints.view(torch.float32)), ranks)
        self._record([(rows, floats[:n], ints.view(torch.int32)[:n])],
                     overflow, reset=True)

    def triangulate_image(self, img_id: int,
                          matches: Dict[int, np.ndarray]) -> None:
        """Triangulate and score one image against its matched
        neighbours ({neighbour id: [M, 2] line pairs}); the result
        replaces the image's earlier one."""
        self._record(*self._run_matched([self.id2idx[img_id]], [matches]),
                     reset=False)

    def triangulate_image_exhaustive(self, img_id: int,
                                     neighbors: List[int]) -> None:
        """Every line of the image against every line of each neighbour
        (no matcher); the result replaces the image's earlier one."""
        self._record(*self._run_exhaustive({img_id: neighbors}),
                     reset=False)

    def triangulate_all_exhaustive(self, neighbors: Dict[int, List[int]]
                                   ) -> None:
        """The exhaustive matcher for every image of ``neighbors``
        ({img_id: [neighbour ids]}); the results replace earlier ones.
        ``exhaustive_stats`` keeps the candidate pairs and the survivors
        (total, largest a line) and the bucket width."""
        if any(i in neighbors for i in self.img_ids):
            self._record(*self._run_exhaustive(neighbors), reset=True)

    def _run_exhaustive(self, neighbors):
        """Kernel F writes its tables of the lines once, counts each
        (line, slot)'s survivors, the bucket takes the cover of the
        largest line's count (no cap, nothing dropped), then F writes the
        survivors at the slots' offsets and G scores them, in groups of
        images sized by ``GROUP_BYTES``; returns the outputs, their edge
        columns cut to the largest valid count (the bucket is as wide as
        the most survivors of a line, its valid edges far fewer), and no
        dropped edges."""
        tri_propose.check_exhaustive(self.cfg)
        ids = [i for i in self.img_ids if i in neighbors]
        rows = [self.id2idx[i] for i in ids]
        nbr_rows = [[self.id2idx[ng] for ng in sorted(neighbors[i])]
                    for i in ids]
        K = self._slot_count(nbr_rows)
        meta = self._device(self._meta(nbr_rows, rows, K))
        cfg, L = self.cfg, self.L
        # what depends on one line or image, once for both passes
        tables = tri_propose.exhaustive_tables(L, self._l2d_packed,
                                               self._cam_packed)
        slot_counts = tri_propose.count_exhaustive(
            cfg, L, K, self._l2d_packed, self._cam_packed, meta, self.ranges,
            per_slot=True, tables=tables)
        counts = tri_propose.slot_offsets(slot_counts)[1]
        max_count = int(counts.max())
        W = tri_propose.bucket_width(max_count)
        outs = []
        for g0, g1 in self._groups(len(rows), W):
            m = meta[g0:g1]
            words, tri, ok = tri_propose.propose_exhaustive(
                cfg, L, K, self._l2d_packed, self._cam_packed, m, W,
                self.ranges, slot_counts=slot_counts[g0 * L:g1 * L],
                tables=tables)
            floats, ints = tri_score.score(
                cfg, L, K, self._l2d_packed, self._cam_packed,
                words.reshape(g1 - g0, L, W), m, tri, ok)
            outs.append((rows[g0:g1], floats, ints))
        w = max([1] + [int(i[..., -1].max()) for _, _, i in outs
                       if i.numel()])
        outs = [(r, f, torch.cat([i[..., :w], i[..., -1:]], -1))
                for r, f, i in outs]
        n_lines = self.n_lines
        self.exhaustive_stats = {
            "candidate_pairs": int(sum(
                int(n_lines[r]) * int(sum(n_lines[nr])) for r, nr in
                zip(rows, nbr_rows))),
            "survivors_total": int(counts.sum()),
            "survivors_max": max_count, "bucket_width": W,
            "groups": len(outs)}
        return outs, 0

    def _tables(self):
        """Full [I, L, 10] float and [I, L, Tc + 1] int tables on the
        device, rows not triangulated left empty; a row triangulated
        twice keeps its last result."""
        I, L = len(self.img_ids), self.L
        Tc = max(ints.shape[-1] - 1 for _, _, ints in self._outs)
        floats_all = torch.zeros((I, L, 10), device=self.device)
        floats_all[..., 8] = 1e30
        floats_all[..., 9] = -1.0
        ints_all = torch.full((I, L, Tc + 1), -1, dtype=torch.int32,
                              device=self.device)
        ints_all[..., Tc] = 0
        for rows, floats, ints in self._outs:
            rsub = torch.as_tensor(rows, device=self.device)
            w = ints.shape[-1] - 1
            floats_all[rsub] = floats
            ints_all[rsub] = torch.cat([
                ints[..., :w],
                torch.full(ints.shape[:-1] + (Tc - w,), -1,
                           dtype=torch.int32, device=self.device),
                ints[..., w:]], -1)
        return floats_all, ints_all, Tc

    def host_state(self):
        """Host copies of the per-node results: (best_line3d [I, L, 2, 3],
        best_unc [I, L], best_score [I, L], valid_edge_ng [I, L, Tc],
        valid_edge_cnt [I, L])."""
        if self._host is None:
            floats, ints, Tc = self._tables()
            f = floats.cpu().numpy()
            i = ints.cpu().numpy()
            self._host = (f[..., 0:6].reshape(f.shape[:2] + (2, 3)),
                          f[..., 8], f[..., 9], i[..., :Tc], i[..., Tc])
        return self._host

    # ------------------------------------------------------- track build
    def _filter_by_num_outer_edges(self) -> np.ndarray:
        """Iterative degree filter on the valid-edge graph."""
        I, L = len(self.img_ids), self.L
        flags = np.ones(I * L, bool)
        if self.cfg.min_num_outer_edges <= 0:
            return flags
        _, _, _, dst, cnt = self.host_state()
        cnt = cnt.reshape(-1).copy()
        src = np.repeat(np.arange(I * L), dst.shape[-1])
        dst = dst.reshape(-1)
        ok = dst >= 0
        rev: Dict[int, List[int]] = {}
        for s, d in zip(src[ok], dst[ok]):
            rev.setdefault(int(d), []).append(int(s))
        from collections import deque
        q = deque()
        for node in range(I * L):
            if cnt[node] < self.cfg.min_num_outer_edges:
                flags[node] = False
                q.append(node)
        while q:
            node = q.popleft()
            for p in rev.get(node, ()):
                if not flags[p]:
                    continue
                cnt[p] -= 1
                if cnt[p] < self.cfg.min_num_outer_edges:
                    flags[p] = False
                    q.append(p)
        return flags

    def _cluster_labels_device(self):
        """Edge gate (3D linker on the best tris of both ends) and
        connected components on the device, over the filled edge slots
        only; the labels, the has-edge flags and the float table come to
        the host."""
        floats_all, ints_all, Tc = self._tables()
        N = floats_all.shape[0] * floats_all.shape[1]
        f = floats_all.reshape(N, 10)
        dst = ints_all.reshape(N, Tc + 1)[:, :Tc].long()
        src, col = torch.nonzero(dst >= 0, as_tuple=True)
        d = dst[src, col]
        # score the sorted pair, as the host path's undirected edge list
        # does (score_3d is not symmetric under uncertainty scaling)
        lo = torch.minimum(src, d)
        hi = torch.maximum(src, d)
        flo, fhi = f[lo], f[hi]
        escore = score_3d(
            Segments(flo[..., 0:3], flo[..., 3:6], uncertainty=flo[..., 8]),
            Segments(fhi[..., 0:3], fhi[..., 3:6], uncertainty=fhi[..., 8]),
            self.cfg.linker3d.to_spatial_merging())
        keep = (escore > 0) & (flo[..., 9] > 0) & (fhi[..., 9] > 0)
        labels = connected_components(N, torch.stack([src, d], 1), keep)
        has_edge = torch.zeros(N, dtype=torch.uint8, device=self.device)
        k8 = keep.to(torch.uint8)
        has_edge.scatter_reduce_(0, lo, k8, reduce="amax")
        has_edge.scatter_reduce_(0, hi, k8, reduce="amax")
        labels = labels.cpu().numpy().astype(np.int64)
        has_edge = has_edge.cpu().numpy().astype(bool)
        fh = f.cpu().numpy()
        if not has_edge.any():
            return None
        nodes = np.nonzero(has_edge)[0]
        # consumers only need degree > 0: self-edges for flagged nodes
        und = np.stack([nodes, nodes], 1)
        return labels, und, fh[:, 0:3], fh[:, 3:6], fh[:, 8], fh[:, 9]

    def _cluster_labels(self):
        """Valid undirected edges -> linker-gated edges -> node labels.
        Returns (labels, und, b_start, b_end, b_unc, b_score) or None.

        ``greedy`` (the default) is connected components; ``exhaustive``
        and ``avg`` are the host strategies of ``merging/strategies.py``
        over the gated edges sorted by score.  A node those strategies
        leave alone keeps a label of its own, so it forms no track (the
        JAX package gives all such nodes one shared label, which groups
        them into one track)."""
        strategy = self.cfg.merging_strategy
        if strategy not in ("greedy", "exhaustive", "avg"):
            raise ValueError(
                f"unknown merging_strategy {strategy!r}; expected "
                "'greedy', 'exhaustive' or 'avg'")
        if not self._outs:
            return None
        if self.cfg.min_num_outer_edges <= 0 and strategy == "greedy":
            return self._cluster_labels_device()
        best_line3d, b_unc, b_score, dst, _ = self.host_state()
        I, L = len(self.img_ids), self.L
        flags = self._filter_by_num_outer_edges()
        src = np.repeat(np.arange(I * L), dst.shape[-1])
        dst = dst.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        ok = flags[src] & flags[dst]
        und = np.unique(np.sort(np.stack([src[ok], dst[ok]], 1), axis=1),
                        axis=0)
        if len(und) == 0:
            return None
        b_start = best_line3d[..., 0, :].reshape(I * L, 3)
        b_end = best_line3d[..., 1, :].reshape(I * L, 3)
        b_unc = b_unc.reshape(I * L)
        b_score = b_score.reshape(I * L)
        t = self._device
        escore = score_3d(
            Segments(t(b_start[und[:, 0]]), t(b_end[und[:, 0]]),
                     uncertainty=t(b_unc[und[:, 0]])),
            Segments(t(b_start[und[:, 1]]), t(b_end[und[:, 1]]),
                     uncertainty=t(b_unc[und[:, 1]])),
            self.cfg.linker3d.to_spatial_merging()).cpu().numpy()
        keep = ((escore > 0) & (b_score[und[:, 0]] > 0)
                & (b_score[und[:, 1]] > 0))
        und, escore = und[keep], escore[keep]
        if len(und) == 0:
            return None
        if strategy == "greedy":
            labels = connected_components(
                I * L, t(und), torch.ones(len(und), dtype=torch.bool,
                                          device=self.device))
            labels = labels.cpu().numpy().astype(np.int64)
        else:
            nodes = np.unique(und.reshape(-1))
            remap = np.full(I * L, -1, np.int64)
            remap[nodes] = np.arange(len(nodes))
            fn = (compute_track_labels_avg if strategy == "avg"
                  else compute_track_labels_exhaustive)
            sub = fn(remap[und], escore,
                     np.stack([b_start[nodes], b_end[nodes]], axis=1),
                     nodes // L, self.cfg.linker3d)
            labels = np.arange(I * L)
            labels[nodes] = np.where(sub >= 0, I * L + sub, nodes)
        return labels, und, b_start, b_end, b_unc, b_score

    def _grouped_nodes(self, labels, und):
        """Nodes with >= 1 valid edge sorted by label, keeping components
        of >= 2 nodes: (nodes, track_of)."""
        I, L = len(self.img_ids), self.L
        deg = np.zeros(I * L, np.int64)
        np.add.at(deg, und.reshape(-1), 1)
        node_ids = np.nonzero(deg > 0)[0]
        lab = labels[node_ids]
        order = np.argsort(lab, kind="stable")
        node_ids, lab = node_ids[order], lab[order]
        _, inv, counts = np.unique(lab, return_inverse=True,
                                   return_counts=True)
        keep_grp = counts >= 2
        new_idx = np.cumsum(keep_grp) - 1
        keep = keep_grp[inv]
        return node_ids[keep], new_idx[inv[keep]].astype(np.int64)

    def compute_track_batch(self, return_host: bool = False):
        """Tracks straight into a padded :class:`TrackBatch` with the
        aggregated line.  None when there are no tracks; with
        ``return_host`` (batch, HostTrackBatch mirror)."""
        res = self._cluster_labels()
        if res is None:
            return (None, None) if return_host else None
        labels, und, b_start, b_end, b_unc, b_score = res
        nodes, track_of = self._grouped_nodes(labels, und)
        if not len(nodes):
            return (None, None) if return_host else None
        L = self.L
        l2 = self.lines2d.reshape(-1, 4)
        img_ids_arr = np.asarray(self.img_ids)
        rows = nodes // L
        batch, (ti, si), *rest = batch_from_flat_supports(
            track_of, rows.astype(np.int32),
            img_ids_arr[rows].astype(np.int32), (nodes % L).astype(np.int32),
            l2[nodes].reshape(-1, 2, 2),
            np.stack([b_start[nodes], b_end[nodes]], 1),
            b_score[nodes].astype(np.float32),
            num_tracks=int(track_of[-1]) + 1, return_slots=True,
            return_host=return_host, device=self.device)
        # aggregation with the triangulation uncertainty
        u_pad = np.ones(batch.mask.shape, np.float32)
        u_pad[ti, si] = b_unc[nodes]
        seg3d = batch.line3d._replace(uncertainty=self._device(u_pad))
        agg = aggregate_tracks(seg3d, batch.score, batch.mask,
                               self.cfg.num_outliers_aggregator)
        batch = batch._replace(line=agg)
        return (batch, rest[0]) if return_host else batch

    def compute_line_tracks(self) -> List[LineTrack]:
        """Host :class:`LineTrack` objects: each track's supports (image,
        line, 2D segment, best proposal, score, node id) and its line
        aggregated with the triangulation uncertainty."""
        res = self._cluster_labels()
        if res is None:
            return []
        labels, und, b_start, b_end, b_unc, b_score = res
        nodes, track_of = self._grouped_nodes(labels, und)
        if not len(nodes):
            return []
        L = self.L
        groups = np.split(nodes, np.nonzero(np.diff(track_of))[0] + 1)
        l2 = self.lines2d.reshape(-1, 2, 2)
        img_ids_arr = np.asarray(self.img_ids)
        tracks = [LineTrack(
            image_id_list=[int(img_ids_arr[n // L]) for n in g],
            line_id_list=[int(n % L) for n in g],
            line2d_list=[l2[n] for n in g],
            line3d_list=[np.stack([b_start[n], b_end[n]]) for n in g],
            score_list=[float(b_score[n]) for n in g],
            node_id_list=[int(n) for n in g]) for g in groups]
        batch = tracks_to_batch(tracks, self.id2idx, device=self.device)
        u_pad = np.ones(batch.mask.shape, np.float32)
        for gi, g in enumerate(groups):
            n = min(len(g), u_pad.shape[1])
            u_pad[gi, :n] = b_unc[g[:n]]
        seg3d = batch.line3d._replace(uncertainty=self._device(u_pad))
        agg = aggregate_tracks(seg3d, batch.score, batch.mask,
                               self.cfg.num_outliers_aggregator)
        agg_s, agg_e = agg.start.cpu().numpy(), agg.end.cpu().numpy()
        for i, tr in enumerate(tracks):
            tr.line = np.stack([agg_s[i], agg_e[i]])
        return tracks
