"""Global multi-view line triangulator: bucketed proposals, scoring and
track building.

Every image's candidate match edges are bucketed on the host into up to
``Tc`` slots per line (``[G, L, Tc]`` int32 edge words, ``(b << 7) |
slot``, -1 = empty).  One bucket program per group of images then
triangulates every (line, edge) pair, scores all pairs of proposals of a
line against each other (``[TT, TT, N]``, the reference's O(tris^2)
loop), keeps one support per neighbour image, picks the best proposal
per line and packs its valid edges.  Results stay on the device until
the clustering step (edge gate + connected components) has run.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base import line_geometry as lgeo
from limap_tpu_torch.base.camera import CameraViewsBatch
from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.base.line_linker import (LineLinker2dConfig,
                                              LineLinker3dConfig, score_2d,
                                              score_3d)
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import batch_from_flat_supports
from limap_tpu_torch.merging.aggregator import aggregate_tracks
from limap_tpu_torch.ops import hostops
from limap_tpu_torch.ops.connected_components import connected_components
from limap_tpu_torch.triangulation import functions as trifun
from limap_tpu_torch.util import shape_bucket

# bytes of [L, TT, TT] scoring intermediates one bucket program may keep
# alive; eager torch holds every intermediate of score_3d/score_2d of a
# group at once, so this bounds the images per group
GROUP_BYTES = 2e9


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


def bucket_program(cfg: TriangulatorConfig, L: int, K: int, T: int,
                   l2d_packed: torch.Tensor, cam_packed: torch.Tensor,
                   words: torch.Tensor, meta: torch.Tensor,
                   ranges=None):
    """Triangulate, score and select over one group of G images.

    l2d_packed [I, L, 6] (sx, sy, ex, ey, ok, pad); cam_packed [I, 12]
    (kvec, qvec, tvec, pad); words [G, L, T] int32 edge words; meta
    [G, K + 1] int32 (neighbour rows, then the image's own row).
    Returns floats [G, L, 10] (best start, end, depths, uncertainty,
    score) and ints [G, L, T + 1] (packed valid edges as global node
    ids, -1 padded, then their count).
    """
    if cfg.use_vp and not cfg.disable_vp_triangulation:
        raise NotImplementedError("VP triangulation is not ported yet")
    if cfg.disable_algebraic_triangulation:
        raise NotImplementedError(
            "only the algebraic / endpoint proposal bank is ported")
    G = words.shape[0]
    N = G * L
    I = cam_packed.shape[0]
    dev = words.device
    l2d_flat = l2d_packed.reshape(I * L, 6)
    nbr_table = meta[:, :K].long()                              # [G, K]
    row_ids = meta[:, K].long()                                 # [G]

    word = words.reshape(N, T)
    tvalid = word >= 0
    w = torch.clamp(word, min=0)
    b = (w >> 7).long()
    slot = (w & 0x7F).long()

    g_ids = torch.arange(G, device=dev).repeat_interleave(L)    # [N]
    ng_row = nbr_table.reshape(G * K)[
        g_ids[:, None] * K + torch.clamp(slot, 0, K - 1)]
    ng_row = torch.clamp(ng_row, min=0)                         # [N, T]
    own = l2d_packed[row_ids].reshape(N, 6)
    nb = l2d_flat[ng_row * L + b]                               # [N, T, 6]
    cam1 = cam_packed[row_ids].repeat_interleave(L, 0)[:, None]  # [N, 1, 12]
    cam2 = cam_packed[ng_row]                                   # [N, T, 12]
    l1 = Segments(own[:, None, 0:2], own[:, None, 2:4])
    l2 = Segments(nb[..., 0:2], nb[..., 2:4])
    v1 = CameraViewsBatch(cam1[..., 0:4], cam1[..., 4:8], cam1[..., 8:11])
    v2 = CameraViewsBatch(cam2[..., 0:4], cam2[..., 4:8], cam2[..., 8:11])
    valid = tvalid & (own[:, None, 4] > 0.5) & (nb[..., 4] > 0.5)

    # degeneracy: ray-plane angles, epipolar IoU, sensitivity
    n2 = trifun.get_normal_direction(l2, v2)

    def ray_angle(p):
        c = torch.abs(torch.sum(n2 * v1.ray_direction(p), -1))
        return 90.0 - torch.rad2deg(torch.arccos(torch.clamp(c, 0, 1)))

    ok = ((ray_angle(l1.start) >= cfg.line_tri_angle_threshold)
          & (ray_angle(l1.end) >= cfg.line_tri_angle_threshold))
    ok = ok & (trifun.compute_epipolar_iou(l1, v1, l2, v2)
               >= cfg.IoU_threshold)
    if cfg.use_endpoints_triangulation:
        tri = trifun.triangulate_line_by_endpoints(l1, v1, l2, v2)
    else:
        tri = trifun.triangulate_line_algebraic(l1, v1, l2, v2)
    s1 = lgeo.sensitivity(tri, v1)
    s2 = lgeo.sensitivity(tri, v2)
    ok = ok & ~((s1 > cfg.sensitivity_threshold)
                & (s2 > cfg.sensitivity_threshold))
    tri_ok = ok & valid & (tri.score > 0)
    if ranges is not None:
        tri_ok = tri_ok & trifun.test_line_inside_ranges(tri, ranges)
    tri_unc = torch.minimum(lgeo.compute_uncertainty(tri, v1, cfg.var2d),
                            lgeo.compute_uncertainty(tri, v2, cfg.var2d))
    TT = T
    tri_start, tri_end, tri_depths = tri.start, tri.end, tri.depths

    # scoring: [TT, TT, N] pairwise min(3D, 2D) linker, N minor
    tS = tri_start.transpose(0, 1)                      # [TT, N, 3]
    tE = tri_end.transpose(0, 1)
    tD = tri_depths.transpose(0, 1)
    tU = tri_unc.T                                      # [TT, N]
    tOK = tri_ok.T
    slotT = slot.T
    l_i = Segments(tS[:, None], tE[:, None], depths=tD[:, None],
                   uncertainty=tU[:, None])             # [TT, 1, N]
    l_j = Segments(tS[None], tE[None], depths=tD[None],
                   uncertainty=tU[None])                # [1, TT, N]
    s3d = score_3d(l_i, l_j, cfg.linker3d.to_shared_parent_scoring())
    # 2D: project tri_i into tri_j's neighbour view, compare with tri_j's
    # matched 2D segment
    vj = CameraViewsBatch(v2.kvec.transpose(0, 1)[None],
                          v2.qvec.transpose(0, 1)[None],
                          v2.tvec.transpose(0, 1)[None])  # [1, TT, N]
    proj = lgeo.project_segments(Segments(tS[:, None], tE[:, None]), vj)
    s2d = score_2d(proj, Segments(l2.start.transpose(0, 1)[None],
                                  l2.end.transpose(0, 1)[None]),
                   cfg.linker2d)
    s = torch.minimum(s3d, s2d)
    del s3d, s2d, proj
    # pairs sharing a slot (the diagonal included) never support
    pair_ok = tOK[:, None] & tOK[None] & (slotT[:, None] != slotT[None])
    s = torch.where(pair_ok, s, torch.zeros_like(s))
    # one support per neighbour image: max per (i, slot of j), then the
    # sum over the K slots in slot order
    per_slot = torch.zeros((TT, K, N), dtype=s.dtype, device=dev)
    per_slot.scatter_reduce_(1, slotT[None].expand(TT, TT, N), s,
                             reduce="amax", include_self=True)
    scoresT = torch.zeros((TT, N), dtype=s.dtype, device=dev)
    for k in range(K):
        scoresT = scoresT + per_slot[:, k]
    scores = torch.where(tri_ok, scoresT.T, torch.full_like(tri_unc, -1.0))

    # best tri (first on ties) + packed valid edges
    r = torch.arange(N, device=dev)
    best = torch.argmax(scores, dim=1)
    has_any = tri_ok[r, best]
    best_unc = torch.where(has_any, tri_unc[r, best],
                           torch.full_like(tri_unc[:, 0], 1e30))
    best_score = torch.where(has_any, scores[r, best],
                             torch.full_like(tri_unc[:, 0], -1.0))
    valid_e = tri_ok & (scores >= cfg.fullscore_th)
    if cfg.max_valid_conns < TT:
        rank = torch.argsort(torch.argsort(-scores, dim=1, stable=True),
                             dim=1, stable=True)
        valid_e = valid_e & (rank < cfg.max_valid_conns)
    ng_global = ng_row * L + b
    cnt = torch.clamp(valid_e.sum(1), max=T)
    # stable pack of the valid edges; argsort of a bool is not defined
    # stably, so sort the int view
    pack_order = torch.argsort((~valid_e).to(torch.int32), dim=1,
                               stable=True)
    packed = torch.gather(ng_global, 1, pack_order[:, :T])
    padded = torch.where(torch.arange(T, device=dev)[None] < cnt[:, None],
                         packed, torch.full_like(packed, -1))
    floats = torch.cat([tri_start[r, best], tri_end[r, best],
                        tri_depths[r, best], best_unc[:, None],
                        best_score[:, None]], dim=1).reshape(G, L, 10)
    ints = torch.cat([padded, cnt[:, None]], dim=1).to(
        torch.int32).reshape(G, L, T + 1)
    return floats, ints


class GlobalLineTriangulator:
    """Image-incremental triangulator over bucketed batch programs.

      tri = GlobalLineTriangulator(cfg, device=...)
      tri.init(all_2d_segs, imagecols)
      tri.triangulate_all(matches_by_image)
      batch = tri.compute_track_batch()
    """

    def __init__(self, cfg: TriangulatorConfig = TriangulatorConfig(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ranges = None

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
        self._dev_results = None
        self._host = None

    def set_ranges(self, ranges) -> None:
        if ranges is not None:
            self.ranges = tuple(
                torch.as_tensor(np.asarray(r), dtype=torch.float32,
                                device=self.device) for r in ranges)

    # -------------------------------------------------------- bucketing
    def _gather_edges(self, rows: List[int], matches_list: List[dict]):
        """Per-image candidate edges (slot-major, stable), the global slot
        count K and the bucket width Tc."""
        T = self.cfg.max_tris_per_node
        L = self.L
        K = max((len(m) for m in matches_list), default=1) or 1
        if K > 127:
            raise ValueError("at most 127 neighbours per image: the edge "
                             "word keeps the slot in 7 bits")
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
        # bucket width: the next multiple of 8 covering the most edges of
        # a line (2 / 4 for tiny scenes), capped at max_tris_per_node
        if max_count <= 2:
            Tc = 2
        elif max_count <= 4:
            Tc = 4
        else:
            Tc = int(8 * ((max_count + 7) // 8))
        return per_key, per_val, nbr_rows, K, min(T, Tc)

    def _fill_group(self, per_key, per_val, nbr_rows, rows, g0, g1, K, Tc):
        """Dense [g, L, Tc] edge words and [g, K + 1] meta for images
        [g0, g1)."""
        L = self.L
        g = g1 - g0
        kk = [per_key[i] + (i - g0) * L for i in range(g0, g1)]
        key = np.concatenate(kk) if kk else np.zeros(0, np.int64)
        vals = np.concatenate(per_val[g0:g1]) if g else np.zeros(0, np.int32)
        words, overflow = hostops.bucket_scene(key, vals, g * L, Tc)
        meta = np.full((g, K + 1), -1, np.int32)
        for i in range(g0, g1):
            nr = nbr_rows[i]
            meta[i - g0, :len(nr)] = nr
            meta[i - g0, K] = rows[i]
        return words.reshape(g, L, Tc), meta, overflow

    # ---------------------------------------------------- triangulation
    def triangulate_all(self, matches_by_image: Dict[int, Dict[int,
                                                               np.ndarray]]
                        ) -> None:
        """Triangulate and score every image, in groups of images sized
        by ``GROUP_BYTES``; the results stay on the device."""
        rows, matches_list = [], []
        for img_id in self.img_ids:
            m = matches_by_image.get(img_id)
            if m is None:
                continue
            rows.append(self.id2idx[img_id])
            matches_list.append(m)
        if not rows:
            return
        per_key, per_val, nbr_rows, K, Tc = self._gather_edges(
            rows, matches_list)
        n = len(rows)
        # as many images as GROUP_BYTES of [L, TT, TT] intermediates
        # allow, equalized over the groups
        per_img = self.L * (Tc * Tc) * 4 * 12
        group_size = int(max(1, min(n, GROUP_BYTES // max(per_img, 1))))
        n_groups = -(-n // group_size)
        group_size = -(-n // n_groups)
        overflow = 0
        outs = []
        for g0 in range(0, n, group_size):
            g1 = min(g0 + group_size, n)
            words, meta, ovf = self._fill_group(per_key, per_val, nbr_rows,
                                                rows, g0, g1, K, Tc)
            overflow += ovf
            floats, ints = bucket_program(
                self.cfg, self.L, K, Tc, self._l2d_packed, self._cam_packed,
                torch.as_tensor(words, device=self.device),
                torch.as_tensor(meta, device=self.device), self.ranges)
            outs.append((rows[g0:g1], floats, ints))
        self.overflow_edges = overflow
        if overflow:
            warnings.warn(
                f"{overflow} candidate edges dropped by the "
                f"max_tris_per_node={self.cfg.max_tris_per_node} bucket; "
                f"raise it for full recall", stacklevel=2)
        self._dev_results = (outs, Tc)
        self._host = None

    def _tables(self):
        """Full [I, L, 10] float and [I, L, Tc + 1] int tables on the
        device, rows not triangulated left empty."""
        outs, Tc = self._dev_results
        I, L = len(self.img_ids), self.L
        floats_all = torch.zeros((I, L, 10), device=self.device)
        floats_all[..., 8] = 1e30
        floats_all[..., 9] = -1.0
        ints_all = torch.full((I, L, Tc + 1), -1, dtype=torch.int32,
                              device=self.device)
        ints_all[..., Tc] = 0
        for rows, floats, ints in outs:
            rsub = torch.as_tensor(rows, device=self.device)
            floats_all[rsub] = floats
            ints_all[rsub] = ints
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
        connected components on the device; only the labels, the
        has-edge flags and the float table come to the host."""
        floats_all, ints_all, Tc = self._tables()
        N = floats_all.shape[0] * floats_all.shape[1]
        f = floats_all.reshape(N, 10)
        dst = ints_all.reshape(N, Tc + 1)[:, :Tc].long()
        valid = dst >= 0
        d = torch.clamp(dst, min=0)
        src = torch.arange(N, device=self.device)[:, None].expand(N, Tc)
        # score the sorted pair, as the host path's undirected edge list
        # does (score_3d is not symmetric under uncertainty scaling)
        lo = torch.minimum(src, d)
        hi = torch.maximum(src, d)
        flo, fhi = f[lo], f[hi]
        escore = score_3d(
            Segments(flo[..., 0:3], flo[..., 3:6], uncertainty=flo[..., 8]),
            Segments(fhi[..., 0:3], fhi[..., 3:6], uncertainty=fhi[..., 8]),
            self.cfg.linker3d.to_spatial_merging())
        keep = valid & (escore > 0) & (flo[..., 9] > 0) & (fhi[..., 9] > 0)
        edges = torch.stack([src.reshape(-1), d.reshape(-1)], 1)
        keep_f = keep.reshape(-1)
        labels = connected_components(N, edges, keep_f)
        has_edge = torch.zeros(N, dtype=torch.uint8, device=self.device)
        k8 = keep_f.to(torch.uint8)
        has_edge.scatter_reduce_(0, lo.reshape(-1), k8, reduce="amax")
        has_edge.scatter_reduce_(0, hi.reshape(-1), k8, reduce="amax")
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
        Returns (labels, und, b_start, b_end, b_unc, b_score) or None."""
        if self._dev_results is None:
            return None
        if self.cfg.merging_strategy != "greedy":
            raise NotImplementedError(
                f"merging_strategy {self.cfg.merging_strategy!r} is not "
                "ported yet; only 'greedy' is")
        if self.cfg.min_num_outer_edges <= 0:
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
        t = lambda a: torch.as_tensor(a, device=self.device)
        escore = score_3d(
            Segments(t(b_start[und[:, 0]]), t(b_end[und[:, 0]]),
                     uncertainty=t(b_unc[und[:, 0]])),
            Segments(t(b_start[und[:, 1]]), t(b_end[und[:, 1]]),
                     uncertainty=t(b_unc[und[:, 1]])),
            self.cfg.linker3d.to_spatial_merging()).cpu().numpy()
        keep = ((escore > 0) & (b_score[und[:, 0]] > 0)
                & (b_score[und[:, 1]] > 0))
        und = und[keep]
        if len(und) == 0:
            return None
        e = t(und)
        labels = connected_components(
            I * L, e, torch.ones(len(und), dtype=torch.bool,
                                 device=self.device))
        return (labels.cpu().numpy().astype(np.int64), und, b_start, b_end,
                b_unc, b_score)

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
            num_tracks=int(track_of[-1]) + 1, return_slots=True, return_host=return_host, device=self.device)
        # aggregation with the triangulation uncertainty
        u_pad = np.ones(batch.mask.shape, np.float32)
        u_pad[ti, si] = b_unc[nodes]
        seg3d = batch.line3d._replace(
            uncertainty=torch.as_tensor(u_pad, device=self.device))
        agg = aggregate_tracks(seg3d, batch.score, batch.mask,
                               self.cfg.num_outliers_aggregator)
        batch = batch._replace(line=agg)
        return (batch, rest[0]) if return_host else batch
