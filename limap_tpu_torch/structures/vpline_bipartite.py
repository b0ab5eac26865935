"""VP-line bipartite structures: per image between its VPs and its 2D
lines, and across views between VP tracks and line tracks."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from limap_tpu_torch.structures.pl_bipartite import PL_BipartiteBase
from limap_tpu_torch.vplib.jlinkage import VPResult
from limap_tpu_torch.vplib.vptrack import VPTrack


class VPLine_Bipartite2d(PL_BipartiteBase):
    """Per-image bipartite between VPs ('points') and 2D lines."""

    @classmethod
    def from_vpresult(cls, vpresult: VPResult,
                      n_lines: int) -> "VPLine_Bipartite2d":
        bpt = cls()
        for vp_id in range(vpresult.count_vps()):
            bpt.add_point(vpresult.GetVPbyCluster(vp_id), vp_id, [])
        for line_id in range(min(n_lines, vpresult.count_lines())):
            bpt.add_line(line_id, line_id)
            if vpresult.HasVP(line_id):
                vp_id = vpresult.GetVPLabel(line_id)
                bpt.np2l[vp_id].append(line_id)
                bpt.nl2p[line_id].append(vp_id)
        return bpt


class VPLine_Bipartite3d(PL_BipartiteBase):
    """Bipartite between VP tracks and line tracks."""

    @classmethod
    def from_weights(cls, vptracks: List[VPTrack], linetracks,
                     vpl_weights: Dict) -> "VPLine_Bipartite3d":
        bpt = cls()
        for v_id, t in enumerate(vptracks):
            bpt.add_point(t, v_id, [])
        for l_id, t in enumerate(linetracks):
            bpt.add_line(t, l_id)
        for (v_id, l_id), _ in vpl_weights.items():
            bpt.np2l[v_id].append(l_id)
            bpt.nl2p[l_id].append(v_id)
        return bpt


def get_all_bipartites_vpline2d(all_2d_segs: Dict[int, np.ndarray],
                                vpresults: Dict[int, VPResult]
                                ) -> Dict[int, VPLine_Bipartite2d]:
    """The VP-line bipartite of every image that has a VP result."""
    return {img_id: VPLine_Bipartite2d.from_vpresult(
        vpresults[img_id], len(segs))
        for img_id, segs in all_2d_segs.items() if img_id in vpresults}
