"""The joint hybrid BA driver (points + lines + poses).

Counterpart of the reference's ``optimize.solve_hybrid_bundle_adjustment``
front door (HybridBAEngine): packs an ImageCollection, point tracks and
line tracks into the BA state (``parallel/sharded_ba.py``), runs LM steps
with the host's accept/reject loop, and unpacks the updated poses, points
and the re-trimmed line segments.  Over a mesh of d ranks the track rows
are padded to a multiple of d with weight 0, every rank runs the same
loop on the same summed costs, and every rank returns what the one-card
call returns.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.base.infinite_line import MinimalInfiniteLines3d
from limap_tpu_torch.base.lines import Segments
from limap_tpu_torch.base.linetrack import (LineTrack, batch_to_tracks,
                                            tracks_to_batch)
from limap_tpu_torch.optimize.line_ba import (get_output_tracks,
                                              pack_minimal_lines,
                                              unpack_minimal_lines)
from limap_tpu_torch.parallel.mesh import (mesh_size, pad_to_multiple,
                                           rank_mesh)
from limap_tpu_torch.parallel.sharded_ba import (HybridBAOptions,
                                                 HybridBAState,
                                                 make_hybrid_ba_cost,
                                                 make_hybrid_ba_step)


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` with zero rows appended up to ``n`` rows."""
    if a.shape[0] == n:
        return a
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def pack_point_tracks(pointtracks: Sequence, id2row):
    """Point tracks -> (xyz [Tp, 3], img_index, p2d [Tp, Sp, 2], weight),
    Sp the longest track (at least 1), Tp at least 1; supports in images
    outside ``id2row`` get weight 0."""
    Sp = max(max((len(t.image_id_list) for t in pointtracks), default=1), 1)
    Tp = max(len(pointtracks), 1)
    xyz = np.zeros((Tp, 3), np.float32)
    ii_p = np.zeros((Tp, Sp), np.int32)
    p2d = np.zeros((Tp, Sp, 2), np.float32)
    w_p = np.zeros((Tp, Sp), np.float32)
    for ti, t in enumerate(pointtracks):
        xyz[ti] = np.asarray(t.p)
        for si, (img_id, pt) in enumerate(
                zip(t.image_id_list[:Sp], t.p2d_list[:Sp])):
            if img_id not in id2row:
                continue
            ii_p[ti, si] = id2row[img_id]
            p2d[ti, si] = np.asarray(pt)[:2]
            w_p[ti, si] = 1.0
    return xyz, ii_p, p2d, w_p


def solve_hybrid_bundle_adjustment(
        imagecols, pointtracks: Sequence, linetracks: List[LineTrack],
        opts: HybridBAOptions = HybridBAOptions(),
        mesh=None, n_iterations: int = 20,
        num_outliers_aggregator: int = 2, device=None):
    """Jointly optimize camera poses, 3D points and 3D lines.

    pointtracks: PointTrack-like objects with ``p`` ([3]),
    ``image_id_list`` and ``p2d_list``.  Returns (new_imagecols,
    new_points [P, 3], new_linetracks, costs list).  ``mesh``: None (one
    card) or a ``DeviceMesh`` of ranks (``parallel.make_mesh()``).
    """
    from limap_tpu_torch.base.camera import CameraPose
    from limap_tpu_torch.base.image_collection import (CameraImage,
                                                       ImageCollection)

    mesh = rank_mesh(mesh)
    d = mesh_size(mesh)
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(a, device=device)
    id2row = imagecols.img_id_to_index()
    views = imagecols.batch(device="cpu")
    nv = len(imagecols.get_img_ids())
    cam_ids = sorted(imagecols.cameras.keys())
    cam2row = {c: i for i, c in enumerate(cam_ids)}
    img_cam_row = np.asarray(
        [cam2row[imagecols.images[i].cam_id]
         for i in imagecols.get_img_ids()], np.int32)
    kvec_all = np.asarray(views.kvec, np.float32)     # [I, 4]
    pose_params = t(np.concatenate(
        [np.asarray(views.qvec), np.asarray(views.tvec)],
        axis=1).astype(np.float32))
    cam_fxfy = t(np.stack([kvec_all[np.where(img_cam_row == c)[0][0], :2]
                           if np.any(img_cam_row == c) else np.ones(2)
                           for c in range(len(cam_ids))]).astype(np.float32))

    # ---- line tracks -> padded [Tl, S] arrays, rows a multiple of d
    batch = tracks_to_batch(linetracks, id2row, device=device)
    Tl = len(linetracks)
    Tb = batch.mask.shape[0]
    pad = lambda a: _pad_rows(a, pad_to_multiple(Tb, d))
    img_index_l = pad(batch.img_index.cpu()).numpy().astype(np.int32)
    line_params = pack_minimal_lines(MinimalInfiniteLines3d.from_segments(
        Segments(pad(batch.line.start.float()),
                 pad(batch.line.end.float()) + 1e-6)))
    line_data = (t(kvec_all[img_index_l]), t(img_cam_row[img_index_l]),
                 t(img_index_l), pad(batch.line2d.start.float()),
                 pad(batch.line2d.end.float()), pad(batch.mask.float()))

    # ---- point tracks -> padded [Tp, Sp] arrays, rows a multiple of d
    xyz, ii_p, p2d, w_p = pack_point_tracks(pointtracks, id2row)
    pad = lambda a: _pad_rows(t(a), pad_to_multiple(len(xyz), d))
    point_data = (pad(kvec_all[ii_p]), pad(img_cam_row[ii_p]), pad(ii_p),
                  pad(p2d), pad(w_p))

    state = HybridBAState(line_params, pad(xyz), pose_params, cam_fxfy)
    step = make_hybrid_ba_step(mesh, nv, len(cam_ids), opts, device)
    cost_fn = make_hybrid_ba_cost(mesh, opts, device)
    # Levenberg-Marquardt accept/reject with adaptive damping (the
    # reference's Ceres solver is trust-region too): a fixed-damping
    # iteration can oscillate on ill-conditioned ragged problems
    lam = opts.damping
    cost_cur = float(cost_fn(state, line_data, point_data))
    costs = [cost_cur]
    # the supports do not change during the solve: kernel O's index once
    index = step.index(line_data, point_data)
    for _ in range(n_iterations):
        cand, _ = step(state, line_data, point_data, lam, index=index)
        cost_new = float(cost_fn(cand, line_data, point_data))
        if cost_new < cost_cur:
            state, cost_cur = cand, cost_new
            lam = max(lam / 3.0, 1e-6)
        else:
            lam = min(lam * 10.0, 1e3)
        costs.append(cost_cur)

    # ---- unpack: new poses -> ImageCollection
    new_pose = state.pose_params.cpu().numpy()
    new_images = {}
    for i, img_id in enumerate(imagecols.get_img_ids()):
        im = imagecols.images[img_id]
        q = new_pose[i, :4]
        q = q / (np.linalg.norm(q) + 1e-12)
        new_images[img_id] = CameraImage(
            im.cam_id, CameraPose(qvec=q, tvec=new_pose[i, 4:7]),
            im.image_name)
    new_imagecols = ImageCollection(dict(imagecols.cameras), new_images)

    # ---- new line segments: re-trim with the UPDATED views
    new_views = new_imagecols.batch(device=device)
    refined = unpack_minimal_lines(state.line_params[:Tb])
    out_batch = get_output_tracks(batch, new_views, refined,
                                  num_outliers_aggregator)
    new_linetracks = batch_to_tracks(out_batch)[:Tl]

    new_points = state.point_params.cpu().numpy()[:len(pointtracks)]
    return new_imagecols, new_points, new_linetracks, costs
