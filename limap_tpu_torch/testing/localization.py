"""Localization queries on the rendered scene of
:mod:`limap_tpu_torch.testing.pipeline`: the inputs that ``chip_smoke.py``
gives the port's ``hybrid_localization`` and that
``tests/torch_port_reference_gates.py --localize`` gives the JAX
package's, drawn identically for both.

A query is a view rendered by the scene's own rasteriser halfway between
two database views on the ring ((k + 0.5) / n_views), from a generator
seeded apart from the scene's, so the database images are unchanged.
Its prior is the true pose turned by 0.01 rad and shifted by 5 cm on
each axis; its retrieval the 10 database views nearest by camera centre;
its point matches 1000 points of the wall seen in it, with 0.5 px noise
and 30 % of them outliers moved by 50-200 px.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation

from limap_tpu_torch.base.camera import CameraPose
from limap_tpu_torch.base.image_collection import CameraImage, ImageCollection
from limap_tpu_torch.testing.pipeline import WALL_Z, render_view, ring_pose

QUERY_SEED = 1234
N_POINTS = 1000
OUTLIER_RATIO = 0.3
N_RETRIEVED = 10


def query_ids(n_queries: int, n_views: int = 100):
    """Ring positions k = 0, 10, ... (every tenth gap); the query's image
    id is 1000 + k."""
    step = max(n_views // 10, 1)
    return [1000 + k for k in range(0, n_views, step)][:n_queries]


def wall_points(K, R, t, hw, n, rng):
    """n points of the wall plane z = WALL_Z seen at uniform pixels of a
    view (R, t)."""
    h, w = hw
    px = rng.uniform([0.0, 0.0], [w, h], size=(n, 2))
    rays = np.c_[px, np.ones(n)] @ np.linalg.inv(K).T @ R    # R^T K^-1 x
    C = -R.T @ t
    s = (WALL_Z - C[2]) / rays[:, 2]
    return C + s[:, None] * rays


def build_queries(scene, n_queries: int = 10, image_dir=None,
                  ext: str = ".npy", seed: int = QUERY_SEED):
    """The queries of a :func:`pipeline.build_scene` scene.

    Returns a dict: ``imagecols`` (the queries with their priors, images
    saved as ``img_{id}{ext}`` under ``image_dir`` when given), ``gt``
    {id: CameraPose}, ``imgs`` {id: uint8 [H, W]}, ``points`` {id: (p3ds
    [N, 3], p2ds [N, 2])} and ``retrieval`` {id: [db ids]}."""
    db_cols, _, _, gt_lines = scene
    cam = db_cols.cam(0)
    K, hw = cam.K(), (cam.h(), cam.w())
    n_views = len(db_cols.get_img_ids())
    db_ids = db_cols.get_img_ids()
    centres = np.stack([db_cols.campose(i).center() for i in db_ids])
    rng = np.random.default_rng(seed)
    images, gt, imgs, points, retrieval = {}, {}, {}, {}, {}
    for q_id in query_ids(n_queries, n_views):
        k = q_id - 1000
        Rm, t = ring_pose((k + 0.5) / n_views, rng)
        imgs[q_id] = render_view(gt_lines, K, hw, Rm, t, rng)
        gt[q_id] = CameraPose(R=Rm, tvec=t)
        # the prior, as the JAX package's runner test perturbs its query
        dR = Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix()
        prior = CameraPose(R=dR @ gt[q_id].R(), tvec=gt[q_id].tvec + 0.05)
        name = "none"
        if image_dir is not None:
            os.makedirs(image_dir, exist_ok=True)
            name = os.path.join(image_dir, f"img_{q_id}{ext}")
            if ext == ".npy":
                np.save(name, imgs[q_id])
            else:
                import cv2
                cv2.imwrite(name, imgs[q_id])
        images[q_id] = CameraImage(0, prior, name)
        # point matches from the true pose (f64), noise and outliers
        R64, t64 = gt[q_id].R().astype(np.float64), gt[q_id].tvec
        p3ds = wall_points(K, R64, t64, hw, N_POINTS, rng)
        pc = p3ds @ R64.T + t64
        p2ds = (pc[:, :2] / pc[:, 2:]) * K[[0, 1], [0, 1]] + K[:2, 2]
        p2ds += rng.normal(size=p2ds.shape) * 0.5
        n_out = int(N_POINTS * OUTLIER_RATIO)
        p2ds[:n_out] += rng.uniform(50, 200, size=(n_out, 2))
        points[q_id] = (p3ds, p2ds)
        d = np.linalg.norm(centres - gt[q_id].center(), axis=1)
        retrieval[q_id] = [db_ids[i] for i in np.argsort(d, kind="stable")
                           [:N_RETRIEVED]]
    return {"imagecols": ImageCollection({0: cam}, images), "gt": gt,
            "imgs": imgs, "points": points, "retrieval": retrieval}


def pose_errors(poses, gt):
    """{id: (centre error m, rotation error deg)}."""
    from limap_tpu_torch.util.evaluation import compute_pose_err
    return {q: compute_pose_err(poses[q], gt[q]) for q in sorted(gt)}


def summarize(errors, t_th: float = 0.05, r_th: float = 0.5) -> dict:
    """The count of queries under (t_th m, r_th deg) and the medians."""
    te = np.array([e[0] for e in errors.values()])
    re = np.array([e[1] for e in errors.values()])
    return {"n_queries": len(te),
            "n_under": int(((te < t_th) & (re < r_th)).sum()),
            "median_t_m": float(np.median(te)),
            "median_r_deg": float(np.median(re))}


def synthetic_problem(rng, n_points=40, n_lines=20, outlier_ratio=0.3,
                      noise=0.5):
    """A random PnPL problem (the JAX package's test problem): a camera,
    its true pose, n_points point matches and n_lines line matches with
    pixel noise, the first ``outlier_ratio`` of each moved off.  Returns
    (camera, pose_gt, p3ds, p2ds, l3ds, l3d_ids, l2ds)."""
    from limap_tpu_torch.base.camera import Camera
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    camera = Camera(K=K, hw=(480, 640))
    R_gt = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
    t_gt = -R_gt @ (rng.normal(size=3) * 0.5)
    pose_gt = CameraPose(R=R_gt, tvec=t_gt)

    def project(X):
        c = X @ R_gt.T + t_gt
        return (c[..., :2] / c[..., 2:]) * [K[0, 0], K[1, 1]] \
            + [K[0, 2], K[1, 2]]

    p3ds = rng.normal(size=(n_points, 3)) * 3
    p3ds[:, 2] += 10
    p2ds = project(p3ds) + rng.normal(size=(n_points, 2)) * noise
    n_out = int(n_points * outlier_ratio)
    p2ds[:n_out] += rng.uniform(50, 200, size=(n_out, 2))
    l3ds, l2ds = [], []
    for _ in range(n_lines):
        s = rng.normal(size=3) * 3 + [0, 0, 10]
        e = s + rng.normal(size=3) * 2
        l3ds.append(np.stack([s, e]))
        l2ds.append(project(np.stack([s, e]))
                    + rng.normal(size=(2, 2)) * noise)
    l3ds, l2ds = np.asarray(l3ds), np.asarray(l2ds)
    n_lout = int(n_lines * outlier_ratio)
    l2ds[:n_lout] += rng.uniform(40, 150, size=(n_lout, 1, 2))
    return camera, pose_gt, p3ds, p2ds, l3ds, np.arange(n_lines), l2ds
