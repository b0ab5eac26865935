"""Tanks & Temples alignment: Sim3 from the COLMAP reconstruction's
camera positions to the GT-rig trajectory (<scene>_COLMAP_SfM.log) and
the dataset transform (<scene>_trans.txt).

Counterpart of the reference LIMAP scripts/tnt_align.py, which shells out to
COLMAP's model_aligner; here the Sim3 is solved directly with the
Umeyama alignment already in the library (base/align.py), which is what
model_aligner computes from position correspondences.

Outputs <output>/alignment.txt (3x4, applied as x_gt = s R x + t) usable
by scripts/eval_tnt.py.
"""

import argparse
import os

import numpy as np

from limap_tpu_torch.base.align import umeyama_alignment

MAX_ERROR = 0.01


def read_positions(log_file):
    """<scene>_COLMAP_SfM.log: blocks of (index line + 4x4 pose)."""
    with open(log_file) as f:
        lines = f.readlines()
    n_images = len(lines) // 5
    positions = []
    counter = 0
    for _ in range(n_images):
        counter += 1
        mat = []
        for _ in range(4):
            mat.append([float(k) for k in
                        lines[counter].strip().split()])
            counter += 1
        positions.append(np.array(mat)[:3, 3])
    return positions


def read_trans(fname):
    with open(fname) as f:
        mat = np.array([[float(k) for k in f.readline().strip().split()]
                        for _ in range(4)])
    assert np.allclose(mat[3], [0, 0, 0, 1])
    return mat[:3, :]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="align a reconstruction to the TnT GT frame")
    parser.add_argument("--colmap_model", type=str, required=True,
                        help="COLMAP model folder of the reconstruction")
    parser.add_argument("--sfm_log", type=str, required=True,
                        help="<scene>_COLMAP_SfM.log from the meta set")
    parser.add_argument("--trans", type=str, required=True,
                        help="<scene>_trans.txt from the meta set")
    parser.add_argument("--output", type=str, default=".")
    args = parser.parse_args(argv)

    from limap_tpu_torch.pointsfm import ReadInfos

    imagecols = ReadInfos(args.colmap_model)
    ids = sorted(imagecols.get_img_ids(),
                 key=lambda i: imagecols.image_name(i))
    centers = np.stack([imagecols.campose(i).center() for i in ids])
    gt_positions = np.stack(read_positions(args.sfm_log))
    n = min(len(centers), len(gt_positions))
    # Sim3: reconstruction frame -> rig log frame
    R, t, s = umeyama_alignment(centers[:n].T, gt_positions[:n].T,
                                with_scale=True)
    resid = np.linalg.norm(
        (s * (R @ centers[:n].T) + t[:, None]).T - gt_positions[:n],
        axis=1)
    print(f"alignment residual: mean {resid.mean():.4f} "
          f"max {resid.max():.4f} (MAX_ERROR {MAX_ERROR})")
    # compose with the dataset's rig->GT transform
    trans = read_trans(args.trans)
    R2 = trans[:, :3]
    t2 = trans[:, 3]
    R_full = R2 @ R
    t_full = R2 @ t + t2
    s_full = s  # trans is rigid
    out = np.concatenate([s_full * R_full, t_full[:, None]], axis=1)
    os.makedirs(args.output, exist_ok=True)
    np.savetxt(os.path.join(args.output, "alignment.txt"), out)
    print(f"wrote {os.path.join(args.output, 'alignment.txt')}")


if __name__ == "__main__":
    main()
