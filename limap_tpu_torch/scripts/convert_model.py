"""Model conversion.

    python -m limap_tpu_torch.scripts.convert_model -i INPUT -o OUTPUT \\
        [--type imagecols2colmap | colmap2vsfm]

Types:
  imagecols2colmap  a saved imagecols.npy -> COLMAP text model
  colmap2vsfm       a COLMAP model -> VisualSfM NVM (NVM_V3, one focal
                    length an image, no radial distortion)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.pointsfm.colmap_reader import read_model, write_model_txt
from limap_tpu_torch.util import io as limapio


def convert_imagecols_to_colmap(imagecols: ImageCollection,
                                output_path: str) -> None:
    """ImageCollection -> COLMAP text model."""
    write_model_txt(output_path, imagecols)


def convert_colmap_to_visualsfm(input_path: str, output_path: str,
                                nvm_file: str = "reconstruction.nvm") -> None:
    """COLMAP model -> VisualSfM NVM: each image's focal length, rotation
    and camera centre; each point with its observations relative to the
    principal point."""
    cams, images, p2d, p3d = read_model(input_path)
    os.makedirs(output_path, exist_ok=True)
    img_ids = sorted(images.keys())
    row_of = {img_id: i for i, img_id in enumerate(img_ids)}
    lines = ["NVM_V3", "", str(len(img_ids))]
    for img_id in img_ids:
        im = images[img_id]
        cam = cams[im.cam_id]
        f = float(cam.K()[0, 0])
        q = im.pose.qvec
        C = -im.pose.R().T @ im.pose.tvec     # NVM stores the centre
        lines.append(
            f"{im.image_name}\t{f} {q[0]} {q[1]} {q[2]} {q[3]} "
            f"{C[0]} {C[1]} {C[2]} 0 0")
    pts = []
    for rec in p3d.values():
        xyz = rec["xyz"]
        obs = []
        for img_id, p2did in zip(rec["image_ids"],
                                 rec.get("point2D_idxs",
                                         [0] * len(rec["image_ids"]))):
            if img_id not in row_of:
                continue
            xy = np.asarray(p2d.get(img_id, np.zeros((0, 2))))
            if p2did >= len(xy):
                continue
            K = cams[images[img_id].cam_id].K()
            mx = xy[p2did][0] - K[0, 2]
            my = xy[p2did][1] - K[1, 2]
            obs.append(f"{row_of[img_id]} {p2did} {mx} {my}")
        if not obs:
            continue
        pts.append(f"{xyz[0]} {xyz[1]} {xyz[2]} 128 128 128 "
                   f"{len(obs)} " + " ".join(obs))
    lines += ["", str(len(pts))] + pts + ["", "0", "", "0"]
    with open(os.path.join(output_path, nvm_file), "w") as fp:
        fp.write("\n".join(lines) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description="model conversion")
    parser.add_argument("-i", "--input_path", required=True, type=str)
    parser.add_argument("-o", "--output_path", required=True, type=str)
    parser.add_argument("--type", type=str, default="imagecols2colmap",
                        help="imagecols2colmap | colmap2vsfm")
    args = parser.parse_args(argv)
    if args.type == "imagecols2colmap":
        imagecols = limapio.read_npy(args.input_path).item()
        if isinstance(imagecols, dict):
            imagecols = ImageCollection.from_dict(imagecols)
        convert_imagecols_to_colmap(imagecols, args.output_path)
    elif args.type == "colmap2vsfm":
        convert_colmap_to_visualsfm(args.input_path, args.output_path)
    else:
        raise NotImplementedError(args.type)


if __name__ == "__main__":
    main()
