"""Undistort the Aachen-1.1 night queries
(reference: scripts/aachen_undistort.py) — reads the
queries-with-intrinsics list (SIMPLE_RADIAL), undistorts every image,
writes the undistorted camera list."""

import argparse
import os

from limap_tpu_torch.base.camera import Camera
from limap_tpu_torch.undistortion.undistort import undistort_image_camera


def load_list_file(fname):
    imname_list, cameras = [], []
    with open(fname) as f:
        for line in f:
            k = line.strip("\n").split(" ")
            if not k or not k[0]:
                continue
            imname = k[0]
            # Aachen only uses the simple radial model
            assert k[1] == "SIMPLE_RADIAL", k[1]
            w, h = int(k[2]), int(k[3])
            focal = float(k[4])
            cx, cy = float(k[5]), float(k[6])
            k1 = float(k[7])
            cameras.append(Camera(model="SIMPLE_RADIAL",
                                  params=[focal, cx, cy, k1],
                                  cam_id=len(cameras), hw=(h, w)))
            imname_list.append(imname)
    return imname_list, cameras


def process(image_list, cameras, img_orig_dir, img_undistort_dir,
            camerainfos_file):
    with open(camerainfos_file, "w") as f:
        for imname, camera in zip(image_list, cameras):
            imname_orig = os.path.join(img_orig_dir, imname)
            imname_undist = os.path.join(img_undistort_dir, imname)
            os.makedirs(os.path.dirname(imname_undist), exist_ok=True)
            cam_ud = undistort_image_camera(camera, imname_orig,
                                            imname_undist)
            K = cam_ud.K()
            import cv2
            img = cv2.imread(imname_undist)
            h, w = img.shape[:2]
            assert K[0, 0] == K[1, 1]
            f.write(f"{imname_undist} SIMPLE_PINHOLE {w} {h} "
                    f"{K[0, 0]} {K[0, 2]} {K[1, 2]}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="undistort Aachen-1.1 night queries")
    parser.add_argument("--data_dir", type=str,
                        default=os.path.expanduser(
                            "~/data/Localization/Aachen-1.1"))
    parser.add_argument("--output", type=str,
                        default="camerainfos_night_undistorted.txt")
    args = parser.parse_args(argv)
    img_orig_dir = os.path.join(args.data_dir, "images_upright")
    img_undistort_dir = os.path.join(args.data_dir, "undistorted")
    list_file = os.path.join(args.data_dir, "queries",
                             "night_time_queries_with_intrinsics.txt")
    image_list, cameras = load_list_file(list_file)
    process(image_list, cameras, img_orig_dir, img_undistort_dir,
            args.output)


if __name__ == "__main__":
    main()
