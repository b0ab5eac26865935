"""IO / serialization in LIMAP's on-disk formats (segments txt, metainfos
txt, single-file and folder-of-linetracks, obj and ply export, npy
containers), so files written here are read by the reference package and
the other way round.  Host numpy only."""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from limap_tpu_torch.base.image_collection import ImageCollection
from limap_tpu_torch.base.linetrack import LineTrack


def check_directory(fname: str) -> None:
    d = os.path.dirname(fname)
    if d:
        os.makedirs(d, exist_ok=True)


def check_path(fname: str) -> None:
    if not os.path.exists(fname):
        raise FileNotFoundError(fname)


def check_makedirs(folder: str) -> None:
    os.makedirs(folder, exist_ok=True)


def delete_folder(folder: str) -> None:
    if os.path.exists(folder):
        shutil.rmtree(folder)


def save_npy(fname: str, obj) -> None:
    check_directory(fname)
    np.save(fname, obj, allow_pickle=True)


def read_npy(fname: str):
    check_path(fname)
    return np.load(fname, allow_pickle=True)


# ------------------------------------------------------------- metainfos
def save_txt_metainfos(fname: str, neighbors: Dict[int, List[int]],
                       ranges) -> None:
    check_directory(fname)
    with open(fname, "w") as f:
        f.write(f"number of images, {len(neighbors)}\n")
        f.write(f"x-range, {ranges[0][0]}, {ranges[1][0]}\n")
        f.write(f"y-range, {ranges[0][1]}, {ranges[1][1]}\n")
        f.write(f"z-range, {ranges[0][2]}, {ranges[1][2]}\n")
        for img_id, ngs in neighbors.items():
            f.write(", ".join([f"image {img_id}"] + [str(n) for n in ngs])
                    + "\n")


def read_txt_metainfos(fname: str):
    check_path(fname)
    with open(fname) as f:
        lines = f.readlines()
    n_images = int(lines[0].strip().split(",")[1])
    ranges = (np.zeros(3), np.zeros(3))
    for d in range(3):
        k = lines[1 + d].strip().split(",")[1:]
        ranges[0][d], ranges[1][d] = float(k[0]), float(k[1])
    neighbors = {}
    for i in range(n_images):
        k = lines[4 + i].strip().split(",")
        img_id = int(k[0][6:])
        neighbors[img_id] = [int(x) for x in k[1:]]
    return neighbors, ranges


# -------------------------------------------------------------- segments
def save_txt_segments(folder: str, img_id: int, segs: np.ndarray) -> None:
    check_makedirs(folder)
    with open(os.path.join(folder, f"segments_{img_id}.txt"), "w") as f:
        f.write(f"{segs.shape[0]}\n")
        for s in segs:
            f.write(" ".join(str(v) for v in s[:4]) + "\n")


def read_txt_segments(folder: str, img_id: int) -> np.ndarray:
    fname = os.path.join(folder, f"segments_{img_id}.txt")
    check_path(fname)
    with open(fname) as f:
        lines = f.readlines()
    n = int(lines[0].strip())
    if n == 0:   # an image without detections
        return np.zeros((0, 4))
    return np.array([[float(v) for v in lines[1 + i].split()]
                     for i in range(n)]).reshape(n, -1)


def exists_txt_segments(folder: str, img_id: int) -> bool:
    return os.path.exists(os.path.join(folder, f"segments_{img_id}.txt"))


def read_all_segments_from_folder(folder: str) -> Dict[int, np.ndarray]:
    """{img_id: segments} of a folder, in order of image id (not the
    directory's order: a VP detector draws its hypotheses image after
    image, so the order decides its results)."""
    ids = sorted(int(f[9:-4]) for f in os.listdir(folder)
                 if f.startswith("segments_") and f.endswith(".txt"))
    return {img_id: read_txt_segments(folder, img_id) for img_id in ids}


# ------------------------------------------------------------ linetracks
def save_txt_linetracks(fname: str, linetracks: List[LineTrack],
                        n_visible_views: int = 4) -> None:
    """All tracks of >= ``n_visible_views`` images in one file."""
    check_directory(fname)
    tracks = [t for t in linetracks if t.count_images() >= n_visible_views]
    with open(fname, "w") as f:
        f.write(f"{len(tracks)}\n")
        for tid, tr in enumerate(tracks):
            f.write(f"{tid} {tr.count_lines()} {tr.count_images()}\n")
            f.write(f"{tr.line[0][0]:.10f} {tr.line[0][1]:.10f} "
                    f"{tr.line[0][2]:.10f}\n")
            f.write(f"{tr.line[1][0]:.10f} {tr.line[1][1]:.10f} "
                    f"{tr.line[1][2]:.10f}\n")
            f.write(" ".join(str(i) for i in tr.image_id_list) + " \n")
            f.write(" ".join(str(i) for i in tr.line_id_list) + " \n")


def save_folder_linetracks(folder: str, linetracks: List[LineTrack]) -> None:
    delete_folder(folder)
    check_makedirs(folder)
    for tid, tr in enumerate(linetracks):
        tr.Write(os.path.join(folder, f"track_{tid}.txt"))


def read_folder_linetracks(folder: str) -> List[LineTrack]:
    check_path(folder)
    n_tracks = sum(1 for f in os.listdir(folder)
                   if f.startswith("track") and f.endswith(".txt"))
    tracks = []
    for tid in range(n_tracks):
        tr = LineTrack()
        tr.Read(os.path.join(folder, f"track_{tid}.txt"))
        tracks.append(tr)
    return tracks


def save_folder_linetracks_with_info(folder: str, linetracks, config=None,
                                     imagecols: Optional[ImageCollection]
                                     = None, all_2d_segs=None) -> None:
    save_folder_linetracks(folder, linetracks)
    if config is not None:
        save_npy(os.path.join(folder, "config.npy"), config)
    if imagecols is not None:
        save_npy(os.path.join(folder, "imagecols.npy"), imagecols.as_dict())
    if all_2d_segs is not None:
        save_npy(os.path.join(folder, "all_2d_segs.npy"), all_2d_segs)


def read_folder_linetracks_with_info(folder: str):
    tracks = read_folder_linetracks(folder)
    cfg = imagecols = segs = None
    p = os.path.join(folder, "config.npy")
    if os.path.isfile(p):
        cfg = read_npy(p).item()
    p = os.path.join(folder, "imagecols.npy")
    if os.path.isfile(p):
        imagecols = ImageCollection.from_dict(read_npy(p).item())
    p = os.path.join(folder, "all_2d_segs.npy")
    if os.path.isfile(p):
        segs = read_npy(p).item()
    return tracks, cfg, imagecols, segs


# ------------------------------------------------------------ obj export
def save_obj(fname: str, lines: np.ndarray) -> None:
    """Wavefront export of segments [N, 2, 3]."""
    check_directory(fname)
    lines = np.asarray(lines)
    with open(fname, "w") as f:
        for seg in lines:
            f.write(f"v {seg[0][0]} {seg[0][1]} {seg[0][2]}\n")
            f.write(f"v {seg[1][0]} {seg[1][1]} {seg[1][2]}\n")
        for i in range(len(lines)):
            f.write(f"l {2 * i + 1} {2 * i + 2}\n")


def load_obj(fname: str) -> np.ndarray:
    check_path(fname)
    verts, segs = [], []
    with open(fname) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(v) for v in tok[1:4]])
            elif tok[0] == "l":
                segs.append([int(tok[1]) - 1, int(tok[2]) - 1])
    verts = np.asarray(verts)
    return np.stack([verts[[a, b]] for a, b in segs]) if segs else \
        np.zeros((0, 2, 3))


# ------------------------------------------------------------------- ply
def save_ply(fname: str, points: np.ndarray) -> None:
    check_directory(fname)
    points = np.asarray(points)
    with open(fname, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def read_ply(fname: str) -> np.ndarray:
    check_path(fname)
    with open(fname) as f:
        lines = f.readlines()
    n = 0
    start = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        if ln.strip() == "end_header":
            start = i + 1
            break
    return np.array([[float(v) for v in lines[start + i].split()[:3]]
                     for i in range(n)])


# ---------------------------------------------------------- name lists
def save_txt_imname_dict(fname: str, imname_dict: Dict[int, str]) -> None:
    check_directory(fname)
    with open(fname, "w") as f:
        f.write(f"{len(imname_dict)}\n")
        for img_id, name in imname_dict.items():
            f.write(f"{img_id} {name}\n")


def read_txt_imname_dict(fname: str) -> Dict[int, str]:
    check_path(fname)
    with open(fname) as f:
        lines = f.readlines()
    out = {}
    for i in range(int(lines[0].strip())):
        tok = lines[1 + i].strip().split(maxsplit=1)
        out[int(tok[0])] = tok[1] if len(tok) > 1 else ""
    return out


# ------------------------------------------------------ Line3D++ interop
def save_l3dpp(folder: str, imagecols: ImageCollection,
               all_2d_segs) -> None:
    """Each image's 2D segments in Line3D++'s input format,
    ``segments_L3D++_{id}_{w}x{h}_3000.txt``; the image size is the
    first camera's.  Images named like Tanks and Temples' (a leading
    "0") are numbered by the rank of their file number."""
    if os.path.exists(folder):
        shutil.rmtree(folder)
    os.makedirs(folder)
    img_ids = imagecols.get_img_ids()
    names = [imagecols.image_name(i) for i in img_ids]
    first_cam = imagecols.cameras[list(imagecols.cameras.keys())[0]]
    height, width = first_cam.h(), first_cam.w()
    tnt = bool(names) and os.path.basename(names[0])[:1] == "0"
    if tnt:
        order = np.argsort([int(os.path.basename(n)[:-4])
                            for n in names]).tolist()
    for k, idx in enumerate(img_ids):
        image_id = order.index(k) if tnt else idx
        fname = os.path.join(
            folder, f"segments_L3D++_{image_id}_{width}x{height}_3000.txt")
        segs = np.asarray(all_2d_segs[idx])
        with open(fname, "w") as f:
            f.write(f"{segs.shape[0]}\n")
            for line in segs:
                f.write(f"{line[0]} {line[1]} {line[2]} {line[3]}\n")


def read_txt_Line3Dpp(fname: str):
    """A Line3D++ result file -> (linetracks, line_track_id_list,
    line_counts, mergemat [tracks, 3D lines])."""
    linetracks, line_counts, line_track_id_list = [], [], []
    n_total = 0
    with open(fname) as f:
        txt_lines = f.readlines()
    for txt_line in txt_lines:
        tok = txt_line.strip().split(" ")
        c = 0
        n_lines = int(tok[c])
        c += 1
        n_total += n_lines
        line3d_list = []
        for _ in range(n_lines):
            vals = [float(k) for k in tok[c:c + 6]]
            c += 6
            line3d_list.append(np.array([vals[:3], vals[3:]]))
        n_supports = int(tok[c])
        c += 1
        img_ids, line_ids, line2ds = [], [], []
        for _ in range(n_supports):
            img_ids.append(int(tok[c]))
            line_ids.append(int(tok[c + 1]))
            vals = [float(k) for k in tok[c + 2:c + 6]]
            c += 6
            line2ds.append(np.array([vals[:2], vals[2:]]))
        track = LineTrack(line=line3d_list[0], image_id_list=img_ids,
                          line_id_list=line_ids, line2d_list=line2ds)
        linetracks.append(track)
        for _ in range(n_lines):
            line_counts.append(track.count_images())
            line_track_id_list.append(len(linetracks) - 1)
    mergemat = np.zeros((len(linetracks), n_total))
    for idx, track_id in enumerate(line_track_id_list):
        mergemat[track_id, idx] = 1
    return linetracks, line_track_id_list, line_counts, mergemat
