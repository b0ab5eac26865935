"""Drive an external hloc + pycolmap SfM where those tools are installed.

The known poses go into an empty COLMAP reference model, hloc extracts
and matches features over a neighbour-restricted pair list, and pycolmap
triangulates the points.  Both tools are imported at call time, and the
call raises ImportError without them; the in-process path is
:func:`limap_tpu_torch.pointsfm.sfm.run_sfm_with_known_poses`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from limap_tpu_torch.pointsfm.colmap_reader import (ReadPointTracks,
                                              write_model_txt)


def write_pairs_from_neighbors(fname: str, imagecols,
                               neighbors: Dict[int, List[int]]) -> str:
    """hloc pair file ("name1 name2" per line, each unordered pair once)
    from the visual-neighbour map."""
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    seen = set()
    with open(fname, "w") as f:
        for i in sorted(neighbors):
            for j in neighbors[i]:
                key = (min(i, j), max(i, j))
                if key in seen:
                    continue
                seen.add(key)
                n1 = os.path.basename(imagecols.images[i].image_name)
                n2 = os.path.basename(imagecols.images[j].image_name)
                f.write(f"{n1} {n2}\n")
    return fname


def run_colmap_sfm_with_known_poses(
        cfg: dict, imagecols, output_path: str,
        neighbors: Optional[Dict[int, List[int]]] = None,
        skip_exists: bool = False) -> Dict[int, dict]:
    """hloc features/matches + pycolmap triangulation against the known
    poses; returns {point_id: {xyz, image_ids, point2D_idxs}}.

    Requires ``hloc`` and ``pycolmap`` importable — raises ImportError
    with the in-process alternative otherwise.
    """
    try:
        import pycolmap  # noqa: F401
        from hloc import (extract_features, match_features,
                          triangulation)
    except ImportError as exc:
        raise ImportError(
            "hloc/pycolmap are not installed; use "
            "limap_tpu_torch.pointsfm.sfm.run_sfm_with_known_poses for the "
            "in-process SfM path") from exc
    from pathlib import Path

    hloc_cfg = cfg.get("hloc", {})
    outputs = Path(output_path)
    sfm_dir = outputs / "sfm"
    ref_model = outputs / "reference_model"
    if skip_exists and (sfm_dir / "points3D.bin").exists():
        return ReadPointTracks(str(sfm_dir))
    outputs.mkdir(parents=True, exist_ok=True)

    # 1. known poses -> empty COLMAP reference model
    write_model_txt(str(ref_model), imagecols, points3d={})

    # 2. hloc features over the image folder
    image_dir = Path(os.path.dirname(
        imagecols.images[imagecols.get_img_ids()[0]].image_name))
    feature_conf = extract_features.confs[
        hloc_cfg.get("descriptor", "superpoint_aachen")]
    matcher_conf = match_features.confs[
        hloc_cfg.get("matcher", "NN-superpoint")]
    feature_path = extract_features.main(feature_conf, image_dir,
                                         outputs)

    # 3. neighbor-restricted pairs (exhaustive when absent)
    pairs_path = outputs / "pairs-from-neighbors.txt"
    if neighbors is not None:
        write_pairs_from_neighbors(str(pairs_path), imagecols,
                                   neighbors)
    else:
        names = [os.path.basename(imagecols.images[i].image_name)
                 for i in imagecols.get_img_ids()]
        with open(pairs_path, "w") as f:
            for a in range(len(names)):
                for b in range(a + 1, len(names)):
                    f.write(f"{names[a]} {names[b]}\n")
    match_path = match_features.main(matcher_conf, pairs_path,
                                     feature_conf["output"], outputs)

    # 4. pycolmap point triangulation against the fixed poses
    triangulation.main(sfm_dir, ref_model, image_dir, pairs_path,
                       feature_path, match_path)
    return ReadPointTracks(str(sfm_dir))
