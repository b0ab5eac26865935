"""Hierarchical YAML config with base-file inheritance + CLI overrides.

A config may name a ``base_config_file``; otherwise a runner-supplied
``default_path`` is merged under it.  Any nested key can be overridden
from the CLI as ``--a.b.c val`` with type coercion from the default
value; shortcut aliases map short flags to dotted paths.

PyYAML is imported inside :func:`load_config`, so the package imports on
a machine without it; a config can also be passed around as a plain
dict.
"""

from __future__ import annotations

import ast
import copy
from typing import Dict, List, Optional


def update_recursive(dict1: dict, dictinfo: dict) -> None:
    for k, v in dictinfo.items():
        if isinstance(v, dict):
            if k not in dict1 or not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def update_recursive_deepcopy(dict1: dict, dictinfo: dict) -> dict:
    out = copy.deepcopy(dict1)
    update_recursive(out, dictinfo)
    return out


def load_config(config_file: str,
                default_path: Optional[str] = None) -> dict:
    import yaml
    with open(config_file) as f:
        cfg_loaded = yaml.safe_load(f) or {}
    base_config_file = cfg_loaded.get("base_config_file")
    if base_config_file is not None:
        cfg = load_config(base_config_file)
    elif default_path is not None and config_file != default_path:
        cfg = load_config(default_path)
    else:
        cfg = {}
    update_recursive(cfg, cfg_loaded)
    return cfg


def _coerce(v: str, ref_val):
    """Coerce a CLI string to the type of the existing config value."""
    if isinstance(v, str) and v.lower() in ("none", "null"):
        return None
    if ref_val is None:
        return v
    t = type(ref_val)
    if t is bool:
        return str(v).lower() == "true"
    if t is list:
        parsed = ast.literal_eval(v if v.startswith("[") else f"[{v}]")
        return list(parsed)
    return t(v)


def update_config(cfg: dict, unknown: List[str],
                  shortcuts: Optional[Dict[str, str]] = None) -> dict:
    """Apply ``--a.b.c value`` style overrides (up to any depth)."""
    shortcuts = shortcuts or {}
    args = [shortcuts.get(a, a) for a in unknown]

    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            i += 1
            continue
        keys = arg[2:].split(".")
        node = cfg
        for key in keys[:-1]:
            node = node[key]
        ref_val = node[keys[-1]]

        if isinstance(ref_val, bool):
            # store-true style if no value follows
            if i == len(args) - 1 or args[i + 1].startswith("--"):
                node[keys[-1]] = True
                i += 1
                continue
            node[keys[-1]] = args[i + 1].lower() == "true"
            i += 2
            continue

        v = args[i + 1]
        consumed = 2
        if isinstance(ref_val, list) and not v.startswith("["):
            # multi-token list values
            j = i + 2
            while j < len(args) and not args[j].startswith("--"):
                v += "," + args[j]
                j += 1
            consumed = j - i
        node[keys[-1]] = _coerce(v, ref_val)
        i += consumed
    return cfg


def load_cli_config(config_file: str, default=None) -> dict:
    """A CLI's config: a ``.json`` file with the json module, any other
    file with PyYAML; where PyYAML is missing, ``default()`` (the same
    contents as the config file, held to it by a test).  A relative path
    that does not exist from the working directory is taken from the
    repository's root."""
    import importlib.util
    import json
    import os
    if not os.path.exists(config_file) and not os.path.isabs(config_file):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        config_file = os.path.join(root, config_file)
    if config_file.endswith(".json"):
        with open(config_file) as f:
            return json.load(f)
    if importlib.util.find_spec("yaml") is None and default is not None:
        return default()
    return load_config(config_file)


def default_triangulation_config() -> dict:
    """The contents of ``cfgs/triangulation/default.yaml`` as a fresh
    dict, for a machine without PyYAML (a test holds it to the file)."""
    return copy.deepcopy(_DEFAULT_TRIANGULATION)


def default_fitnmerge_config() -> dict:
    """The contents of ``cfgs/fitnmerge/default.yaml`` as a fresh dict,
    for a machine without PyYAML (a test holds it to the file)."""
    return copy.deepcopy(_DEFAULT_FITNMERGE)


def default_localization_config() -> dict:
    """The contents of ``cfgs/localization/default.yaml`` as a fresh dict,
    for a machine without PyYAML (a test holds it to the file)."""
    return copy.deepcopy(_DEFAULT_LOCALIZATION)


_DEFAULT_TRIANGULATION = {'cfg_type': 'triangulation',
 'weight_path': None,
 'load_meta': False,
 'load_det': False,
 'load_match': False,
 'load_undistort': False,
 'use_tmp': False,
 'n_visible_views': 4,
 'n_neighbors': 20,
 'visualize': False,
 'max_image_dim': 1600,
 'skip_exists': False,
 'output_dir': None,
 'output_folder': 'finaltracks',
 'load_dir': None,
 'undistortion_output_dir': 'undistorted_images',
 'sfm': {'reuse': False,
         'min_triangulation_angle': 1.0,
         'neighbor_type': 'dice',
         'ranges': {'range_robust': [0.05, 0.95], 'k_stretch': 1.25}},
 'line2d': {'max_num_2d_segs': 3000,
            'do_merge_lines': False,
            'visualize': False,
            'compute_descinfo': False,
            'detector': {'method': 'tpu_lsd', 'skip_exists': False},
            'extractor': {'method': 'patch_endpoints',
                          'skip_exists': False},
            'matcher': {'method': 'nn_endpoints',
                        'topk': 10,
                        'skip_exists': False}},
 'var2d': {'lsd': 2.0, 'tpu_lsd': 2.0},
 'triangulation': {'use_exhaustive_matcher': False,
                   'use_endpoints_triangulation': False,
                   'add_halfpix': False,
                   'min_length_2d': 0.0,
                   'var2d': -1.0,
                   'line_tri_angle_threshold': 1.0,
                   'IoU_threshold': 0.1,
                   'sensitivity_threshold': 70.0,
                   'fullscore_th': 1.0,
                   'max_valid_conns': 1000,
                   'min_num_outer_edges': 0,
                   'merging_strategy': 'greedy',
                   'num_outliers_aggregator': 2,
                   'max_tris_per_node': 64,
                   'linker2d_config': {'score_th': 0.5,
                                       'th_angle': 5.0,
                                       'th_perp': 2.0,
                                       'th_overlap': 0.05},
                   'linker3d_config': {'score_th': 0.5,
                                       'th_angle': 10.0,
                                       'th_overlap': 0.05,
                                       'th_smartoverlap': 0.1,
                                       'th_smartangle': 2.0,
                                       'th_perp': 1.0,
                                       'th_innerseg': 1.0,
                                       'th_scaleinv': 0.015},
                   'remerging': {'disable': False,
                                 'linker3d': {'score_th': 0.5,
                                              'th_angle': 5.0,
                                              'th_overlap': 0.001,
                                              'th_smartoverlap': 0.1,
                                              'th_smartangle': 1.0,
                                              'th_perp': 1.0,
                                              'th_innerseg': 1.0}},
                   'filtering2d': {'th_angular_2d': 8.0,
                                   'th_perp_2d': 5.0,
                                   'th_sv_angular_3d': 75.0,
                                   'th_sv_num_supports': 3,
                                   'th_overlap': 0.5,
                                   'th_overlap_num_supports': 3},
                   'use_vp': False,
                   'vpdet_config': {'method': 'jlinkage',
                                    'min_length': 40,
                                    'inlier_threshold': 1.0,
                                    'min_num_supports': 10}},
 'refinement': {'disable': False,
                'constant_pose': True,
                'constant_line': False,
                'min_num_images': 4,
                'num_outliers_aggregator': 2,
                'use_geometric': True,
                'geometric_alpha': 10.0}}

_DEFAULT_LOCALIZATION = {'cfg_type': 'localization',
 'weight_path': None,
 'load_det': False,
 'use_tmp': False,
 'visualize': False,
 'max_image_dim': 1600,
 'skip_exists': False,
 'output_dir': None,
 'load_dir': None,
 'n_neighbors_loc': 10,
 'line2d': {'max_num_2d_segs': 3000,
            'do_merge_lines': False,
            'visualize': False,
            'compute_descinfo': False,
            'detector': {'method': 'tpu_lsd', 'skip_exists': False}},
 'var2d': {'lsd': 2.0, 'tpu_lsd': 2.0},
 'localization': {'2d_matcher': 'epipolar',
                  'IoU_threshold': 0.2,
                  'reprojection_filter_dist': 10.0,
                  'epipolar_filter': False,
                  'ransac': {'method': 'hybrid',
                             'thres': 10.0,
                             'thres_point': 10.0,
                             'thres_line': 10.0,
                             'weight_point': 1.0,
                             'weight_line': 1.0},
                  'optimize': {'loss': 'huber',
                               'loss_scale': 2.0,
                               'weight_point': 1.0,
                               'weight_line': 1.0},
                  'line_cost_func': 'E2DPerpendicularDist2',
                  'line_weight': 1.0},
 'estimation': {'ransac': {'method': 'hybrid',
                           'thres_point': 10.0,
                           'thres_line': 10.0},
                'optimize': {'loss': 'huber', 'loss_scale': 2.0}}}

_DEFAULT_FITNMERGE = {'cfg_type': 'fitnmerge',
 'weight_path': None,
 'load_meta': False,
 'load_det': False,
 'load_fit': False,
 'use_tmp': False,
 'n_visible_views': 4,
 'n_neighbors': 100,
 'visualize': False,
 'max_image_dim': 1600,
 'skip_exists': False,
 'output_dir': None,
 'output_folder': 'fitnmerge_finaltracks',
 'load_dir': None,
 'sfm': {'reuse': False,
         'min_triangulation_angle': 1.0,
         'neighbor_type': 'dice',
         'ranges': {'range_robust': [0.05, 0.95], 'k_stretch': 1.25}},
 'line2d': {'max_num_2d_segs': 3000,
            'do_merge_lines': False,
            'visualize': False,
            'compute_descinfo': False,
            'detector': {'method': 'tpu_lsd', 'skip_exists': False}},
 'var2d': {'lsd': 2.0, 'tpu_lsd': 2.0},
 'fitting': {'var2d': -1.0, 'ransac_th': 0.75, 'min_percentage_inliers': 0.9},
 'merging': {'var2d': -1.0,
             'linker3d': {'score_th': 0.5,
                          'th_angle': 8.0,
                          'th_overlap': 0.01,
                          'th_smartoverlap': 0.1,
                          'th_smartangle': 1.0,
                          'th_perp': 0.75,
                          'th_innerseg': 0.75},
             'linker2d': {'score_th': 0.5,
                          'th_angle': 5.0,
                          'th_perp': 2.0,
                          'th_overlap': 0.05}},
 'remerging': {'disable': False,
               'linker3d': {'score_th': 0.5,
                            'th_angle': 5.0,
                            'th_overlap': 0.001,
                            'th_smartoverlap': 0.1,
                            'th_smartangle': 1.0,
                            'th_perp': 0.5,
                            'th_innerseg': 0.5}},
 'filtering2d': {'th_angular_2d': 8.0, 'th_perp_2d': 5.0},
 'refinement': {'disable': True,
                'constant_pose': True,
                'constant_line': False,
                'min_num_images': 4,
                'num_outliers_aggregator': 2,
                'use_geometric': True,
                'geometric_alpha': 10.0}}


def default_refinement_config() -> dict:
    """The contents of ``cfgs/refinement/default.yaml`` as a fresh dict,
    for a machine without PyYAML (a test holds it to the file)."""
    return copy.deepcopy(_DEFAULT_REFINEMENT)


def default_pl_association_config() -> dict:
    """The contents of ``cfgs/global_pl_association/default.yaml`` as a
    fresh dict, for a machine without PyYAML (a test holds it to the
    file)."""
    return copy.deepcopy(_DEFAULT_PL_ASSOCIATION)


_DEFAULT_REFINEMENT = {'refinement': {'min_num_images': 4,
                'use_geometric': True,
                'geometric_alpha': 10.0,
                'loss': 'cauchy',
                'loss_scale': 0.25,
                'max_num_iterations': 100,
                'num_outliers_aggregator': 2,
                'use_vp': False,
                'vp_multiplier': 0.1,
                'vpdet': {'method': 'jlinkage'},
                'use_heatmap': False,
                'sample_range_min': 0.05,
                'sample_range_max': 0.95,
                'heatmap_multiplier': 1.0,
                'use_feature': False,
                'n_samples_feature': 100,
                'fconsis_multiplier': 0.1},
 'n_visible_views': 4,
 'output_folder': 'refined_tracks'}

_DEFAULT_PL_ASSOCIATION = {'global_pl_association': {'constant_vp': False,
                           'lw_point': 0.1,
                           'geometric_alpha': 10.0,
                           'loss': 'cauchy',
                           'loss_scale': 0.25,
                           'th_count_lineline': 3,
                           'th_angle_lineline': 30.0,
                           'lw_pointline_association': 10.0,
                           'th_pixel': 2.0,
                           'th_weight_pointline': 3.0,
                           'lw_vpline_association': 1.0,
                           'th_count_vpline': 3,
                           'lw_vp_orthogonality': 1.0,
                           'th_angle_orthogonality': 87.0,
                           'lw_vp_collinearity': 0.0,
                           'th_angle_collinearity': 1.0,
                           'th_hard_pl_dist3d': 2.0,
                           'th_hard_vpline_angle3d': 5.0,
                           'n_bcd_rounds': 3,
                           'lm_iterations': 10},
 'use_vp': True,
 'vpdet_config': {'method': 'jlinkage', 'min_length': 20},
 'structures': {'bpt2d': {'threshold_keypoints': 2.0,
                          'threshold_intersection': 2.0,
                          'threshold_merge_junctions': 2.0}},
 'n_visible_views': 4,
 'output_dir': 'tmp_pl_association',
 'output_folder': 'associated_tracks'}
