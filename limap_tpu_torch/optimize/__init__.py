"""Batched Levenberg-Marquardt, line bundle adjustment, line refinement
and the joint pose refinement of localization."""

from limap_tpu_torch.optimize.hybrid_localization import (LineLocConfig,
                                                          line_loc_residuals,
                                                          solve_jointloc)
from limap_tpu_torch.optimize.line_ba import (LineBAConfig,
                                              get_output_tracks,
                                              pack_minimal_lines,
                                              robust_weight,
                                              solve_line_bundle_adjustment,
                                              unpack_minimal_lines)
from limap_tpu_torch.optimize.lm import (LMResult, lm_solve, retract_pose,
                                         retract_quat_so2)
from limap_tpu_torch.optimize.line_refinement import (RefinementConfig,
                                                      line_refinement,
                                                      solve_line_refinement)

__all__ = [
    "LMResult", "lm_solve", "retract_pose", "retract_quat_so2",
    "LineBAConfig", "get_output_tracks", "pack_minimal_lines",
    "robust_weight", "solve_line_bundle_adjustment", "unpack_minimal_lines",
    "LineLocConfig", "line_loc_residuals", "solve_jointloc",
    "RefinementConfig", "line_refinement", "solve_line_refinement",
]
