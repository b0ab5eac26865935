"""The hybrid (pose + focal + line + point) bundle adjustment on one card,
and its driver.  The multi-card form (meshes, the track-split step,
multi-host) is ROADMAP queue 1 item 13."""

from limap_tpu_torch.parallel.hybrid_ba_driver import \
    solve_hybrid_bundle_adjustment
from limap_tpu_torch.parallel.sharded_ba import (HybridBAOptions, HybridBAState,
                                                 make_hybrid_ba_cost,
                                                 make_hybrid_ba_step)

__all__ = ["HybridBAOptions", "HybridBAState", "make_hybrid_ba_cost",
           "make_hybrid_ba_step", "solve_hybrid_bundle_adjustment"]
