"""The hybrid (pose + focal + line + point) bundle adjustment and its
driver, on one card or over a mesh of ranks (one process a card, the
reduced system summed across them), the meshes and the multi-process
driver."""

from limap_tpu_torch.parallel import distributed
from limap_tpu_torch.parallel.hybrid_ba_driver import \
    solve_hybrid_bundle_adjustment
from limap_tpu_torch.parallel.mesh import (TRACK_AXIS, make_mesh, replicated,
                                           track_sharding)
from limap_tpu_torch.parallel.sharded_ba import (HybridBAOptions, HybridBAState,
                                                 make_hybrid_ba_cost,
                                                 make_hybrid_ba_step)

__all__ = ["TRACK_AXIS", "make_mesh", "replicated", "track_sharding",
           "HybridBAOptions", "HybridBAState", "make_hybrid_ba_cost",
           "make_hybrid_ba_step",
           "solve_hybrid_bundle_adjustment", "distributed"]
