"""Two-view proposals and the global line triangulator."""

from limap_tpu_torch.triangulation import functions
from limap_tpu_torch.triangulation.triangulator import (GlobalLineTriangulator,
                                                        TriangulatorConfig)

__all__ = ["functions", "GlobalLineTriangulator", "TriangulatorConfig"]
