"""SOLD2: the network, the line detector on kernels T and U, and the
Needleman-Wunsch line matcher."""

from limap_tpu_torch.line2d.sold2.sold2 import (SOLD2Detector,  # noqa: F401
                                                SOLD2Extractor, SOLD2Matcher)
