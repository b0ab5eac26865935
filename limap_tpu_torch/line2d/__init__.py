"""2D line detection / description / matching front end."""

from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         get_detector, get_extractor,
                                         get_matcher)

__all__ = ["BaseDetector", "BaseMatcher", "get_detector", "get_extractor",
           "get_matcher"]
