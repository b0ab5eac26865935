"""Dense features: maps, interpolation, line patches, extractors."""

from limap_tpu_torch.features.extractors import (GradientFeatureExtractor,
                                                 get_extractor)
from limap_tpu_torch.features.featuremap import (FeatureMap,
                                                 extract_line_patches,
                                                 interpolate_bicubic,
                                                 interpolate_bilinear)

__all__ = ["GradientFeatureExtractor", "get_extractor", "FeatureMap",
           "extract_line_patches", "interpolate_bicubic",
           "interpolate_bilinear"]
