"""Small shared helpers."""

import numpy as np

__all__ = ["shape_bucket"]


def shape_bucket(n: int, fine: int = 128, min_bucket: int = 8) -> int:
    """Shape bucket for n: powers of two up to ``fine``, then multiples
    of ``fine`` (same buckets as the reference, so padded shapes and
    therefore every padded index agree between the two packages)."""
    n = max(int(n), 1)
    if n <= fine:
        return max(int(2 ** np.ceil(np.log2(max(n, min_bucket)))),
                   min_bucket)
    return fine * ((n + fine - 1) // fine)
