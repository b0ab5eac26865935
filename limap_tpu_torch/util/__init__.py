"""Small shared helpers, and the config, evaluation, geometry and io
modules."""

import dataclasses
import importlib

import numpy as np

__all__ = ["config", "evaluation", "io", "shape_bucket",
           "dataclass_from_dict"]
_SUBMODULES = ("config", "evaluation", "geometry", "io")


def __getattr__(name):
    # the submodules import the track containers, which import this
    # package, so they load on first access
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def shape_bucket(n: int, fine: int = 128, min_bucket: int = 8) -> int:
    """Shape bucket for n: powers of two up to ``fine``, then multiples
    of ``fine`` (same buckets as the reference, so padded shapes and
    therefore every padded index agree between the two packages)."""
    n = max(int(n), 1)
    if n <= fine:
        return max(int(2 ** np.ceil(np.log2(max(n, min_bucket)))),
                   min_bucket)
    return fine * ((n + fine - 1) // fine)


def dataclass_from_dict(cls, d, **extra):
    """``cls`` from the fields of ``d`` that it knows (``None`` gives the
    defaults); ``extra`` fields win."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in (d or {}).items() if k in fields}
    kw.update(extra)
    return cls(**kw)
