"""A module-scoped fixture that runs a test module's torch, BLAS and
OpenMP work on two threads: the tier-1 run puts six pytest workers on
the machine's cores, and each library's default of one thread a core
oversubscribes them (OpenBLAS spins while it waits).  Import it into a
test module as ``from torch_threads import two_torch_threads  # noqa:
F401``."""

import contextlib

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        from threadpoolctl import threadpool_limits
        limits = threadpool_limits(2)
    except ImportError:             # numpy's own default then
        limits = contextlib.nullcontext()
    with limits:
        yield
    torch.set_num_threads(n)
