"""The hybrid BA's step and cost over 2 gloo ranks on the CPU
(``limap_tpu_torch/parallel/sharded_ba.py`` over a ``DeviceMesh``),
against the port's one-process run in float64 and JAX's 2-device mesh
within JAX's float32 error (``tests/torch_parallel_checks.py``)."""

import pytest

from tests import torch_parallel_checks as C
from torch_threads import two_torch_threads  # noqa: F401

D = 2


@pytest.fixture(scope="module")
def runs():
    return C.run_all(D)


def test_ranks_end_every_step_with_the_same_state(runs):
    C.check_ranks_agree(runs[0])


@pytest.mark.parametrize("solver", list(C.SOLVERS))
def test_trajectory_matches_one_process_in_float64(runs, solver):
    C.check_trajectory_float64(runs[0], runs[1], solver)


@pytest.mark.parametrize("solver", list(C.SOLVERS))
def test_float32_within_jax_mesh_float32_error(runs, solver):
    C.check_float32_within_jax_error(runs[0], runs[2], solver)


def test_cost_matches_one_process_and_jax(runs):
    C.check_cost(runs[0], runs[1], runs[3])


def test_collectives_a_step(runs):
    C.check_collectives(runs[0])
