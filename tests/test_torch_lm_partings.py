"""How far a parted LM row ends from plain's line
(``limap_tpu_torch/testing/lm_checks.py::line_end_distance``), on the
CPU: the distance on lines whose answer is known, and the report of
``compare_solve`` on a seeded line BA whose rows part (plain from a start
one ulp away stands for a kernel that rounds otherwise)."""

import numpy as np
import pytest
import torch

from limap_tpu_torch.base.infinite_line import (InfiniteLines3d,
                                                MinimalInfiniteLines3d)
from limap_tpu_torch.optimize import lm
from limap_tpu_torch.optimize.line_ba import LineBAConfig, ba_residual
from limap_tpu_torch.testing import lm_checks as C
from torch_threads import two_torch_threads  # noqa: F401


def minimal(points, directions):
    p = torch.as_tensor(np.asarray(points, np.float64))
    d = torch.as_tensor(np.asarray(directions, np.float64))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    m = MinimalInfiniteLines3d.from_plucker(
        InfiniteLines3d.from_point_direction(p, d))
    return torch.cat([m.uvec, m.wvec], -1).numpy()


@pytest.mark.parametrize("offset", [0.0, 0.01, 0.3])
def test_line_end_distance_of_a_parallel_line(offset):
    """A line moved by ``offset`` perpendicular to itself ends that far
    from plain's, whatever the span (tolerance 1e-9 m, float64)."""
    p = np.array([[0.5, -1.0, 10.0], [3.0, 2.0, 12.0]])
    d = np.array([[1.0, 0.2, 0.0], [0.0, 1.0, 0.5]])
    n = np.cross(d, [0.0, 0.0, 1.0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    got = C.line_end_distance(minimal(p + offset * n, d), minimal(p, d))
    np.testing.assert_allclose(got, offset, atol=1e-9)


def test_line_end_distance_of_a_turned_line():
    """A line turned by an angle about plain's point nearest the origin
    ends END_SPAN * sin(angle) from it at the span's ends (1e-9 m)."""
    foot = np.array([0.0, 2.0, 10.0])        # its own nearest point
    d = np.array([1.0, 0.0, 0.0])             # perpendicular to foot
    ang = np.radians(3.0)
    turned = np.array([np.cos(ang), 0.0, np.sin(ang)])
    got = C.line_end_distance(minimal([foot], [turned]),
                              minimal([foot], [d]))
    assert abs(got[0] - C.END_SPAN * np.sin(ang)) < 1e-9, got


def test_parted_rows_report_their_end_distance():
    """On a seeded line BA solved from two starts one ulp apart, rows
    part; the report's max and median are those of line_end_distance on
    exactly the parted rows (1e-12 m), finite and ordered."""
    params0, aux = C.seeded_line_ba(seed=5, T=32, S=12, device="cpu")
    cfg = LineBAConfig(loss="huber")
    start = torch.nextafter(params0, torch.full_like(params0, 2.0))
    rk, rp = [], []
    res_k = lm.lm_solve(start, ba_residual(cfg), lm.retract_quat_so2, 4,
                        aux, 20, trace=rk)
    res_p = lm.lm_solve(params0, ba_residual(cfg), lm.retract_quat_so2, 4,
                        aux, 20, trace=rp)
    tr_k, tr_p = torch.stack(rk, 1), torch.stack(rp, 1)
    res = C.compare_solve(res_k, tr_k, res_p, tr_p,
                          C.line_ba_problem(aux, cfg),
                          2 * aux[-1].sum(1).numpy(),
                          end_distance=C.line_end_distance)
    assert res["ok"] and res["parted"] > 0, res
    parted = ~(C.accepts(tr_k) == C.accepts(tr_p)).all(1).numpy()
    far = C.line_end_distance(res_k.params.double().numpy()[parted],
                              res_p.params.double().numpy()[parted])
    assert abs(res["parted_end_dist_max_m"] - far.max()) < 1e-12
    assert abs(res["parted_end_dist_median_m"] - np.median(far)) < 1e-12
    assert np.isfinite(far).all()
    assert 0 <= res["parted_end_dist_median_m"] \
        <= res["parted_end_dist_max_m"]
    # rows that kept plain's accepts end where plain's do
    same = C.line_end_distance(res_k.params.double().numpy()[~parted],
                               res_p.params.double().numpy()[~parted])
    assert same.max() < 1e-4, same.max()
