"""The car's gated structure sample-sharded in the port: two gloo processes
of the selftest worker (riskaversetrajopt_torch/parallel/distributed.py,
`--model car`) on the port's seed-0 car omegas, float64 'admm' and 'ipm',
against the port's unsharded runs, which this process computes while the
pair runs."""

import pytest
import torch

from riskaversetrajopt_torch.ops.saa_qp import SAAQPOps
from riskaversetrajopt_torch.parallel import distributed as tdist
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_torch_distributed import _join_pair, _start_pair
from tests.test_torch_sharded_backends import _assert_sharded_matches

CAR_BACKENDS = ("admm", "ipm")
CAR_ITERS = 2  # the gated scp_iter 0 and the first live one


@pytest.fixture(scope="module")
def runs():
    """The car's worker pair, started first; while it runs, the unsharded
    runs."""
    car = _start_pair("scp", ("--model", "car", "--backends",
                              ",".join(CAR_BACKENDS), "--scp-iters",
                              str(CAR_ITERS)))
    car_om = tdist.selftest_car_omegas()
    car_ref = {b: tdist.selftest_car_opt("cpu", CAR_ITERS, backend=b).solve(
        car_om, alpha=0.2) for b in CAR_BACKENDS}
    return {"car": _join_pair(car), "car_ref": car_ref}


@pytest.mark.parametrize("backend", CAR_BACKENDS)
def test_car_gated_structure_sharded(runs, backend):
    """The car (CarScenario(M=8), the port's seed-0 omegas) on two
    processes through its gated scp_iter 0, whose y rows and sample rows
    are zeroed while the CVaR row is live (SAAQPOps.free_y: the y-block
    elimination of _schur_free), and the first live iteration: float64
    'admm' and 'ipm' against the unsharded run at the drone's bound
    (measured 3.7e-4 and 9.9e-5 of it)."""
    opt = tdist.selftest_car_opt("cpu", CAR_ITERS)
    om = tdist.selftest_car_omegas()
    alpha = torch.tensor(0.2, dtype=torch.float64)
    data = opt._define(opt.model.initial_guess(), om, alpha)
    assert SAAQPOps(opt._static_for(tdist.SELFTEST_CAR_M), data, 0).free_y
    st = opt.static
    _assert_sharded_matches(runs["car"], backend, runs["car_ref"][backend],
                            st.n, st.K, tdist.SELFTEST_CAR_M)
