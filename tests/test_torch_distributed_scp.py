"""The port's sample-sharded drone SCP on two gloo processes (the selftest
worker's scp mode, riskaversetrajopt_torch/parallel/distributed.py) against
the unsharded port on tests/test_sharding.py's omegas, and the collective
audit of the sharded SCP; the sharded QP and the batch axis are in
tests/test_torch_distributed.py."""

import numpy as np
import pytest

from riskaversetrajopt_torch.parallel import distributed as tdist
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_torch_distributed import (  # noqa: F401 (fixture)
    _run_pair,
    assert_no_jacobian_communication,
    jax_omegas,
)


@pytest.fixture(scope="module")
def scp_pair(jax_omegas):
    return _run_pair("scp", ("--omegas", jax_omegas))


def test_sharded_scp_matches_unsharded(scp_pair, jax_omegas):
    """The drone SCP (M=16, 6 iterations) on sample-sharded omegas against
    the unsharded port on the same omegas, those of tests/test_sharding.py
    (JAX's sampler, PRNGKey(0)): the same QP iteration counts, both
    processes bit for bit alike, Monte Carlo included; the controls within
    rtol 1e-8 / atol 1e-10 and the L2 errors within rtol 1e-6, the
    contract of tests/test_sharding.py:45-54."""
    a, b = scp_pair
    for key in ("us", "l2", "qp_iters", "mc_safe", "mc_avar"):
        assert a[key] == b[key], key
    opt = tdist.selftest_scp_opt("cpu")
    om = tdist.selftest_scp_omegas(path=jax_omegas)
    res = opt.solve(om, alpha=0.2)
    assert a["qp_iters"] == res.qp_iters.tolist()
    np.testing.assert_allclose(np.array(a["us"]),
                               res.us.reshape(-1).numpy(), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(np.array(a["l2"]), res.l2_errors.numpy(),
                               rtol=1e-6, atol=1e-10)
    mc = opt.monte_carlo(res.us, om, 0.2)
    assert a["mc_safe"] == float(mc["safe_frac"])
    np.testing.assert_allclose(a["mc_avar"], float(mc["avar"]), rtol=1e-6,
                               atol=1e-9)


def test_collective_audit_no_jacobian_communication(scp_pair):
    """tests/test_torch_distributed.py's audit, of the sharded SCP with its
    Monte Carlo."""
    assert_no_jacobian_communication(scp_pair[0]["collectives"], 60, 60,
                                     tdist.SELFTEST_M)
