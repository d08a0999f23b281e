"""'_hybrid-prox' sample-sharded in the port: the worker pair of
tests/test_torch_sharded_backends.py on this backend alone (its capped ADMM
leg, proximal IPM rescue and final leg), against the port's unsharded run
and the JAX package's unsharded run."""

import pytest

from riskaversetrajopt_torch.parallel import distributed as tdist
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_torch_distributed import jax_omegas  # noqa: F401 (fixture)
from tests.test_torch_sharded_backends import (
    _assert_sharded_matches,
    _assert_sharded_matches_jax,
    pair_runs,
)

BACKEND = "_hybrid-prox"


@pytest.fixture(scope="module")
def runs(jax_omegas):
    """The worker pair of '_hybrid-prox', its unsharded run, its JAX
    run."""
    return pair_runs(jax_omegas, (BACKEND,))


@pytest.mark.parametrize("backend", [BACKEND])
def test_sharded_backend_matches_unsharded(runs, backend):
    """tests/test_torch_sharded_backends.py's comparison with the unsharded
    port (measured 0.13 of the rtol 1e-8 / atol 1e-10 bound; 10.8
    all-reduces per iteration)."""
    _assert_sharded_matches(runs["drone"], backend, runs["ref"][backend],
                            60, 60, tdist.SELFTEST_M)


@pytest.mark.parametrize("backend", [BACKEND])
def test_sharded_backend_matches_jax(runs, backend):
    """tests/test_torch_sharded_backends.py's comparison with JAX's
    unsharded run (JAX's QP iterations [75, 1864, 2010], the third
    uncertified, as on the 8-device mesh)."""
    _assert_sharded_matches_jax(runs, backend)


def test_sharded_hybrid_prox_goes_through_the_rescue(runs):
    """'_hybrid-prox''s second QP does not certify within the capped ADMM
    leg (hybrid_cap 1000 iterations): its count is the capped leg's plus
    the proximal IPM's and the final leg's, on both processes as
    unsharded (1864)."""
    cap = tdist.HYBRID_PROX_SELFTEST["hybrid_cap"]
    iters = runs["drone"][0]["_hybrid-prox"]["qp_iters"]
    assert iters[1] > cap
    assert iters == runs["ref"]["_hybrid-prox"].qp_iters.tolist()

