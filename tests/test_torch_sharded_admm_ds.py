"""'admm-ds' sample-sharded in the port: the worker pair of
tests/test_torch_sharded_backends.py on this backend alone (its
double-single iterates take as long as the other drone backends
together), against the port's unsharded run and the JAX package's
unsharded run (the reference's sharded 'admm-ds' returns NaN controls)."""

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

BACKEND = "admm-ds"


@pytest.fixture(scope="module")
def runs(jax_omegas):
    """The worker pair of 'admm-ds', its unsharded run, its JAX run."""
    return pair_runs(jax_omegas, (BACKEND,))


@pytest.mark.parametrize("backend", [BACKEND])
def test_sharded_backend_matches_unsharded(runs, backend):
    """tests/test_torch_sharded_backends.py's comparison with the unsharded
    port (measured 9.1e-6 of the rtol 1e-8 / atol 1e-10 bound; 18.2
    all-reduces per iteration)."""
    _assert_sharded_matches(runs["drone"], backend, runs["ref"][backend],
                            60, 60, tdist.SELFTEST_M)


@pytest.mark.parametrize("backend", [BACKEND])
def test_sharded_backend_matches_jax(runs, backend):
    """tests/test_torch_sharded_backends.py's comparison with JAX's
    unsharded run (JAX's QP iterations [75, 25, 1550])."""
    _assert_sharded_matches_jax(runs, backend)
