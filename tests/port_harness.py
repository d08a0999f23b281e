"""What the port's tests (tests/test_torch_*.py) run under: one compute
thread per test process, and a time limit on each test.

The tier-1 run puts six test processes on the host's cores (pytest-xdist,
`-n 6`), and a pool of one thread per core in each turned minutes into a
quarter of an hour. Importing this module pins the process to one compute
thread: torch's intra-op and inter-op pools, the OpenBLAS that numpy calls
and the one that XLA:CPU's LAPACK calls; and it sets OMP_NUM_THREADS,
MKL_NUM_THREADS and OPENBLAS_NUM_THREADS to 1, so that the tests'
subprocesses (the gloo worker pairs) compute on one thread, as the
in-process references that they are compared with bit for bit do.

Every port test module imports it, and a test process collects every test
module before it runs any test (each xdist worker does), so in a run of
the whole suite the JAX package's tests run on one thread too. A run of
the JAX package's test files alone keeps the pools as they are.

A port test module also imports the two autouse fixtures below: a test
that runs past TEST_TIME_LIMIT seconds, counted from the end of the test
before it (so that its module fixtures' setup is under the limit too),
fails, and every thread's stack is written to its captured stderr first.
A hang then costs one test and not the run.

The files that run only on the card (test_torch_cuda_kernels.py,
test_torch_nccl.py: `--noconftest`, no jax, maybe no threadpoolctl there)
do without it."""

import faulthandler
import os
import signal
import sys

import pytest
import scipy.linalg.cython_lapack  # noqa: F401 (XLA:CPU's LAPACK: load it
# here, so that the limit below covers its pool)
import torch
from threadpoolctl import threadpool_limits

THREAD_VARIABLES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS")

os.environ.update(dict.fromkeys(THREAD_VARIABLES, "1"))
threadpool_limits(1, user_api="blas")
torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # torch takes it once, before any inter-op work
    pass

# Seconds per test, its setup included: about three times the slowest port
# test of a tier-1 run on an 8-core host (a worker pair's module fixture).
TEST_TIME_LIMIT = 900.0
# the stacks are written this long before the test is failed
STACKS_AHEAD = 5.0


def _over_the_limit(signum, frame):
    pytest.fail(f"the test ran past its {TEST_TIME_LIMIT:g} s limit; every "
                "thread's stack is in its captured stderr", pytrace=True)


def _arm():
    """Start the limit (SIGALRM can only be handled on the main thread,
    where pytest runs the tests)."""
    faulthandler.dump_traceback_later(
        max(TEST_TIME_LIMIT - STACKS_AHEAD, 1.0), file=sys.__stderr__)
    signal.signal(signal.SIGALRM, _over_the_limit)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT)


def _disarm():
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module", autouse=True)
def module_time_limit():
    """The limit of the module's first test, armed before the module's
    other fixtures are set up; disarmed after the module's last test."""
    _arm()
    try:
        yield
    finally:
        _disarm()


@pytest.fixture(autouse=True)
def time_limit_per_test():
    """After each test, the limit of the next one in the module (its
    fixtures' setup included); the module's teardown ends the last."""
    yield
    _arm()
