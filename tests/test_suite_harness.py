"""What tests/port_harness.py sets: one compute thread in torch and in the
BLAS that numpy and XLA:CPU call, for the whole test process once a port
test module is collected, and for its subprocesses; and a time limit on
each port test that fails the test past it, with every thread's stack
written first."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

from tests import port_harness
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)

REPO = Path(__file__).resolve().parents[1]


def test_one_compute_thread_per_process():
    assert torch.get_num_threads() == 1
    assert torch.get_num_interop_threads() == 1
    for name in port_harness.THREAD_VARIABLES:
        assert os.environ[name] == "1", name
    from threadpoolctl import threadpool_info

    blas = [p for p in threadpool_info() if p["user_api"] == "blas"]
    # numpy's OpenBLAS and the one that XLA:CPU's LAPACK calls
    assert len(blas) >= 2
    assert {p["num_threads"] for p in threadpool_info()} == {1}
    # XLA keeps its own pools (--xla_cpu_multi_thread_eigen=false moved no
    # test's time) and tests/conftest.py's 8 virtual devices
    assert "--xla_force_host_platform_device_count=8" in os.environ[
        "XLA_FLAGS"].split()


def test_the_time_limit_is_armed():
    """Inside a test the alarm runs and its handler is the harness's."""
    assert signal.getsignal(signal.SIGALRM) is port_harness._over_the_limit
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= port_harness.TEST_TIME_LIMIT


def test_a_test_past_the_limit_fails_with_the_stacks(tmp_path):
    """A test that sleeps past a 6 s limit fails, with the stacks in its
    report, and the next test of the file still runs and passes."""
    (tmp_path / "test_sleeper.py").write_text(
        "import time\n\n"
        "from tests import port_harness\n"
        "from tests.port_harness import (  # noqa: F401\n"
        "    module_time_limit,\n"
        "    time_limit_per_test,\n"
        ")\n\n"
        "port_harness.TEST_TIME_LIMIT = 6.0\n\n\n"
        "def test_sleeps():\n    time.sleep(60)\n\n\n"
        "def test_after():\n    pass\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--rootdir", str(tmp_path), str(tmp_path / "test_sleeper.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "ran past its 6 s limit" in out, out
    assert "Thread 0x" in out and "test_sleeper.py" in out, out
