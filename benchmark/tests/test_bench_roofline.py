"""The frozen roofline arithmetic against chip_smoke.py's kernel table."""

import helpers  # noqa: F401
import roofline


def test_b1_least_time_at_m1000_is_chip_smokes_operations_bound():
    # chip_smoke.py:bound gives B1 at M=1000 (K = n = 60, n_fc = 6), chunk
    # 100: 0.237 us per iteration, set by the operations
    secs, by = roofline.least_seconds(1000, 60, 60, 6, 100)
    assert by == "operations"
    assert round(secs / 100 * 1e6, 3) == 0.237


def test_least_time_depends_on_iterations_not_on_chunking():
    one = roofline.least_seconds(1000, 60, 60, 6, 20000)[0]
    assert abs(one / 20000 - roofline.least_seconds(1000, 60, 60, 6, 100)[0] / 100) < 1e-18
    # with a handful of iterations the QP's bytes set the least time
    assert roofline.least_seconds(1000, 60, 60, 6, 1)[1] == "bytes"
