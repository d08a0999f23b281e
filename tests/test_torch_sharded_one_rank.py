"""The port's sample-sharded solve on a one-process gloo group: every
backend of tests/test_torch_sharded_backends.py is the unsharded
arithmetic bit for bit, and _ProxOps carries its operator's reductions.
No worker pair: the references are this process's unsharded runs."""

import pytest
import torch

from riskaversetrajopt_torch.ops import admm, qp_refine
from riskaversetrajopt_torch.ops.saa_qp import SAAQPOps
from riskaversetrajopt_torch.parallel import distributed as tdist
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)
from tests.test_torch_distributed import jax_omegas  # noqa: F401 (fixture)
from tests.test_torch_sharded_backends import (  # noqa: F401 (fixture)
    BACKENDS,
    one_rank,
    unsharded_runs,
)


@pytest.fixture(scope="module")
def runs(jax_omegas):
    """The port's unsharded runs of every backend on the JAX omegas."""
    om = tdist.selftest_scp_omegas(path=jax_omegas)
    return {"ref": unsharded_runs(om, BACKENDS)[0], "om": om}


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_rank_is_the_unsharded_run_bit_for_bit(runs, one_rank, backend):
    """On a one-process group every backend is the unsharded arithmetic bit
    for bit: the first two SCP iterations (the '_hybrid-prox' rescue
    included) against the unsharded run's. 0.5-3 s each on one worker."""
    res = tdist.selftest_scp_opt("cpu", 2, one_rank, backend=backend).solve(
        runs["om"], alpha=0.2)
    ref = runs["ref"][backend]
    assert res.qp_iters.tolist() == ref.qp_iters[:2].tolist()
    assert torch.equal(res.us_history, ref.us_history[:2])


def test_prox_ops_carries_the_operator_reductions(one_rank):
    """_ProxOps forwards its operator's reductions and shard: without them
    admm.reductions falls back to LOCAL and a sharded '_hybrid-prox' or
    'admm-ir' would take each process's partial residuals for global
    ones. Unsharded, the reductions are LOCAL."""
    st, data = tdist.selftest_problem(tdist.SELFTEST_M)
    tdata = tdist._to(data, "cpu")
    sig = torch.tensor(1e-3, dtype=torch.float64)
    shard = tdist.SampleShard(tdist.SELFTEST_M, one_rank)
    ops = SAAQPOps(st, tdata, 3, shard=shard)
    prox = qp_refine._ProxOps(ops, sig)
    assert prox.reductions is ops.reductions
    assert prox.shard is shard
    assert isinstance(admm.reductions(prox), tdist.ShardedReductions)
    assert admm.reductions(qp_refine._ProxOps(SAAQPOps(st, tdata, 3),
                                              sig)) is admm.LOCAL


