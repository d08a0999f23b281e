"""How far a sample-sharded float64 'admm-ir' drone SCP lands from the
unsharded one on the port's own seed-0 omegas (M=16, 3 SCP iterations,
the selftest config of riskaversetrajopt_torch/parallel/distributed.py),
in the port (2 and 4 gloo processes on the CPU) and in the JAX package
(the 8-device virtual CPU mesh). Each distance is max |du| / (0.01 + |u|)
over the control history, the share of tests/test_sharding.py's
rtol 1e-8 / atol 1e-10 bound times 1e-8. Also the port's resume from an
unsharded file (iterations 1-2 unsharded, 3 sharded) against the
unsharded run. About 6 minutes on the CPU:

    python tools/probe_sharded_sensitivity.py
"""

import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from riskaversetrajopt_torch.parallel import distributed as tdist  # noqa: E402
from tests.test_torch_nccl import ITERS, run_workers  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def dist_(a, c):
    a, c = np.asarray(a).reshape(-1), np.asarray(c).reshape(-1)
    return float(np.max(np.abs(a - c) / (0.01 + np.abs(c))))


def jax_runs(tom):
    from riskaversetrajopt_tpu.core.config import DroneScenario, SCPConfig
    from riskaversetrajopt_tpu.models.drone import DroneModel, DroneOmega
    from riskaversetrajopt_tpu.parallel.mesh import make_mesh, shard_samples
    from riskaversetrajopt_tpu.scp.driver import SAATrajOpt

    om = DroneOmega(**{k: jnp.asarray(getattr(tom, k).numpy())
                       for k in tom._fields})
    opt = SAATrajOpt(
        DroneModel(DroneScenario()), method="saa",
        qp_backend=tdist.CHECKPOINT_BACKEND,
        scp_cfg=SCPConfig(num_iters=ITERS, gate_iters=2, gate_row_scale=1e-7,
                          gate_bound_l=-0.1, gate_bound_u=0.1))
    return (opt.solve(om, alpha=0.2),
            opt.solve(shard_samples(om, make_mesh()), alpha=0.2))


def main():
    torch.set_num_threads(1)
    tom = tdist.selftest_scp_omegas()
    ref = tdist.selftest_scp_opt("cpu", ITERS,
                                 backend=tdist.CHECKPOINT_BACKEND).solve(
        tom, alpha=0.2)
    r = ref.us_history.numpy()
    b = tdist.CHECKPOINT_BACKEND
    print(f"port unsharded qp_iters {ref.qp_iters.tolist()}")
    for n in (2, 4):
        with tempfile.TemporaryDirectory() as d:
            p = run_workers(n, d, device="cpu")[0]
        full = np.asarray(p[b]["us_history"])
        flat = p["from_unsharded"]["us_history"]
        print(f"port {n} gloo processes: qp_iters {p[b]['qp_iters']}, "
              f"sharded vs unsharded {dist_(full, r):.3e}, resumed from "
              f"the unsharded file vs unsharded {dist_(flat, r[-1]):.3e}")
    u, s = jax_runs(tom)
    print(f"JAX qp_iters {np.asarray(u.qp_iters).tolist()} unsharded, "
          f"{np.asarray(s.qp_iters).tolist()} sharded; sharded vs unsharded "
          f"{dist_(s.us_history, u.us_history):.3e}; the port's unsharded "
          f"vs JAX's {dist_(r, u.us_history):.3e}")


if __name__ == "__main__":
    main()
