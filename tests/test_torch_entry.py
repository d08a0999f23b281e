"""torch_entry.py, the port's counterpart of __graft_entry__.py: the one
SCP step of entry() against JAX's entry() on JAX's omegas (float64), and
dryrun_multichip on a grid of two gloo processes."""

import jax
import numpy as np
import pytest
import torch

import torch_entry
from riskaversetrajopt_torch import interop
from tests.port_harness import (  # noqa: F401 (autouse fixtures)
    module_time_limit,
    time_limit_per_test,
)


def test_entry_matches_jax_entry_step():
    """The port's step on the omegas JAX's entry() draws (PRNGKey(0),
    M=64) equals JAX's step to roundoff; the port's own example runs."""
    import __graft_entry__ as g

    assert jax.config.jax_enable_x64
    jfn, (jom, jalpha) = g.entry()
    us_j = np.asarray(jax.jit(jfn)(jom, jalpha))
    fn, (om, alpha) = torch_entry.entry(device="cpu")
    assert om.dWs.shape[0] == 64 and alpha.dtype == torch.float64
    us_t = fn(interop.drone_omega(jom), float(jalpha))
    np.testing.assert_allclose(us_t.numpy(), us_j, rtol=1e-7, atol=1e-9)
    us = fn(om, alpha)
    assert us.shape == us_t.shape and bool(torch.isfinite(us).all())


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_entry.entry()


def test_dryrun_multichip_two_gloo_processes():
    """n=2: a 2 x 1 grid, one problem per process (alpha 0.1 and 0.3,
    omegas seeded 0 and 1); both controls are those of the one-process
    step on the same problem."""
    us = torch_entry.dryrun_multichip(2, device="cpu")
    assert us.shape == (2, 20, 3)
    for b, alpha in enumerate((0.1, 0.3)):
        opt = torch_entry._make_opt(1, device="cpu")
        om = opt.sample(torch.Generator().manual_seed(b), 2)
        ref = opt.solve(om, alpha).us
        np.testing.assert_allclose(us[b].numpy(), ref.numpy(), rtol=1e-10,
                                   atol=1e-12)
