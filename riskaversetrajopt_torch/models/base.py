"""Interface of an SAA stochastic trajectory-optimization model.

The counterpart of ``riskaversetrajopt_tpu/models/base.py``. A model is a set
of functions over an explicit per-sample uncertainty tuple ``omega``. Every
function broadcasts over leading batch dimensions: ``x`` may be ``(n_x,)`` or
``(M, n_x)`` with ``omega`` fields carrying the same leading ``M``, so a
batch dimension written out replaces the JAX package's ``vmap``.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch

Omega = Any  # per-sample uncertainty tuple of tensors


def resolve_device(device) -> torch.device:
    """The device a model or driver runs on: the card unless the caller names
    another. With no device given and no card present it raises rather than
    running on the host."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the host"
        )
    return torch.device("cuda")


class SAAModel(Protocol):
    n_x: int
    n_u: int
    S: int
    K: int  # number of per-sample inequality constraints
    n_fc: int  # number of final (equality) constraint rows
    dt: float
    row_scale: float  # conditioning multiplier on CVaR sample rows
    device: torch.device
    dtype: torch.dtype

    def drift(self, x, u, omega: Omega) -> torch.Tensor: ...

    def dispersion(self, x, u, omega: Omega, dW) -> torch.Tensor: ...

    def x0(self, omega: Omega) -> torch.Tensor: ...

    def ineq_constraints(self, xs, omega: Omega) -> torch.Tensor: ...

    def final_constraints(self, xs) -> torch.Tensor: ...

    def sample(self, generator: torch.Generator, M: int,
               method: str = "saa") -> Omega: ...

    def initial_guess(self) -> torch.Tensor: ...
