"""Risk estimators: VaR / AVaR (CVaR) of sampled statistics.

The counterpart of ``riskaversetrajopt_tpu/ops/cvar.py``: the
Rockafellar-Uryasev estimation QP the reference solves per evaluation
(car/driving.py:639-671) has the empirical VaR as its optimal t, so both
estimators reduce to one sort.
"""

from __future__ import annotations

import torch


def var_sorted(Z, alpha):
    """Empirical VaR_alpha: the (floor(alpha*M)+1)-th largest sample
    (monte_carlo_var, drone_main_plot.py:640-652)."""
    M = Z.shape[0]
    Z_sorted = torch.sort(Z).values
    xth = int(torch.floor(torch.as_tensor(alpha, dtype=Z.dtype) * M))
    return Z_sorted[M - xth - 1]


def avar(Z, alpha):
    """Empirical AVaR_alpha: t* + mean(max(Z - t*, 0)) / alpha with t* the
    empirical VaR (car/driving.py:639-671)."""
    t = var_sorted(Z, alpha)
    return t + torch.mean(torch.clamp(Z - t, min=0.0)) / alpha
