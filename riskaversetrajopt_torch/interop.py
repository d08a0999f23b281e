"""Carry values of the JAX package into the port's tensors.

Each function takes a JAX NamedTuple (or any tuple of array-likes with the
same fields) and converts every field with ``np.asarray``, so it never
imports jax; it returns the port's NamedTuple on the given device and dtype.
Tests use it to feed both packages the same numbers.

The padded TPU kernel layout of ``saa_admm.py`` (tiles of Gs, packed column
slots, 128-lane small rows, NEG_INF lower bounds) maps to the natural layout
of ``ops/cuda/saa_admm.py``:
  colp slots (saa_admm.py:46-48): 0 rv_y | 1 lb_y | 2 ub_y | 3 mask_y |
      4 cy_hat | 5 yd_hat | 6 ys_hat | 7 Dinv | 8 wD
  coly slots: 0 y | 1 z_y | 2 yd_y
  small rows (saa_admm.py:321-340): [0:n_fc] final | 6 cvar | 7 slack |
      [8:8+n] control  ->  [final | cvar | slack | control]
"""

from __future__ import annotations

import numpy as np
import torch

from riskaversetrajopt_torch.models.drone import DroneOmega
from riskaversetrajopt_torch.ops.admm import Scaling
from riskaversetrajopt_torch.ops.cuda.saa_admm import ScaledSAA, ScaledState
from riskaversetrajopt_torch.ops.saa_qp import SAAQPData

# f32-safe stand-in for -inf in the TPU kernel's bounds (saa_admm.py:71)
_TPU_NEG_INF = -3.0e38


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """One array-like -> tensor (a C-ordered copy, so the source stays
    untouched and slices become contiguous)."""
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(nt, cls, device, dtype):
    return cls(*(to_tensor(np.asarray(f), device, dtype) for f in nt))


def drone_omega(om, device="cpu", dtype=torch.float64) -> DroneOmega:
    return _convert(om, DroneOmega, device, dtype)


def saa_qp_data(data, device="cpu", dtype=torch.float64) -> SAAQPData:
    return _convert(data, SAAQPData, device, dtype)


def scaling(s, device="cpu", dtype=torch.float64) -> Scaling:
    return _convert(s, Scaling, device, dtype)


def _small(v, n_fc, n):
    v = v.reshape(-1)
    return np.concatenate([v[:n_fc], v[6:8], v[8 : 8 + n]])


def _lower(v):
    v = np.array(v, dtype=np.float32)
    v[v <= _TPU_NEG_INF] = -np.inf
    return v


def scaled_saa(p, dims, device="cpu") -> ScaledSAA:
    """JAX padded ScaledSAA -> natural-layout ScaledSAA (float32).
    `dims` is the JAX KernelDims (fields n, n_fc, M, K, ...)."""
    n, n_fc, M, K = dims.n, dims.n_fc, dims.M, dims.K
    a = {f: np.asarray(v) for f, v in zip(p._fields, p)}
    Gs = a["Gs"].reshape(-1, a["Gs"].shape[-2], a["Gs"].shape[-1])
    colp = a["colp"]
    mk = lambda x: x[:M, :K]  # noqa: E731
    out = dict(
        Gs=Gs[:M, :K, :n],
        eGy=mk(a["eGy"]), eGt=mk(a["eGt"]), rv_G=mk(a["rv_G"]),
        lb_G=_lower(mk(a["lb_G"])), ub_G=mk(a["ub_G"]),
        rv_y=colp[:M, 0], lb_y=_lower(colp[:M, 1]), ub_y=colp[:M, 2],
        cy_hat=colp[:M, 4], yd_hat=colp[:M, 5], ys_hat=colp[:M, 6],
        Dinv=colp[:M, 7], wD=colp[:M, 8],
        rv_small=_small(a["rv_small"], n_fc, n),
        lb_small=_lower(_small(a["lb_small"], n_fc, n)),
        ub_small=_small(a["ub_small"], n_fc, n),
        Fs=a["Fs"][:n_fc, :n], cu=a["cu"][0, :n], q_hat_u=a["q_hat_u"][0, :n],
        Sinv=a["Sinv"][: n + 2, : n + 2], Cbar=a["Cbar"][:M, : n + 2],
    )
    for f in ("ct_hat", "cs_hat", "ss_hat", "q_hat_s", "sm_beta", "sm_denom",
              "sigma", "alpha_relax"):
        out[f] = a[f].reshape(())
    return ScaledSAA(**{
        f: to_tensor(out[f], device, torch.float32)
        for f in ScaledSAA._fields
    })


def scaled_state(s, dims, device="cpu") -> ScaledState:
    """JAX padded ScaledState -> natural-layout ScaledState (float32)."""
    n, n_fc, M, K = dims.n, dims.n_fc, dims.M, dims.K
    a = {f: np.asarray(v) for f, v in zip(s._fields, s)}
    coly = a["coly"]
    out = dict(
        u=a["u"][0, :n], s=a["s"].reshape(()), t=a["t"].reshape(()),
        y=coly[:M, 0], z_y=coly[:M, 1], yd_y=coly[:M, 2],
        z_G=a["z_G"][:M, :K], yd_G=a["yd_G"][:M, :K],
        z_small=_small(a["z_small"], n_fc, n),
        yd_small=_small(a["yd_small"], n_fc, n),
    )
    return ScaledState(**{
        f: to_tensor(out[f], device, torch.float32)
        for f in ScaledState._fields
    })
