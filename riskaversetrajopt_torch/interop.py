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

The padded lane-flat layout of ``saa_admm_f.py`` (f = k*Mp + i over Kp
rows, G2 (Kp*Mp, 128), G2T (128, Kp*Mp), colpF/colyF the colp/coly slots
transposed) maps to the port's F layout of ``ops/cuda/saa_admm_f.py``
(f = k*M + i, no padding).
"""

from __future__ import annotations

import numpy as np
import torch

from riskaversetrajopt_torch.models.car import CarOmega
from riskaversetrajopt_torch.models.drone import DroneOmega
from riskaversetrajopt_torch.models.hopper import FrictionField
from riskaversetrajopt_torch.ops.admm import Scaling
from riskaversetrajopt_torch.ops.cuda.saa_admm import ScaledSAA, ScaledState
from riskaversetrajopt_torch.ops.cuda.saa_admm_f import ScaledSAAF, ScaledStateF
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


def car_omega(om, device="cpu", dtype=torch.float64) -> CarOmega:
    return _convert(om, CarOmega, device, dtype)


def friction_field(field, device="cpu", dtype=torch.float64) -> FrictionField:
    return _convert(field, FrictionField, device, dtype)


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


def _shared_fields(a, colp, dims, eGy):
    """The fields both kernel layouts take alike: per-sample colp slots,
    small rows, Fs, cu, q_hat_u, Sinv, Cbar, the scalars, and the port's
    sm_free (some y meets the CVaR row alone), read off yd_hat, cy_hat and
    the (M, K) eGy."""
    n, n_fc, M = dims.n, dims.n_fc, dims.M
    free = np.any((colp[:M, 5] == 0) & np.all(eGy == 0, axis=1)
                  & (colp[:M, 4] != 0))
    out = dict(
        sm_free=np.float32(free),
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
    return out


def _shared_state(a, coly, dims):
    n, n_fc, M = dims.n, dims.n_fc, dims.M
    return dict(
        u=a["u"][0, :n], s=a["s"].reshape(()), t=a["t"].reshape(()),
        y=coly[:M, 0], z_y=coly[:M, 1], yd_y=coly[:M, 2],
        z_small=_small(a["z_small"], n_fc, n),
        yd_small=_small(a["yd_small"], n_fc, n),
    )


def _arrays(nt):
    return {f: np.asarray(v) for f, v in zip(nt._fields, nt)}


def _tensors(cls, out, device):
    return cls(**{f: to_tensor(out[f], device, torch.float32)
                  for f in cls._fields})


def scaled_saa(p, dims, device="cpu") -> ScaledSAA:
    """JAX padded ScaledSAA -> natural-layout ScaledSAA (float32).
    `dims` is the JAX KernelDims (fields n, n_fc, M, K, ...)."""
    n, M, K = dims.n, dims.M, dims.K
    a = _arrays(p)
    Gs = a["Gs"].reshape(-1, a["Gs"].shape[-2], a["Gs"].shape[-1])
    mk = lambda x: x[:M, :K]  # noqa: E731
    out = dict(
        Gs=Gs[:M, :K, :n],
        eGy=mk(a["eGy"]), eGt=mk(a["eGt"]), rv_G=mk(a["rv_G"]),
        lb_G=_lower(mk(a["lb_G"])), ub_G=mk(a["ub_G"]),
        **_shared_fields(a, a["colp"], dims, mk(a["eGy"])),
    )
    return _tensors(ScaledSAA, out, device)


def scaled_state(s, dims, device="cpu") -> ScaledState:
    """JAX padded ScaledState -> natural-layout ScaledState (float32)."""
    M, K = dims.M, dims.K
    a = _arrays(s)
    out = dict(z_G=a["z_G"][:M, :K], yd_G=a["yd_G"][:M, :K],
               **_shared_state(a, a["coly"], dims))
    return _tensors(ScaledState, out, device)


def _f_rows(v, dims):
    """JAX (1, Kp*Mp) flat rows -> port (K*M,) with f = k*M + i."""
    return v.reshape(-1, dims.Mp)[: dims.K, : dims.M].reshape(-1)


def scaled_saa_f(pf, dims, device="cpu") -> ScaledSAAF:
    """JAX padded ScaledSAAF -> the port's F-layout ScaledSAAF (float32).
    `dims` is the JAX KernelDims the layout was built with."""
    n, M, K = dims.n, dims.M, dims.K
    a = _arrays(pf)
    G2 = a["G2"].reshape(-1, dims.Mp, a["G2"].shape[-1])[:K, :M, :n]
    G2 = G2.reshape(K * M, n)
    out = dict(
        G2=G2, G2T=G2.T,
        eGy_f=_f_rows(a["eGy_f"], dims), eGt_f=_f_rows(a["eGt_f"], dims),
        rvG_f=_f_rows(a["rvG_f"], dims), lbG_f=_lower(_f_rows(a["lbG_f"], dims)),
        ubG_f=_f_rows(a["ubG_f"], dims),
        **_shared_fields(a, a["colpF"].T, dims,
                         _f_rows(a["eGy_f"], dims).reshape(K, M).T),
    )
    return _tensors(ScaledSAAF, out, device)


def scaled_state_f(sf, dims, device="cpu") -> ScaledStateF:
    """JAX padded ScaledStateF -> the port's F-layout ScaledStateF
    (float32)."""
    a = _arrays(sf)
    out = dict(zG_f=_f_rows(a["zG_f"], dims), ydG_f=_f_rows(a["ydG_f"], dims),
               **_shared_state(a, a["colyF"].T, dims))
    return _tensors(ScaledStateF, out, device)
