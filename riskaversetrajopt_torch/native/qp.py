"""ctypes wrapper for the native dense ADMM QP solver (native/qp_admm.cpp at
the repository root), the counterpart of ``riskaversetrajopt_tpu/native/qp.py``.

The host-side convex engine (the role OSQP plays in the reference) and an
independent oracle for the port's solvers. The library is built with g++ at
first use into ``build/torch_kernels/libqp_admm.so`` (rebuilt when the
source is newer), with the flags of the JAX package's build, so both
wrappers run the same machine code on the same host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "qp_admm.cpp"
LIB_PATH = _ROOT / "build" / "torch_kernels" / "libqp_admm.so"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def build() -> Path:
    """Compile SRC into LIB_PATH (through a temporary file, so processes
    building at once never load a partial library). A failure raises."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp], check=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime):
        build()
    lib = ctypes.CDLL(str(LIB_PATH))
    vec = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.qp_admm_solve.restype = ctypes.c_int
    lib.qp_admm_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, vec, vec, vec, vec, vec,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        vec, vec, vec,
    ]
    _lib = lib
    return lib


class NativeQPSolution(NamedTuple):
    x: torch.Tensor  # (n,) float64
    y: torch.Tensor  # (m,) float64
    iters: int
    prim_res: float
    dual_res: float
    solved: bool


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.float64)


def solve_qp_native(
    P, q, A, l, u,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    max_iter: int = 20000,
    sigma: float = 1e-6,
    rho: float = 0.1,
    alpha_relax: float = 1.6,
    polish: bool = True,
) -> NativeQPSolution:
    """min 1/2 x^T P x + q^T x s.t. l <= A x <= u on the host, in float64.
    Takes tensors (any device) or arrays; x and y come back as float64
    tensors on P's device (the CPU for arrays). A KKT matrix that is not
    positive definite raises."""
    device = P.device if isinstance(P, torch.Tensor) else torch.device("cpu")
    P, q, A, l, u = (_host(a) for a in (P, q, A, l, u))
    n, m = q.shape[0], l.shape[0]
    if P.shape != (n, n) or A.shape != (m, n) or u.shape != (m,):
        raise ValueError(f"solve_qp_native: P {P.shape}, A {A.shape}, "
                         f"u {u.shape} for n={n}, m={m}")
    x, y, info = np.zeros(n), np.zeros(m), np.zeros(3)
    status = _load().qp_admm_solve(
        n, m, P, q, A, l, u, eps_abs, eps_rel, max_iter,
        sigma, rho, alpha_relax, int(polish), x, y, info,
    )
    if status < 0:
        raise RuntimeError("native QP setup failed (KKT not SPD)")
    return NativeQPSolution(
        x=torch.from_numpy(x).to(device), y=torch.from_numpy(y).to(device),
        iters=int(info[0]), prim_res=float(info[1]),
        dual_res=float(info[2]), solved=(status == 0),
    )
