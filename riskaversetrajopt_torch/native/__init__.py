"""The host-side native QP oracle: ctypes bindings to native/qp_admm.cpp
(the repository root's C++ source), built with g++ at first use."""

from riskaversetrajopt_torch.native.qp import (  # noqa: F401
    NativeQPSolution,
    solve_qp_native,
)
