"""Mid-solve SCP checkpoint and resume.

The port's own copy of ``riskaversetrajopt_tpu/utils/checkpoint.py``, in
numpy only and in the same file format, so that a snapshot written by either
package resumes in the other. A snapshot holds the SCP iteration to resume
at, the control iterate and the ADMM warm starts (SURVEY.md section 5
'Checkpoint / resume'); callers hand tensors in as numpy arrays
(``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple, Optional

import numpy as np


class SCPCheckpoint(NamedTuple):
    scp_iter: int
    us: np.ndarray  # (S, n_u) current control iterate
    warm_x: np.ndarray  # (nv,) ADMM primal warm start
    warm_y: np.ndarray  # (rows,) ADMM dual warm start
    warm_rho: Optional[float] = None  # adapted ADMM rho (None in old files)


def save(path, scp_iter: int, us, warm_x, warm_y, warm_rho=None):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    arrays = dict(
        scp_iter=np.asarray(scp_iter),
        us=np.asarray(us),
        warm_x=np.asarray(warm_x),
        warm_y=np.asarray(warm_y),
    )
    if warm_rho is not None:
        arrays["warm_rho"] = np.asarray(warm_rho)
    np.savez(tmp, **arrays)
    tmp.rename(path)  # atomic on POSIX


def load(path) -> Optional[SCPCheckpoint]:
    path = pathlib.Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        return SCPCheckpoint(
            scp_iter=int(z["scp_iter"]),
            us=z["us"],
            warm_x=z["warm_x"],
            warm_y=z["warm_y"],
            warm_rho=(float(z["warm_rho"]) if "warm_rho" in z else None),
        )
