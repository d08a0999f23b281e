"""Shared experiment-harness utilities: results persistence in the
reference `.npy` sequential-save format (car/driving.py:516-529), figure
output, and what every CLI of the port shares.

The port's own copy of ``riskaversetrajopt_tpu/experiments/common.py``: the
same file layouts, so that results written by either package load in the
other. Arrays may be numpy arrays or tensors on any device. matplotlib is
imported only by `setup_matplotlib`, which only --plot reaches.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch


def results_dir(base: str = "results") -> pathlib.Path:
    p = pathlib.Path(base)
    p.mkdir(parents=True, exist_ok=True)
    return p


def figures_dir(base: str = "figures") -> pathlib.Path:
    p = pathlib.Path(base)
    p.mkdir(parents=True, exist_ok=True)
    return p


def to_numpy(a) -> np.ndarray:
    """A numpy array of `a`, copied to the host if it is a tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_traj(path, us, xs):
    """Sequential np.save of (us, xs) — the reference's cross-script data
    contract (car/driving.py:516-521)."""
    with open(path, "wb") as f:
        np.save(f, to_numpy(us))
        np.save(f, to_numpy(xs))


def load_traj(path):
    with open(path, "rb") as f:
        us = np.load(f)
        xs = np.load(f)
    return us, xs


def save_timing(path, alphas, define_t, solve_t, cum_t, l2):
    """results/driving_computation_times.npy format
    (car/driving.py:523-529)."""
    with open(path, "wb") as f:
        for a in (alphas, define_t, solve_t, cum_t, l2):
            np.save(f, to_numpy(a))


def load_timing(path):
    with open(path, "rb") as f:
        return tuple(np.load(f) for _ in range(5))


def setup_matplotlib():
    """Headless-safe matplotlib (figures are saved, not shown — the only
    intentional deviation from the reference's plt.show() windows)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt



def sweep_seeds(seed: int, count: int) -> list:
    """`count` seeds derived from `seed`, one per repeat (the counterpart
    of jax.random.split(PRNGKey(seed), count) in the JAX CLIs)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**62, (count,), generator=g).tolist()


def generator(seed: int):
    """A CPU torch.Generator seeded with `seed`: samples are drawn on the
    host and moved to the model's device."""
    return torch.Generator().manual_seed(int(seed))


class Stage:
    """Wall time of one CLI stage, printed at its end: the card is
    synchronised first, so that the time covers the stage's device work."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds = time.perf_counter() - self.t0
            print(f"  (stage wall time {self.seconds:.2f} s)")
