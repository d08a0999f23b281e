"""The (batch, samples) grid of processes: SAA sample-parallelism and an
independent-problem batch axis.

The counterpart of ``riskaversetrajopt_tpu/parallel/mesh.py``. The sample
axis is the data-parallel axis: a row of the grid splits the M samples of
one problem over its processes (parallel/distributed.SampleShard, the
structured solver's collectives); the batch axis gives each row its own
independent problem (the (alpha x repeat) sweep, drone_risk.py:498-503).
Process r sits at row r // n_samples, column r % n_samples. A single
process is the 1 x 1 grid and joins no group. JAX's GSPMD pin
`sample_pin` (driver.py:90-94) has no counterpart: the split is explicit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from riskaversetrajopt_torch.parallel.distributed import (
    SampleShard,
    _all_reduce,
    current_device,
    group_rank,
    group_size,
    process_sample_slice,
)


class Mesh(NamedTuple):
    n_batch: int
    n_samples: int
    batch_index: int  # this process's row
    sample_index: int  # this process's column
    sample_group: object  # the processes of this row (None: one process)
    batch_group: object  # the processes of this column (None: one process)
    device: torch.device

    def sample_shard(self, M: int) -> Optional[SampleShard]:
        """This process's share of a row's M samples; None when the row is
        one process (the unsharded solver)."""
        if self.n_samples == 1:
            return None
        return SampleShard(M, self.sample_group)

    def gather_batch(self, x):
        """(n_batch, ...) on every process: each row's `x` (the same on
        every process of a row), one all-reduce of a zero-padded buffer
        over the column."""
        full = torch.zeros((self.n_batch,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
        full[self.batch_index] = x
        if self.n_batch > 1:
            _all_reduce(full, "sum", self.batch_group)
        return full


def make_mesh(n_sample_devices: Optional[int] = None,
              n_batch_devices: int = 1, device=None) -> Mesh:
    """The (batch, samples) grid over the processes of the default group
    (distributed.initialize first; every process must call this, in the
    same order, since it creates the row and column groups). `device` is
    this process's device: default initialize's, else the card."""
    world = group_size()
    if n_sample_devices is None:
        n_sample_devices = world // n_batch_devices
    if n_sample_devices * n_batch_devices != world:
        raise ValueError(f"a {n_batch_devices} x {n_sample_devices} grid "
                         f"needs {n_batch_devices * n_sample_devices} "
                         f"processes, not {world}")
    r = group_rank()
    row, col = divmod(r, n_sample_devices)
    sample_group = batch_group = None
    if world > 1:
        for b in range(n_batch_devices):
            g = dist.new_group([b * n_sample_devices + i
                                for i in range(n_sample_devices)])
            if b == row:
                sample_group = g
        for i in range(n_sample_devices):
            g = dist.new_group([b * n_sample_devices + i
                                for b in range(n_batch_devices)])
            if i == col:
                batch_group = g
    if device is None:
        device = current_device()
    return Mesh(n_batch_devices, n_sample_devices, row, col, sample_group,
                batch_group, torch.device(device))


def shard_samples(tree, mesh: Mesh, batched: bool = False):
    """This process's part of a NamedTuple of per-sample values (every
    process holds the whole): its row's instance when `batched` (leading
    axis the batch), then its slice of the sample axis, on mesh.device."""
    out = []
    for x in tree:
        x = torch.as_tensor(x)
        if batched:
            x = x[mesh.batch_index]
        sl = (process_sample_slice(x.shape[0], mesh.sample_group)
              if mesh.n_samples > 1 else slice(None))
        out.append(x[sl].to(mesh.device))
    return type(tree)(*out)


def replicate(tree, mesh: Mesh):
    """A NamedTuple of values every process holds whole, on mesh.device."""
    return type(tree)(*(torch.as_tensor(x).to(mesh.device) for x in tree))
