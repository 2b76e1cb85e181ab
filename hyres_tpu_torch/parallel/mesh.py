"""Data parallelism on a ``torch.distributed`` process group.

Counterpart of ``hyres_tpu/parallel/mesh.py``. JAX shards the batch over
a 1-D ``'data'`` mesh and lets XLA insert the gradient psum; the port
runs one process a device, and ``DataParallel`` is this process's place
in the group (group, rank, world size, device).

JAX's mesh shrinks to a divisor of the batch size; whole processes cannot
be halved, so the port shards unevenly instead: of ``B`` rows, rank ``r``
takes ``b_r`` (the first ``B % world`` ranks one more), weights its local
mean loss by ``b_r / B``, and the all-reduce sums. Every term of the RD
loss is a mean over images, so the sum is the global-batch gradient; a
rank with no rows contributes zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group."""

    group: object | None  # None: a world of one without a process group
    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int, rank: int | None = None) -> Tuple[int, int]:
        """[start, stop) of ``rank``'s (default: this rank's) rows of ``n``."""
        r = self.rank if rank is None else rank
        base, extra = divmod(n, self.world)
        start = r * base + min(r, extra)
        return start, start + base + (r < extra)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place (nothing without a group)."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t


def data_parallel_mesh(device="cuda") -> DataParallel:
    """The handle of the initialised process group (``multihost.py``), or
    of a world of one when there is none."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        return DataParallel(group, dist.get_rank(group), dist.get_world_size(group),
                            torch.device(device))
    return DataParallel(None, 0, 1, torch.device(device))


def shard_batch(dp: DataParallel, batch):
    """This rank's rows of a global batch (leading axis)."""
    lo, hi = dp.rows(batch.shape[0])
    return batch[lo:hi]


def _flat_groups(tensors: Iterable[torch.Tensor]):
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


@torch.no_grad()
def replicate(dp: DataParallel, module_or_tensors):
    """Broadcast rank 0's parameters and buffers (of a module) or tensors
    to every rank, one flat buffer a dtype; returns the argument."""
    if dp.group is None:
        return module_or_tensors
    ts = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
          if isinstance(module_or_tensors, nn.Module) else list(module_or_tensors))
    for group in _flat_groups(ts):
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=0, group=dp.group)
        _unflatten_into(flat, group)
    return module_or_tensors


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    o = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[o:o + n].view_as(t))
        o += n


@torch.no_grad()
def all_reduce_grads_(dp: DataParallel, grads: List[torch.Tensor]) -> int:
    """Sum the gradient buffers ``grads`` (the optimizers' flat ones,
    ``train/optimizers.py FlatAdam``) over the group in place, one
    all-reduce a buffer. Returns their bytes (0 without a group)."""
    if dp.group is None:
        return 0
    for g in grads:
        dist.all_reduce(g, group=dp.group)
    return sum(g.numel() * g.element_size() for g in grads)


def broadcast_object(dp: DataParallel, obj):
    """Rank 0's ``obj`` (a picklable value) on every rank."""
    if dp.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=dp.group)
    return box[0]
