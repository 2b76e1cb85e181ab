"""Process-group set-up for data-parallel runs.

Counterpart of ``hyres_tpu/parallel/multihost.py``. JAX spans every
device from one process a host; the port runs one process a device
(``torchrun``), joined by a ``torch.distributed`` process group: NCCL
between cards, gloo on the CPU. Without torchrun's variables nothing is
initialised and the single-process path is unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def _requested() -> bool:
    return "WORLD_SIZE" in os.environ or os.environ.get("HYRES_MULTIHOST", "") not in ("", "0")


def local_device(device="cuda") -> torch.device:
    """The device of this process: ``cuda:{LOCAL_RANK}`` for a CUDA device
    when a multi-process run is requested, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and _requested():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def maybe_initialize_distributed(device="cuda", timeout: float = 600.0) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or a group of one when only ``HYRES_MULTIHOST=1``
    is set. NCCL for a CUDA device (bound to ``cuda:{LOCAL_RANK}``), gloo
    for the CPU; ``timeout`` seconds bound every collective. Returns
    whether it initialised a group; an existing group is left as it is."""
    if dist.is_initialized() or not _requested():
        return False
    env = os.environ
    rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    dev = local_device(device)
    kwargs = {"backend": "gloo", "rank": rank, "world_size": world,
              "timeout": datetime.timedelta(seconds=timeout)}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs.update(backend="nccl", device_id=dev)
    if "MASTER_ADDR" in env:
        dist.init_process_group(init_method="env://", **kwargs)
    elif world == 1:
        dist.init_process_group(store=dist.HashStore(), **kwargs)
    else:
        raise RuntimeError(f"WORLD_SIZE={world} needs MASTER_ADDR and MASTER_PORT "
                           "(torchrun sets them)")
    return True


def local_batch_slice(global_batch: int) -> int:
    """The rows of a global batch that this process takes (``mesh.py
    DataParallel.rows``: the first ``global_batch % world`` ranks take
    one more)."""
    from .mesh import data_parallel_mesh

    lo, hi = data_parallel_mesh("cpu").rows(global_batch)
    return hi - lo
