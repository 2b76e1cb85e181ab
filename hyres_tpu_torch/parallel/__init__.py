"""Data-parallel training and sharded evaluation on ``torch.distributed``
(counterpart of ``hyres_tpu/parallel``)."""

from .inference import make_sharded_eval
from .mesh import (DataParallel, all_reduce_grads_, broadcast_object, data_parallel_mesh,
                   replicate, shard_batch)
from .multihost import local_batch_slice, local_device, maybe_initialize_distributed
from .spatial import make_spatial_eval, strip_forward

__all__ = [
    "DataParallel",
    "all_reduce_grads_",
    "broadcast_object",
    "data_parallel_mesh",
    "local_batch_slice",
    "local_device",
    "make_sharded_eval",
    "make_spatial_eval",
    "maybe_initialize_distributed",
    "replicate",
    "shard_batch",
    "strip_forward",
]
