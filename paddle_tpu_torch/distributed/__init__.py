"""Distributed: the port of paddle_tpu/distributed for the data,
sharding and model-parallel axes, over ``torch.distributed`` (ROADMAP
A9a, A9b.1).

A rank is a process: `init_parallel_env` joins the world (NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU on request), `env.RankMesh` lays the
ranks out on named axes, the collectives (`collective`) take the rank's
local tensors, `comm_bucketer` coalesces grads into the reference's
buckets, `DataParallel` averages them, `fleet` builds the topology and
the sharded optimizer (stage 1), `sharding` stage 2, and `store` is the
ranks' key-value store. The comm stack's int8 quantizer is also what the
int8 paged KV pools store in. `fleet.layers.mpu` and
`fleet.TensorParallel` run tensor parallelism over the mp axis,
`fleet.PipelineParallel` the pp axis, `fleet.SegmentParallel` the sep
axis (a rank holds its block of the sequence; ring attention over the
sep group). The ep axis, the auto-tuner and the launcher wait for
ROADMAP A9b (torchrun launches ranks until then).
"""
from . import env, fleet, sharding  # noqa: F401
from .collective import (Group, P2POp, ReduceOp,  # noqa: F401
                         all_gather, all_gather_concat, all_gather_object,
                         all_reduce, all_reduce_quantized, alltoall,
                         alltoall_single, barrier, batch_isend_irecv,
                         broadcast, broadcast_object_list, dequantize_q8,
                         destroy_process_group, get_group, get_rank,
                         get_world_size, irecv, is_initialized, isend,
                         new_group, p2p_permute, quantize_symmetric_q8,
                         recv, reduce, reduce_scatter, scatter, send)
from .comm_bucketer import (BucketAssignment, GradBucketer,  # noqa: F401
                            bucketed_all_reduce, bucketed_reduce_scatter,
                            build_buckets)
from .env import (build_mesh, data_shard, get_mesh,  # noqa: F401
                  init_parallel_env, set_mesh)
from .env import is_initialized as parallel_env_initialized  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from .store import TCPStore, create_or_get_global_tcp_store  # noqa: F401

__all__ = ["BucketAssignment", "DataParallel", "GradBucketer", "Group",
           "P2POp", "ReduceOp", "TCPStore", "all_gather",
           "all_gather_concat", "all_gather_object", "all_reduce",
           "all_reduce_quantized", "alltoall", "alltoall_single", "barrier",
           "batch_isend_irecv", "broadcast", "broadcast_object_list",
           "bucketed_all_reduce", "bucketed_reduce_scatter", "build_buckets",
           "build_mesh", "create_or_get_global_tcp_store", "data_shard",
           "dequantize_q8", "destroy_process_group", "env", "fleet",
           "get_group", "get_mesh", "get_rank", "get_world_size",
           "init_parallel_env", "irecv", "is_initialized", "isend",
           "new_group", "p2p_permute", "parallel_env_initialized",
           "quantize_symmetric_q8", "recv", "reduce", "reduce_scatter",
           "scatter", "send", "set_mesh", "sharding", "spawn"]


def spawn(func, args=(), nprocs=-1, **kwargs):
    """Reference parallel.py spawn: ``func(*args)`` in ``nprocs``
    processes (``torch.multiprocessing.spawn``; ``func`` gets the rank
    first)."""
    import torch.multiprocessing as mp

    if nprocs in (-1, None):
        import torch

        nprocs = max(1, torch.cuda.device_count())
    return mp.spawn(func, args=args, nprocs=nprocs, **kwargs)
