"""Data parallelism: the port of paddle_tpu/distributed/parallel.py's
``DataParallel`` (:41).

Each rank runs the wrapped model on its rows of the batch; the grads are
averaged over the data-parallel group with one bucketed all-reduce a
bucket (`comm_bucketer.GradBucketer`, ``comm_buffer_size`` MB a bucket;
``FLAGS_comm_bucket_mb=0`` makes it one a parameter), which gives every
rank the grads of the global batch's mean loss, the reference's global
step. At construction rank 0's parameters and buffers are broadcast, so
every rank starts equal.

The sync is `apply_collective_grads`: `jit.TrainStep` calls it after the
last micro-batch's backward; in an eager loop (``loss.backward();
opt.step()``) it runs by itself at the end of each backward, queued on
the autograd engine by the first parameter's grad, as the reference's
reducer hooks run. It runs once a backward (a second call is a no-op).
Inside `no_sync` grads accumulate locally and the next backward outside
it syncs them all.

An MoE model over more than one rank raises (ROADMAP A9b.3b): a rank
would route its own rows at its own capacity and take the aux loss of
its rows alone, which is not the world of one's step over the global
batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from . import collective as coll
from . import env
from ..incubate.distributed.models.moe.moe_layer import refuse_moe
from .comm_bucketer import GradBucketer
from .env import init_parallel_env  # noqa: F401  (the reference exports it)

__all__ = ["DataParallel", "broadcast_module", "get_rank", "get_world_size",
           "init_parallel_env"]


def data_group(mesh=None):
    """The group over the mesh's data axes (dp and sharding of degree >
    1): the world's when they span it; with none, the dp line (each rank
    alone beside its model-parallel peers)."""
    mesh = mesh or env.get_mesh()
    axes = env.data_axes(mesh) or (("dp",) if "dp" in mesh.shape else ())
    if not axes or mesh.degree(axes) == mesh.size:
        return coll.get_group()
    return coll.new_group(axes=axes, mesh=mesh)


@torch.no_grad()
def broadcast_module(module, group=None, src=0):
    """Group rank ``src``'s parameters and buffers to every rank."""
    group = group or coll.get_group()
    if group.nranks == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        coll.broadcast(t.data, src, group)


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from ..utils import flags

        self._layers = layers
        self._group = group or data_group()
        if self._group.nranks > 1:
            # each rank would route its own rows and take its own aux
            # loss, which the world of one's global batch does not
            refuse_moe(layers, "DataParallel over more than one rank")
        self.find_unused_parameters = find_unused_parameters
        self._grad_need_sync = True
        self._queued = self._synced = False
        mb = comm_buffer_size if int(
            flags.get_flag("FLAGS_comm_bucket_mb") or 0) > 0 else 0
        named = [(n, p) for n, p in layers.named_parameters()
                 if p.requires_grad]
        self._bucketer = GradBucketer(named, self._group, bucket_mb=mb)
        broadcast_module(layers, self._group)
        for _, p in named:
            p.register_post_accumulate_grad_hook(self._on_grad)

    @property
    def group(self):
        return self._group

    @property
    def _comm_group(self):
        return self._group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _on_grad(self, _):
        if not self._grad_need_sync or self._queued:
            return
        self._queued, self._synced = True, False
        torch.autograd.Variable._execution_engine.queue_callback(
            self._after_backward)

    def _after_backward(self):
        self._queued = False
        self.apply_collective_grads()

    @contextlib.contextmanager
    def no_sync(self):
        """Grads accumulate locally inside the block (reference
        parallel.py no_sync)."""
        self._grad_need_sync = False
        try:
            yield
        finally:
            self._grad_need_sync = True

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average the grads over the group: one all-reduce a bucket.
        Once a backward; nothing inside `no_sync`."""
        if not self._grad_need_sync or self._synced:
            return
        self._bucketer.all_reduce(average=True)
        self._synced = True

    def __getattr__(self, name):
        """The wrapped layer's attributes (``model.loss``, ``config``, ...)
        where the wrapper has none, as the reference delegates them."""
        try:
            return super().__getattr__(name)
        except AttributeError:
            layers = self.__dict__.get("_modules", {}).get("_layers")
            if layers is None:
                raise
            return getattr(layers, name)

    # the wrapped layer's names, as the reference delegates them
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)


def get_rank(group=None):
    return coll.get_rank(group)


def get_world_size(group=None):
    return coll.get_world_size(group)
