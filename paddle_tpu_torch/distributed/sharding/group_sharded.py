"""Group-sharded training: the port of paddle_tpu/distributed/sharding/
group_sharded.py, stages 1 to 3.

`group_sharded_parallel(model, optimizer, level)`: ``"os"`` (stage 1)
wraps the optimizer in `DygraphShardingOptimizer` (each rank holds its
1/N shard of every bucket's masters and moments); ``"os_g"`` (stage 2)
also wraps the model in `GroupShardedStage2`, whose
`apply_collective_grads` (called by `jit.TrainStep` after the last
micro-batch's backward) reduce-scatters the grads bucket by bucket into
the rank's shards and drops each full grad as its bucket is done, so no
full grad outlives it. The optimizer's step runs on those shards. An
eager loop (``loss.backward(); opt.step()``) reduce-scatters in the
step instead. ``"p_g_os"`` (stage 3) wraps the model in
`GroupShardedStage3`: the parameters themselves live as the rank's 1/N
shards between uses (see its docstring); ``offload`` there keeps the
shards in pinned host memory, and is accepted and ignored at the other
levels, as in the reference. For a ``scan_layers`` GPT the sharded
fused scan step's ``param_storage="sharded"`` is the compiled form of
stage 3 (`train_step` of stage 2).

`GroupShardedScaler` wraps a `GradScaler` (the guard's flag is already
all-reduced over the shards by the optimizer); `save_group_sharded_model`
writes the model's whole state dict (a stage-3 model's gathered) and
the optimizer's gathered state with ``framework/io.py``.
"""
from __future__ import annotations

import os
import weakref

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from ...incubate.distributed.models.moe.moe_layer import refuse_moe
from ..fleet.meta_optimizers.dygraph_sharding_optimizer import \
    DygraphShardingOptimizer

__all__ = ["GroupShardedScaler", "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model"]

class GroupShardedStage2(nn.Module):
    """The stage-2 model wrapper (reference group_sharded.py:32-157)."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device=None, dp_group=None,
                 comm_bucket_mb=None):
        refuse_moe(layer, "GroupShardedStage2")
        super().__init__()
        if not isinstance(sharding_optimizer, DygraphShardingOptimizer):
            raise TypeError("GroupShardedStage2 needs the "
                            "DygraphShardingOptimizer of its parameters")
        self._layers = layer
        self._opt = sharding_optimizer

    @property
    def _comm_group(self):
        return self._opt._group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @torch.no_grad()
    def apply_collective_grads(self):
        """One reduce-scatter (mean) a bucket into the rank's shards; each
        full grad is dropped as its bucket is done."""
        if any(p.grad is not None for p in self._opt._params):
            self._opt._bucketer.reduce_scatter(average=True, release=True)

    def train_step(self, optimizer=None, criterion=None, **kw):
        from ...jit.sharded_scan import select_train_step

        return select_train_step(self._layers, optimizer or self._opt,
                                 criterion=criterion, group=self._opt._group,
                                 **kw)

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

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)


def _in_backward():
    """Inside a backward (a recompute replays forwards there)."""
    return torch._C._current_graph_task_id() != -1


class _PreBackward(torch.autograd.Function):
    """The identity on a module's outputs whose backward gathers the
    module's sharded buckets before the module's own backward reads
    them."""

    @staticmethod
    def forward(ctx, owner, buckets, *xs):
        ctx.owner, ctx.buckets = owner, buckets
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.owner._gather(ctx.buckets)
        return (None, None) + grads


def _units(module, stacks, unit=None, out=None):
    """``{id(parameter): the module whose forward gathers it}``: a layer
    of a stack (an element of one of ``stacks``) for everything below
    it, else the module that owns the parameter."""
    out = {} if out is None else out
    for p in module.parameters(recurse=False):
        out.setdefault(id(p), unit or module)
    stack = isinstance(module, stacks)
    for child in module.children():
        _units(child, stacks, unit or (child if stack else None), out)
    return out


class GroupShardedStage3(nn.Module):
    """The stage-3 model wrapper (reference group_sharded.py:159-258):
    the parameters themselves are sharded.

    The optimizer (a `DygraphShardingOptimizer` over the layer's
    parameters) lays its buckets out again (`_stage3`): each parameter
    of ``segment_size`` bytes or more lands in a bucket of its unit's (a
    layer of a stack, an element of a module list or `Sequential`, for
    all below it, whose forward may read its children's weights as
    LLaMA's fused column products do; else the module owning it), held
    between uses as this rank's 1/N shard
    (`comm_bucketer.FlatShard`: the flat buffer's storage freed, every
    parameter a view of it keeping its shape); smaller ones stay whole
    on every rank, their optimizer state sharded as in stage 1. A
    parameter that is already an mp block (`nn.clip.is_block`) is
    sharded as the block it is, over the sharding group.

    * Forward: a unit's pre-forward hook all-gathers its sharded
      buckets, its forward hook releases them and wraps its outputs in
      an identity whose backward gathers them again before the unit's
      backward runs (which holds a recompute, ``use_recompute``: the
      replay runs inside it). A forward hook inside a backward releases
      nothing: the buckets stay gathered until their grads are
      scattered.
    * Parameters read outside their unit's forward (the model's LM head,
      ``head_weight()``, which a tied head shares with the embedding and
      ``loss`` reads directly; a parameter two modules own) are gathered
      at the forward's first unit and stay so to the backward's end.
    * Backward: as each parameter's grad completes (its post-accumulate
      hook), and once every parameter of its bucket has one, the bucket's
      grads are reduce-scattered (mean) and added into the rank's grad
      shard, the full grads dropped and the bucket released; so a tied
      weight is scattered once, after both its contributions. At the
      backward's end what is left is scattered and released. Under
      ``accumulate_steps`` each micro-batch's grads are scattered so:
      the memory of one grad shard, N collectives more.
    * ``offload``: the shards live in pinned host memory between uses
      and are copied to the card for the gather and for the update; on
      the CPU it changes nothing, as in the reference.

    Between steps a rank holds the shards, the small parameters and
    nothing else of the parameters (`resident_param_bytes`). The other
    arguments are the reference's signature and change nothing.
    `get_all_parameters` gathers every parameter whole until `reshard`;
    `state_dict` gives the whole values (collective: every rank calls
    it)."""

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers=False, device=None, segment_size=2 ** 20,
                 pertrain_sync_models=True, offload=False, sync_comm=False,
                 dp_group=None, exclude_layer=None):
        refuse_moe(layer, "GroupShardedStage3")
        super().__init__()
        if not isinstance(optimizer, DygraphShardingOptimizer):
            raise TypeError("GroupShardedStage3 needs the "
                            "DygraphShardingOptimizer of its parameters")
        self._layers = layer
        self._opt = optimizer
        self._segment_size = int(segment_size)
        from ...nn.layer.container import LayerList, Sequential

        owners = {}
        for m in layer.modules():
            for p in m.parameters(recurse=False):
                owners.setdefault(id(p), []).append(m)
        unit = _units(layer, (nn.ModuleList, nn.Sequential, LayerList,
                              Sequential))
        self._shards = optimizer._stage3(
            lambda p: id(unit.get(id(p))), self._segment_size, offload)
        buckets = optimizer._bucketer.assignment.buckets
        self._buckets = buckets[:len(self._shards)]
        self._bucket_of = {id(optimizer._by_key[e.key]): bi
                           for bi, b in enumerate(self._buckets)
                           for e in b.entries}
        shared = {i for i, ms in owners.items() if len(ms) > 1}
        head = getattr(layer, "head_weight", None)
        if callable(head):
            shared.add(id(head()))
        self._held = {self._bucket_of[i] for i in shared
                      if i in self._bucket_of}
        self._expect = [len(b.entries) for b in self._buckets]
        self._ready = [0] * len(self._buckets)
        self._live = set()
        self._queued = False
        self._whole = False
        hooked = {}
        for i, m in unit.items():
            if i in self._bucket_of:
                hooked.setdefault(id(m), (m, set()))[1].add(
                    self._bucket_of[i])
        for m, mine in hooked.values():
            mine = sorted(mine)
            if mine:
                m.register_forward_pre_hook(
                    lambda mod, args, b=mine: self._pre(b))
                m.register_forward_hook(
                    lambda mod, args, out, b=mine: self._post(b, out))
        # the parameters' hooks live on the C++ side, out of the cycle
        # collector's sight: they hold the wrapper weakly, or it would
        # never be freed
        me = weakref.ref(self)

        def ready(p):
            wrapper = me()
            if wrapper is not None:
                wrapper._grad_ready(p)

        for b in self._buckets:
            for e in b.entries:
                optimizer._by_key[e.key].register_post_accumulate_grad_hook(
                    ready)

    # -- gathering ----------------------------------------------------------
    def _gather(self, buckets):
        for bi in buckets:
            self._shards[bi].gather()
            self._live.add(bi)

    def _release(self, buckets):
        for bi in list(buckets):
            self._shards[bi].release()
            self._live.discard(bi)

    def _pre(self, buckets):
        if not _in_backward():      # the held ones from the forward's start
            self._gather(sorted(self._held - self._live))
        self._gather(buckets)

    def _post(self, buckets, out):
        if self._whole or _in_backward():
            return None
        if torch.is_grad_enabled():
            flat, spec = tree_flatten(out)
            idx = [i for i, t in enumerate(flat)
                   if isinstance(t, torch.Tensor) and t.requires_grad]
            if idx:
                got = _PreBackward.apply(self, buckets,
                                         *[flat[i] for i in idx])
                for i, t in zip(idx, got):
                    flat[i] = t
                out = tree_unflatten(flat, spec)
        self._release([b for b in buckets if b not in self._held])
        return out

    # -- the grads ----------------------------------------------------------
    def _grad_ready(self, p):
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_backward)
        bi = self._bucket_of[id(p)]
        self._ready[bi] += 1
        if self._ready[bi] == self._expect[bi]:
            self._scatter(bi)

    def _scatter(self, bi):
        self._ready[bi] = 0
        self._opt._bucketer.reduce_scatter(
            average=True, release=True, buckets=[self._buckets[bi]],
            accumulate=True)
        if not self._whole:
            self._release([bi])

    def _end_backward(self):
        """The backward's end: the buckets some of whose grads never came
        scattered (the others as zeros), every bucket released."""
        self._queued = False
        for bi, k in enumerate(self._ready):
            if k:
                self._scatter(bi)
        if not self._whole:
            self._release(self._live)

    @property
    def _comm_group(self):
        return self._opt._group

    @torch.no_grad()
    def apply_collective_grads(self):
        """After the last micro-batch's backward (`jit.TrainStep`): the
        small parameters' buckets reduce-scattered (mean) into the rank's
        shards, their full grads dropped; the sharded buckets were
        scattered by the backward."""
        if self._queued:
            self._end_backward()
        small = self._opt._bucketer.assignment.buckets[len(self._shards):]
        by_key = self._opt._by_key
        if any(by_key[k].grad is not None for b in small for k in b.keys):
            self._opt._bucketer.reduce_scatter(average=True, release=True,
                                               buckets=small)

    # -- the reference's methods -------------------------------------------
    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        if not torch.is_grad_enabled() and not self._whole:
            self._release(self._live)   # no backward will come
        return out

    def get_all_parameters(self, convert2cpu=False):
        """Every parameter whole: gathered in place until `reshard`
        (returns the parameters; read them through copies: ``.numpy()``
        of a CPU tensor pins its storage, which `reshard` frees), or with
        ``convert2cpu`` numpy copies of the whole values, the shards left
        as they are (bf16 as float32)."""
        params = list(self._layers.parameters())
        if not convert2cpu:
            self._whole = True
            self._gather(range(len(self._shards)))
            return params
        from ..collective import all_gather_into
        from ..comm_bucketer import unpack

        whole = {}
        for st, b in zip(self._shards, self._buckets):
            flat = torch.empty(b.numel, dtype=b.dtype, device=st.device)
            all_gather_into(flat, st.values(), st.group)
            for k, v in unpack(flat, b).items():
                whole[id(self._opt._by_key[k])] = v

        def host(t):        # a copy: numpy would pin the storage's size
            t = t.detach().to("cpu", copy=True)
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        return [host(whole.get(id(p), p)) for p in params]

    def reshard(self):
        """The shards again, after `get_all_parameters`."""
        self._whole = False
        self._release(self._live)

    def resident_param_bytes(self):
        """This rank's parameter bytes on its device now: the stage-3
        buckets' shards (and whatever is gathered), the small buckets
        whole."""
        small = self._opt._flat[len(self._shards):]
        return int(sum(st.resident_bytes() for st in self._shards)
                   + sum(f.untyped_storage().nbytes() for f in small))

    def _whole_values(self, fn):
        was = set(self._live)
        self._gather(range(len(self._shards)))
        try:
            return fn()
        finally:
            if not self._whole:
                self._release([b for b in range(len(self._shards))
                               if b not in was])

    def state_dict(self, *args, **kwargs):
        """The whole values (copies), gathered: every rank calls it."""
        def copy():
            sd = self._layers.state_dict(*args, **kwargs)
            for k, v in sd.items():
                if isinstance(v, torch.Tensor):
                    sd[k] = v.detach().clone()
            return sd

        return self._whole_values(copy)

    def load_state_dict(self, state_dict, *args, **kwargs):
        """Whole values in: each rank keeps its shards of them."""
        def load():
            out = self._layers.load_state_dict(state_dict, *args, **kwargs)
            for st in self._shards:
                st.keep()
            return out

        return self._whole_values(load)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def train_step(self, optimizer=None, criterion=None, **kw):
        """A `jit.TrainStep` over this wrapper: ``criterion(model(*inputs),
        labels)``, or the model's ``loss(*batch)`` without one."""
        from ...jit import TrainStep

        if criterion is None:
            def loss_fn(m, *batch):
                return m.loss(*batch)
        else:
            def loss_fn(m, *batch):
                return criterion(m(*batch[:-1]), batch[-1])
        return TrainStep(self, loss_fn, optimizer or self._opt, **kw)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            layers = self.__dict__.get("_modules", {}).get("_layers")
            if layers is None:
                raise
            return getattr(layers, name)


class GroupShardedScaler:
    """Reference group_sharded_utils.GroupShardedScaler: the wrapped
    scaler as it is."""

    def __init__(self, scaler):
        self._scaler = scaler

    def __getattr__(self, item):
        return getattr(self._scaler, item)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Reference group_sharded.py:272. ``level``: "os" (stage 1), "os_g"
    (stage 2) or "p_g_os" (stage 3, ``segment_size`` and ``offload``:
    `GroupShardedStage3`'s; ``offload`` is ignored at the other levels,
    as in the reference). Without a ``group`` the fleet's topology, when
    ``fleet.init`` set one, gives the sharding group and the mp group
    the clip sums over. Returns ``(model, optimizer, scaler)``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"bad level {level!r} (os, os_g, p_g_os)")
    refuse_moe(model, "group_sharded_parallel")
    from ..fleet.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group() if group is None else None
    if hcg is not None and hcg.get_sep_parallel_world_size() > 1:
        raise NotImplementedError(
            "group_sharded_parallel under a sep degree above 1 is not "
            "ported yet: ROADMAP A9b.5b (the sep axis composes with dp, "
            "mp and a PipelineLayer's pp)")
    opt = (optimizer if isinstance(optimizer, DygraphShardingOptimizer)
           else DygraphShardingOptimizer(optimizer, hcg=hcg, group=group))
    if level == "p_g_os":
        out = GroupShardedStage3(model, opt, group=group,
                                 segment_size=segment_size, offload=offload)
    else:
        out = model if level == "os" else GroupShardedStage2(
            model, opt, group=group, buffer_max_size=buffer_max_size)
    if scaler is not None:
        scaler = GroupShardedScaler(scaler)
    return out, opt, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Reference group_sharded.py:296: ``output/model.pdparams`` (a
    stage-3 model's gathered whole) and, with the optimizer,
    ``output/model.pdopt`` (its gathered full state). Every rank
    gathers; rank 0 writes."""
    from ...framework import io as fio
    from .. import env

    layers = model if isinstance(model, GroupShardedStage3) else \
        getattr(model, "_layers", model)
    state = layers.state_dict()
    opt_state = optimizer.state_dict() if optimizer is not None else None
    if env.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    fio.save(state, os.path.join(output, "model.pdparams"))
    if opt_state is not None:
        fio.save(opt_state, os.path.join(output, "model.pdopt"))
