"""Pipeline-parallel runtime: the port of paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py (:26-162).

`PipelineParallel.train_batch` splits the batch into
``accumulate_steps`` micro-batches and runs them through the stages, one
rank a stage: all forwards, then all backwards (the GPipe order; the
reference's 1F1B order computes the same grads). Stage ``s`` receives
each micro-batch's activation from stage ``s - 1`` (its shape and dtype
cross once, as a header: `spmd_pipeline.Ring`), runs its entries with
autograd and sends the result on; the last stage computes the loss
(``loss_fn(out, labels) / accumulate_steps``, scaled by the scaler when
there is one) and the backwards run in reverse, each stage receiving
its output's cotangent and sending its input's. Then the shared
layers' grads are summed over their stages, the grads averaged over the
data axes (dp x sharding; a sharded optimizer's reduce-scatter averages
them itself) and one optimizer step runs (the scaler's, or the
optimizer's), with the global-norm clip and the non-finite flag over
the pp x mp group (a plain optimizer is wrapped in
`HybridParallelOptimizer`), then the scheduler. Each data rank feeds its
own rows (``env.data_shard``); at construction the parameters are
broadcast over the data axes, group rank 0's winning. Under mp a stage
holds the mpu layers' blocks (a `models.LlamaForCausalLMPipe` stage its
Megatron decoder layers): its replicated parameters are broadcast over
the model-parallel group at construction and each batch over it before
the forwards, the ring runs per mp coordinate (each rank's own
pp group) and the clip and the flag span the pp x mp group. Under a sep
degree above 1 each micro-batch's inputs and labels are cut to the
rank's block of the sequence on dim 1 (`sep_shard`, after the mp
broadcast and the split), so a stage runs its entries on the block (a
LLaMA's attention over the sep group, its criterion summed over it);
the parameters are broadcast over the sep group at construction and the
grads summed over the fused dp+sep group and divided by the dp degree
(`fused_allreduce_gradients`), after which the sep ranks hold equal
grads and the clip and the flag stay over pp x mp. The ring's transfers
stay inside the pp group, whose ranks share a sep coordinate. A
sharding degree beside sep raises, naming ROADMAP A9b.5b. The loss
returned on every rank is the micro-batches' mean averaged over the data
axes: the reference's sequential micro-accumulation over the global
batch (:55-105). `eval_batch` runs the forwards alone.

`pipelined_blocks` is the reference's shim over `spmd_pipeline.
pipeline_spmd`.
"""
from __future__ import annotations

import torch

from ... import collective as coll
from ...parallel import broadcast_module
from ..utils.hybrid_parallel_util import (broadcast_input_data,
                                          broadcast_mp_parameters,
                                          broadcast_sep_parameters,
                                          fused_allreduce_gradients)
from . import A9B5B, MetaParallelBase
from ..meta_optimizers import (DygraphShardingOptimizer,
                               HybridParallelOptimizer)
from .pp_layers import PipelineLayer
from .ring_attention import sep_cut
from .spmd_pipeline import (Ring, _floating, microbatch, pipeline_spmd,
                            unmicrobatch)

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave",
           "pipelined_blocks"]


def _split_micro(data, n):
    if isinstance(data, (tuple, list)):
        parts = [_split_micro(d, n) for d in data]
        return [tuple(p[i] for p in parts) for i in range(n)]
    if isinstance(data, torch.Tensor):
        b = data.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by micro-steps {n}")
        sz = b // n
        return [data[i * sz:(i + 1) * sz] for i in range(n)]
    return [data] * n


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel wraps a PipelineLayer")
        super().__init__(layers, hcg, strategy)
        cfg = (getattr(strategy, "pipeline_configs", None) or
               {"accumulate_steps": 1})
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.num_stages = (hcg.get_pipe_parallel_world_size()
                           if hcg is not None else layers.get_num_stages())
        self.stage_id = layers.get_stage_id()
        self._group = hcg.get_pipe_parallel_group() if hcg is not None \
            else None
        self._data = hcg.get_sharding_data_group() if hcg is not None \
            else None
        if self._data is not None:
            broadcast_module(layers, self._data)
        self._mp = hcg.get_model_parallel_group() if hcg is not None \
            else None
        if self._mp is not None and self._mp.nranks > 1:
            broadcast_mp_parameters(layers, hcg)
        self._sep = (hcg.get_sep_parallel_group() if hcg is not None
                     and hcg.get_sep_parallel_world_size() > 1 else None)
        if self._sep is not None:
            deg = hcg.get_sharding_parallel_world_size()
            if deg > 1:
                raise NotImplementedError(A9B5B.format(
                    f"the sharding axis ({deg}) beside a PipelineLayer"))
            broadcast_sep_parameters(layers, hcg)
        self.total_loss = None
        self._opts = {}

    def _device(self):
        p = next(self._layers.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _split(self, data):
        """``data``'s micro-batches, after group rank 0's data is sent over
        the model-parallel group (its ranks compute on the same rows);
        under sep each cut to the rank's block of the sequence."""
        if self._mp is not None and self._mp.nranks > 1:
            broadcast_input_data(self._hcg, *(
                data if isinstance(data, (tuple, list)) else (data,)))
        micro = _split_micro(data, self.accumulate_steps)
        if self._sep is None:
            return micro
        return [sep_cut(mb, self._sep) for mb in micro]

    def _run_forward(self, micro, grad, compute_loss=True):
        """The forwards of every micro-batch: [(input, output or loss)]
        this stage keeps, and the last stage's per-micro results."""
        s, n = self.stage_id, self.num_stages
        ring = Ring(self._group, self._device(), headers=True)
        kept = []
        for mb in micro:
            inputs, labels = mb if isinstance(mb, tuple) else (mb, None)
            if s == 0:
                x = inputs
            else:
                x = ring.exchange([], [(None, s - 1, ("f", s - 1))])[0]
                if grad and _floating(x.dtype):
                    x.requires_grad_()
            with torch.set_grad_enabled(grad):
                out = self._layers(*(x if isinstance(x, tuple) else (x,)))
                if s == n - 1:
                    if compute_loss and self._layers._loss_fn is not None \
                            and labels is not None:
                        out = self._layers._loss_fn(out, labels)
                    out = out * (1.0 / self.accumulate_steps)
            if s < n - 1:
                ring.exchange([(out.detach(), s + 1, ("f", s))], [])
            kept.append((x, out))
        return kept

    def _broadcast_last(self, t, dev, shape=None, dtype=None):
        """The last stage's ``t`` on every stage."""
        if self._group is None or self.num_stages == 1:
            return t
        last = self.num_stages - 1
        if self.stage_id != last:
            t = torch.empty(shape, dtype=dtype, device=dev)
        coll.broadcast(t, last, self._group)
        return t

    def _data_mean(self, t):
        """``t`` averaged over the data axes, in place."""
        if self._data is not None and self._data.nranks > 1:
            coll.all_reduce(t, coll.ReduceOp.SUM, self._data)
            t.mul_(1.0 / self._data.nranks)
        return t

    def _hybrid_opt(self, optimizer):
        """The step's optimizer: a `HybridParallelOptimizer` as given, a
        plain one wrapped (the clip and the flag over the pp x mp
        group)."""

        if isinstance(optimizer, HybridParallelOptimizer) or \
                self._hcg is None:
            return optimizer
        key = id(optimizer)
        if key not in self._opts:
            self._opts[key] = HybridParallelOptimizer(optimizer, self._hcg,
                                                      self._strategy)
        return self._opts[key]

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step over ``data`` (``(inputs, labels)``): the loss, the
        micro-batches' mean, on every stage."""
        s, n = self.stage_id, self.num_stages
        dev = self._device()
        kept = self._run_forward(self._split(data), True)
        ring = Ring(self._group, dev)       # the shapes are known now
        total = None
        for x, out in reversed(kept):
            if s == n - 1:
                total = out.detach() if total is None \
                    else total + out.detach()
                (scaler.scale(out) if scaler is not None else out) \
                    .backward()
            elif _floating(out.dtype):
                dy = torch.empty(out.shape, dtype=out.dtype, device=dev)
                dy = ring.exchange([], [(dy, s + 1, ("b", s + 1))])[0]
                if out.requires_grad:
                    torch.autograd.backward(out, dy)
            if s > 0 and isinstance(x, torch.Tensor) and x.requires_grad:
                dx = x.grad if x.grad is not None else torch.zeros_like(x)
                ring.exchange([(dx, s - 1, ("b", s))], [])
        del kept
        self._layers.allreduce_shared_weight_gradients()
        opt = self._hybrid_opt(optimizer)
        if self._sep is not None:
            # summed over sep, averaged over dp
            fused_allreduce_gradients(list(self._layers.parameters()),
                                      self._hcg)
        elif self._data is not None and not isinstance(
                getattr(opt, "_inner_opt", opt), DygraphShardingOptimizer):
            fused_allreduce_gradients(list(self._layers.parameters()),
                                      group=self._data)
        if scaler is not None:
            scaler.step(opt)
            scaler.update()
        else:
            opt.step()
        opt.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        total = self._data_mean(total.float()) if total is not None \
            else None
        self.total_loss = self._broadcast_last(total, dev, (),
                                               torch.float32)
        return self.total_loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forwards alone: the micro-batches' mean of the loss (of
        the outputs without ``compute_loss``), on every stage."""
        s, n = self.stage_id, self.num_stages
        dev = self._device()
        kept = self._run_forward(self._split(data), False, compute_loss)
        total = None
        if s == n - 1:
            for _, out in kept:
                total = out if total is None else total + out
            if compute_loss and self._layers._loss_fn is not None:
                total = self._data_mean(total)
        spec = None
        if self._group is not None and n > 1:
            h = torch.zeros(8, dtype=torch.int64, device=dev)
            if s == n - 1:
                h[0] = total.ndim
                h[1:1 + total.ndim] = torch.tensor(total.shape)
            coll.broadcast(h, n - 1, self._group)
            h = h.cpu().tolist()
            spec = tuple(h[1:1 + h[0]])
        dtype = total.dtype if total is not None else torch.float32
        return self._broadcast_last(total, dev, spec, dtype)


class PipelineParallelWithInterleave(PipelineParallel):
    """Reference pipeline_parallel.py:132: virtual (interleaved) stages.
    The interleaved ring is `spmd_pipeline.pipeline_spmd(...,
    num_chunks=v)` (`models.gpt_pipe.GPTForCausalLMPipe(num_chunks=)`);
    this wrapper keeps the API, and its micro-accumulation's numerics do
    not depend on the schedule."""

    def __init__(self, layers, hcg, strategy=None,
                 num_virtual_pipeline_stages=None):
        super().__init__(layers, hcg, strategy)
        self.num_virtual_stages = int(num_virtual_pipeline_stages or
                                      getattr(layers,
                                              "_num_virtual_stages", 1) or 1)


def pipelined_blocks(block_fn, params_stacked, x, n_microbatch, group=None):
    """Reference :150: `pipeline_spmd` over ``x`` ``[n_microbatch * mb,
    ...]`` with the rank's stage ``params_stacked``."""
    return unmicrobatch(pipeline_spmd(block_fn, params_stacked,
                                      microbatch(x, n_microbatch),
                                      group=group))
