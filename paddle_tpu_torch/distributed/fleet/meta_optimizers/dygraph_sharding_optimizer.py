"""Sharding stage 1 (ZeRO-1): the port of paddle_tpu/distributed/fleet/
meta_optimizers/dygraph_sharding_optimizer.py (:49-132).

The parameters are laid out in the reference's buckets
(`comm_bucketer.build_buckets`: parameter order, one dtype a bucket,
``FLAGS_comm_bucket_mb`` cap, padded to the group's degree); each
parameter becomes a view into its bucket's flat buffer. Rank r owns the
contiguous shard r of every bucket and holds only that shard's fp32
masters (bf16 / fp16 parameters under ``multi_precision``) and moments.
A step runs:

1. the grads' reduce-scatter (mean), one a bucket, unless the model's
   `apply_collective_grads` (stage 2) already left the shards;
2. the guard's non-finite flag and the global clip's sum of squares over
   the rank's shard by one `multi_tensor_norm`, both all-reduced in one
   collective on the device (a rank that sees an inf makes every rank
   skip), the clip scale from the global sum; under model parallelism
   (an ``hcg`` with an mp degree above 1) the blocks' sum and the flag
   are all-reduced over the mp group as well and the replicated
   parameters' sum counted once (`nn.clip.norm_stats`), so every mp
   rank clips by the norm of the global parameters; with a pp degree
   above 1 the sum and the flag are summed over the stages, a stage's
   copy of a shared weight (`nn.clip.is_stage_copy`) left out of the
   sum;
3. `multi_tensor_adam` over the shard, handed one view per parameter
   segment, so each keeps its own parameter's lr scale, decay, L2 and
   ``need_clip`` (AdamW's excluded LayerNorms and biases stay
   undecayed);
4. the ``all_gather`` of each updated shard into its bucket's flat
   parameters, one a bucket.

Under stage 3 (`sharding.GroupShardedStage3`, `_stage3`) the buckets
are laid out again: the parameters of ``segment_size`` bytes or more
first, a bucket never spanning two owning modules, each held as the
rank's `comm_bucketer.FlatShard` between uses; then the small ones as
above, whole on every rank. The model reduce-scatters a stage-3
bucket's grads as they complete (each micro-batch, added into the
shard), so a step is steps 1-3 over shards already there (the small
buckets still scattered at step 1), and step 4 skips the stage-3
buckets: the next forward gathers them. Their values update in the
shard (with offload: copied to the card for the update and back).

Adam and AdamW only (their fused update is what runs on the shards);
``amsgrad`` and ``ClipGradByNorm`` (a per-tensor norm across ranks) are
refused. `state_dict` gathers the full state in the inner optimizer's
format (so ``framework/io.py`` files stay the reference's);
`set_state_dict` takes one and keeps the rank's shards.
"""
from __future__ import annotations

import torch

from ...collective import (ReduceOp, all_gather, all_gather_into,
                           all_reduce, broadcast)
from ...comm_bucketer import (FlatShard, GradBucketer, pack, shard_segments,
                              unpack)

__all__ = ["DygraphShardingOptimizer"]


class DygraphShardingOptimizer:
    def __init__(self, optimizer, hcg=None, group=None):
        from ....nn.clip import ClipGradByGlobalNorm, ClipGradByValue
        from ....optimizer import Adam
        from ...parallel import data_group

        inner = getattr(optimizer, "_inner_opt", optimizer)
        if not isinstance(inner, Adam):
            raise NotImplementedError(
                "sharding stage 1 runs the fused Adam/AdamW update on the "
                f"rank's shard; {type(inner).__name__} is not supported")
        if inner._amsgrad:
            raise NotImplementedError("amsgrad under sharding")
        clip = inner._grad_clip
        if clip is not None and type(clip) not in (ClipGradByGlobalNorm,
                                                   ClipGradByValue):
            raise NotImplementedError(
                f"{type(clip).__name__} under sharding: each tensor's own "
                "norm spans ranks; use ClipGradByGlobalNorm or "
                "ClipGradByValue")
        if group is None:
            group = (hcg.get_sharding_data_group() if hcg is not None
                     else data_group())
        self._inner_opt = inner
        self._group = group
        self._mp_group = (hcg.get_model_parallel_group() if hcg is not None
                          and hcg.get_model_parallel_world_size() > 1
                          else None)
        self._pp_group = (hcg.get_pipe_parallel_group() if hcg is not None
                          and hcg.get_pipe_parallel_world_size() > 1
                          else None)
        self._params = [p for p in inner._parameter_list if p.requires_grad]
        self._keyed = [(inner._key(p), p) for p in self._params]
        self._by_key = dict(self._keyed)
        self._rank = group.rank
        self._s3 = []           # stage 3: a FlatShard a sharded bucket
        self._lay_out(self._keyed)
        self._state = None      # per bucket: (master or None, m, v)
        self._lists = None      # the update's views (`_update_lists`)

    @torch.no_grad()
    def _lay_out(self, keyed, tags=None):
        """Buckets over ``keyed`` (in that order; ``tags``:
        `build_buckets`'), one flat buffer each, every parameter a view
        into its bucket's, every rank from rank 0's values."""
        group, n = self._group, self._group.nranks
        self._bucketer = GradBucketer(keyed, group, tags=tags)
        self._flat = []
        for b in self._bucketer.assignment.buckets:
            flat = pack(b, lambda k: self._by_key[k].detach())
            for k, v in unpack(flat, b).items():
                self._by_key[k].data = v
            self._flat.append(flat)
        if n > 1:
            for flat in self._flat:
                broadcast(flat, 0, group)
        self._segs = [shard_segments(b, self._rank, n)
                      for b in self._bucketer.assignment.buckets]

    def _stage3(self, owner, segment_size, offload=False):
        """Lay the buckets out for stage 3 (before the first step): the
        parameters of ``segment_size`` bytes or more first, grouped by
        ``owner(parameter)`` (a bucket never spans two owners), then the
        rest. Returns the sharded buckets' `FlatShard` s, released."""
        if self._state is not None:
            raise RuntimeError("stage 3 lays the buckets out before the "
                               "optimizer's first step")
        big = [(k, p) for k, p in self._keyed
               if p.numel() * p.element_size() >= segment_size]
        small = [(k, p) for k, p in self._keyed
                 if p.numel() * p.element_size() < segment_size]
        order = {}
        for _, p in big:
            order.setdefault(owner(p), len(order))
        big.sort(key=lambda kp: order[owner(kp[1])])
        tags = [order[owner(p)] for _, p in big] + [-1] * len(small)
        self._lay_out(big + small, tags)
        sharded = {k for k, _ in big}
        n3 = sum(1 for b in self._bucketer.assignment.buckets
                 if b.entries[0].key in sharded)
        self._s3 = [FlatShard(self._flat[bi], self._rank, self._group,
                              offload) for bi in range(n3)]
        self._lists = None
        for st in self._s3:
            st.release()
        return self._s3

    # -- the wrapped optimizer's surface --------------------------------
    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def _comm_group(self):
        return self._group

    def grad_bucket_assignment(self):
        return self._bucketer.assignment

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None

    # -- shards ------------------------------------------------------------
    def _shard(self, t, b):
        s = self._bucketer.assignment.buckets[b].numel // self._group.nranks
        return t[self._rank * s:(self._rank + 1) * s]

    def _values(self, bi):
        """Bucket ``bi``'s values on this rank, on the card: its slice of
        the flat buffer, or a stage-3 bucket's `FlatShard.device_values`
        (filled by `_stage_in` when offloaded)."""
        if bi < len(self._s3):
            return self._s3[bi].device_values
        return self._shard(self._flat[bi], bi)

    def _stage_in(self):
        for st in self._s3:
            st.stage_in()

    def _stage_out(self):
        for st in self._s3:
            st.stage_out()

    def _materialize(self):
        if self._state is not None:
            return
        opt = self._inner_opt
        self._state = []
        for bi, b in enumerate(self._bucketer.assignment.buckets):
            p0 = self._by_key[b.entries[0].key]
            shard = (self._s3[bi].values() if bi < len(self._s3)
                     else self._shard(self._flat[bi], bi))
            master = (shard.float().clone() if opt._use_master(p0)
                      else None)
            md = opt._moment_dtype or (torch.float32 if opt._use_master(p0)
                                       else p0.dtype)
            self._state.append((master,
                                torch.zeros_like(shard, dtype=md),
                                torch.zeros_like(shard, dtype=md)))

    def _views(self, bi, t):
        """``t`` (a shard of bucket ``bi``) as one view a segment."""
        b = self._bucketer.assignment.buckets[bi]
        start = self._rank * (b.numel // self._group.nranks)
        return [t[e.offset + lo - start:e.offset + hi - start]
                for e, lo, hi in self._segs[bi]]

    def _grad_shards(self):
        """Every bucket's grad shard: those the model already scattered
        (stage 2's all, stage 3's sharded buckets), the rest scattered
        now."""
        have = self._bucketer.shards
        missing = [b for b in self._bucketer.assignment.buckets
                   if have is None or have[b.index] is None]
        if missing:
            self._bucketer.reduce_scatter(average=True, buckets=missing)
        return self._bucketer.shards

    def _segment_params(self):
        return [self._by_key[e.key] for segs in self._segs
                for e, _, _ in segs]

    @torch.no_grad()
    def _sharded_grad_sq(self, params, inv_scale=None):
        """Each of ``params``' global grad squared norm (unscaled by
        ``inv_scale``), from the rank's shards and one all-reduce: the
        numerics monitor's grad rows."""
        self._materialize()
        return self._sum_sq(params, self._update_lists(
            self._grad_shards())[1], inv_scale)

    def _sum_sq(self, params, segs, inv_scale=None):
        """Each of ``params``' squared norm over ``segs`` (one view a
        segment of the rank's shards, in the update's order) summed over
        the group."""
        seg_params = self._update_lists(self._bucketer.shards)[0]
        index = {id(p): i for i, p in enumerate(params)}
        dev = self._flat[0].device
        out = torch.zeros(len(params), dtype=torch.float32, device=dev)
        rows = [index.get(id(p), -1) for p in seg_params]
        keep = [j for j, i in enumerate(rows) if i >= 0]
        if keep:
            sq = torch.stack(torch._foreach_norm(
                [segs[j] for j in keep], 2, dtype=torch.float32)).square()
            if inv_scale is not None:
                sq = sq * inv_scale * inv_scale
            out.index_add_(0, torch.tensor([rows[j] for j in keep],
                                           device=dev), sq)
        all_reduce(out, ReduceOp.SUM, self._group)
        return out

    @torch.no_grad()
    def _stage3_rows(self, params, inv_scale=None):
        """Stage 3's numerics rows before the update, every norm from the
        shards (the parameters are not whole): the grads' and the
        values' squared norms, and a copy of the values' shards."""
        g_sq = self._sharded_grad_sq(params, inv_scale)
        self._stage_in()
        values = self._update_lists(self._bucketer.shards)[2]
        rows = (g_sq, self._sum_sq(params, values),
                [v.clone() for v in values])
        self._stage_out()
        return rows

    @torch.no_grad()
    def _stage3_update_sq(self, params, old):
        """Each of ``params``' update's squared norm from the copy
        `_stage3_rows` kept."""
        self._stage_in()
        values = self._update_lists(self._bucketer.shards)[2]
        torch._foreach_sub_(old, values)
        self._stage_out()
        return self._sum_sq(params, old)

    # -- the step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._run(None, guard=False)

    @torch.no_grad()
    def _guarded_step(self, inv_scale=None):
        return self._run(inv_scale, guard=True)

    def _update_lists(self, shards):
        """(parameters, grads, values, masters, m, v) of the update, one
        view a segment, built once: every tensor they view (the grad
        shards included: `GradBucketer` keeps them) lives for the whole
        run, so the update's kernel tables are built once too."""
        if self._lists is None:
            lists = [self._segment_params(), [], [], [], [], []]
            for bi in range(len(self._segs)):
                master, m, v = self._state[bi]
                lists[1] += self._views(bi, shards[bi])
                lists[2] += self._views(bi, self._values(bi))
                lists[3] += (self._views(bi, master) if master is not None
                             else [None] * len(self._segs[bi]))
                lists[4] += self._views(bi, m)
                lists[5] += self._views(bi, v)
            self._lists = lists
        return self._lists

    def _run(self, inv_scale, guard):
        from ....nn.clip import (ClipGradByGlobalNorm, ClipGradByValue,
                                 is_block, is_stage_copy, norm_stats)
        from ....ops.kernels.multi_tensor import (multi_tensor_adam,
                                                  multi_tensor_norm)

        opt = self._inner_opt
        self._materialize()
        shards = self._grad_shards()
        self._bucketer.shards = None
        params, grads, values, masters, ms, vs = self._update_lists(shards)
        need = [getattr(p, "need_clip", True) for p in params]
        clip = opt._grad_clip
        global_clip = type(clip) is ClipGradByGlobalNorm
        found = scale = None
        dev = self._flat[0].device
        if guard or global_clip:
            # a stage's copy of a shared weight counts once, on the first
            counted = [global_clip and c and not is_stage_copy(p)
                       for p, c in zip(params, need)]
            _, scale, found = norm_stats(
                grads, counted, inv_scale,
                clip.clip_norm if global_clip else None, self._group, dev,
                [is_block(p) for p in params], self._mp_group,
                self._pp_group)
            if not guard:
                found = None
            if not global_clip:
                scale = None
        if type(clip) is ClipGradByValue:
            if inv_scale is not None:
                multi_tensor_norm(grads, inv_scale=inv_scale, write=True,
                                  device=dev)
                inv_scale = None
            for g, c in zip(grads, need):
                if c:
                    g.clamp_(clip.min, clip.max)
        self._stage_in()
        multi_tensor_adam(
            values, grads, masters, ms, vs, lr=opt.get_lr(),
            beta1=opt._beta1, beta2=opt._beta2, eps=opt._epsilon,
            step=opt._step_tensor(),
            lr_scales=[opt._param_lr_scale(p) for p in params],
            wds=[opt._decoupled_wd(p) for p in params],
            l2s=[opt._l2_coeff(p) for p in params], need_clip=need,
            found_inf=found, inv_scale=inv_scale, clip_scale=scale)
        self._stage_out()
        for st in self._s3:     # the next forward gathers the rest
            st.refresh()
        for bi in range(len(self._s3), len(self._flat)):
            flat = self._flat[bi]
            all_gather_into(flat, self._shard(flat, bi), self._group)
        return found

    # -- state dict -----------------------------------------------------------
    def _full(self, bi, t):
        """Bucket ``bi``'s shard ``t`` gathered whole: {key: tensor}."""
        b = self._bucketer.assignment.buckets[bi]
        whole = all_gather(None, t.contiguous(), self._group).reshape(-1)
        return {k: v.clone() for k, v in unpack(whole, b).items()}

    def state_dict(self):
        opt = self._inner_opt
        state = {"accumulators": {"moment1": {}, "moment2": {}},
                 "master_weights": {}, "step": opt._step_count}
        if self._state is not None:
            for bi, (master, m, v) in enumerate(self._state):
                state["accumulators"]["moment1"].update(self._full(bi, m))
                state["accumulators"]["moment2"].update(self._full(bi, v))
                if master is not None:
                    state["master_weights"].update(self._full(bi, master))
        from ....optimizer.lr import LRScheduler

        if isinstance(opt._learning_rate, LRScheduler):
            state["LR_Scheduler"] = opt._learning_rate.state_dict()
        return state

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        opt = self._inner_opt
        self._materialize()
        acc = state_dict.get("accumulators", {})
        mws = state_dict.get("master_weights", {})
        for bi, b in enumerate(self._bucketer.assignment.buckets):
            master, m, v = self._state[bi]
            for name, t in (("moment1", m), ("moment2", v)):
                store = acc.get(name, {})
                if all(e.key in store for e in b.entries):
                    whole = pack(b, lambda k: torch.as_tensor(
                        store[k]).to(t.device), dtype=t.dtype)
                    t.copy_(self._shard(whole, bi))
            if master is not None and all(e.key in mws for e in b.entries):
                whole = pack(b, lambda k: torch.as_tensor(mws[k]).to(
                    master.device), dtype=torch.float32)
                master.copy_(self._shard(whole, bi))
        opt._step_count = state_dict.get("step", 0)
        from ....optimizer.lr import LRScheduler

        if "LR_Scheduler" in state_dict and isinstance(opt._learning_rate,
                                                       LRScheduler):
            opt._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict

