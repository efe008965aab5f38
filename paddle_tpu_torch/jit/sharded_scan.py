"""The sharded fused-scan step: the port of paddle_tpu/jit/sharded_scan.py's
``ShardedFusedScanTrainStep`` for the data and sharding axes, and its
``select_train_step``.

    env.init_parallel_env()                    # NCCL on cuda:LOCAL_RANK
    step = ShardedFusedScanTrainStep(model, opt, fused_head=True,
                                     compute_dtype="bfloat16")
    loss = step(*env.data_shard((ids, labels)))   # the group's mean loss

`jit.FusedScanTrainStep` across ranks. Each rank runs its rows of the
global batch; grads, moments, masters and the update are 1/N-sharded
over the group (Xu et al., "Automatic Cross-Replica Sharding of Weight
Update in Data-Parallel Training"). The stacked parameters are bucketed
by their per-layer shapes and the outer ones (embeddings, ln_f, head) by
their shapes, with `distributed.comm_bucketer.build_buckets`
(``FLAGS_comm_bucket_mb`` cap, one dtype a bucket, padded to N, or to
N x 32 under ``comm_quant``); rank r owns the contiguous shard r of
every bucket. One call runs, in the reference's order:

1. the forward without autograd over the rank's rows, keeping each
   chunk's input;
2. the head with autograd (as the base step);
3. one backward, chunks in reverse: each chunk recomputed with autograd
   from its input, its grads packed a layer at a time into the bucket
   layout and reduce-scattered (one collective a bucket a layer),
   divided by N: only the shards outlive the chunk (reference
   :1281-1456); then the embedding's and head's grads, packed and
   reduce-scattered the same way;
4. the clip and the guard: one `nn.clip.norm_stats` over every shard,
   whose sum of squares and non-finite flag ride one all-reduce; the
   clip scale from the global sum (reference :1204-1235);
5. the update, chunks in reverse: one `multi_tensor_adam` (``bump=False``)
   over the chunk's shards, handed one view a parameter segment so each
   keeps its own lr scale, decay and ``need_clip``; then the outer one
   (``bump=True``);
6. the guard state, the scheduler, and the loss all-reduced to the
   group's mean (the rank's own stays in ``local_loss``).

``param_storage`` (default ``FLAGS_param_storage``, else "sharded"):

* "replicated": every parameter is a view into its bucket's flat buffer
  (``[L, F]`` for the stack, ``[F]`` outside it), so packing costs no
  copy; after each chunk's update its rows' shards are all-gathered back
  in place;
* "sharded": the trainable parameters live as the rank's ``[L, F/N]``
  and ``[F/N]`` shards between steps (the reference's default,
  :1457-1643): each chunk is all-gathered on use in the forward and again
  in the backward's recompute, the update writes the shards, and the
  parameters' own storage is freed. A read of ``model.parameters()``,
  ``named_parameters()`` or ``state_dict()`` gathers them back lazily
  (reference :179-235); the next step packs whatever they then hold into
  the shards and frees them again.

Both storages run the same arithmetic on the same shards: their losses
and parameters are bit-identical (reference :15-16). Hidden dropout
draws from a generator of the step's own, seeded from the process seed
with the rank folded in (reference :501), so ranks draw distinct masks
that repeat for a seed; the recompute replays each chunk's masks as the
base step does. With ``numerics`` each rank fills its partial stats block
(grad, parameter and update rows from its shards, activations from its
rows) and one all-reduce sums the partials, as the reference's host fold
sums its stacked rank blocks.

``comm_quant`` (default ``FLAGS_comm_quant``) takes the compressed wire
format on the scatter leg and the sharded storage's gather-on-use.
Degree 1 is allowed (the same collectives over a one-rank group: the
card's world-1 check).

dp x mp (``mp_axis``, by default the mesh's ``mp`` axis when its degree
is above 1; reference :530-787): Megatron tensor parallelism inside each
layer. The buckets hold the global parameters and scatter over the
flattened (data axes, mp) group, mp fastest, so the optimizer state is
1/(dp x mp)-sharded. Each rank binds its block of every sliced leaf into
a copy of the template block (`convert.mp_block` by the roles of
`distributed.fleet.layers.mpu.roles`: qkv by heads, fc1 by output
column, out_proj and fc2 by input column), whose Linears become the
mpu layers `ColumnParallelLinear` (no gather) and `RowParallelLinear`
(input parallel): Megatron's f and g over the mp group, with the
attention's heads narrowed to nh/mp. The LM head is vocab-parallel: ln_f on the replicated hiddens,
then `ops.kernels.fused_cross_entropy.sharded_fused_cross_entropy` over
the rank's rows ``[r * V/mp, (r+1) * V/mp)`` of the ``[V, H]`` head
(tied or not: the port's untied head is ``[V, H]`` too). A sliced
leaf's grad is exact and zero outside its block; a replicated leaf's
(the LayerNorms, the row-parallel biases, ``wpe``, ``ln_f``, the
embedding's part of ``wte``) is whole on every mp rank, so it is scaled
by 1/mp before the scatter, and the scattered sums are divided by the
data degree: every gradient is the global batch's mean. Hidden dropout
folds in the data index alone, so an mp group draws one mask. Refused,
as the reference refuses them: heads or vocab not divisible by mp,
attention dropout, a criterion other than `GPTPretrainingCriterion`;
and draft heads, which the port refuses where the reference drops their
loss without a word (its vocab-parallel head carries the LM loss alone,
reference :756-786).

dp x pp: `jit.pipeline_step.PipelineScanTrainStep` (this step's
subclass) adds the ``pp`` axis to the group the grads scatter over
(`_extra_reduction_axes`) and replaces the grads' phases 1-3 with the
pipeline ring; `select_train_step` routes a scan GPT on a mesh whose pp
degree is above 1 there.

Refused, naming ROADMAP A9b: ``ep_axis``, a mesh with an ep degree
above 1 and an MoE model (A9b.3b: its aux loss is not threaded through
this step; `select_train_step` gives a world of one `FusedScanTrainStep`,
which trains it), a sep degree above 1 (A9b.5b), and a pp degree above
1 here (the pipelined step takes it); `select_train_step` also refuses
``auto=True`` (the auto-tuner, A9b.6).
"""
from __future__ import annotations

import copy

import torch
from torch.func import functional_call

from ..convert import mp_block
from ..distributed import collective as coll
from ..distributed import env as denv
from ..distributed.comm_bucketer import (MB, build_buckets, pack,
                                         shard_segments, unpack)
from ..distributed.fleet.layers.mpu.mp_layers import (ColumnParallelLinear,
                                                       RowParallelLinear)
from ..distributed.fleet.layers.mpu.mp_ops import c_identity
from ..distributed.fleet.layers.mpu.roles import assign_roles, is_fused_proj
from ..incubate.distributed.models.moe.moe_layer import A9B3B, refuse_moe
from ..nn.clip import norm_stats
from ..observability.numerics import assemble_stats, outer_row
from ..ops.kernels.fused_cross_entropy import sharded_fused_cross_entropy
from ..ops.kernels.multi_tensor import multi_tensor_adam, multi_tensor_norm
from ..utils import flags as _flags
from .fused_scan_step import FusedScanTrainStep, _rng_state, _set_rng_state

__all__ = ["ShardedFusedScanTrainStep", "is_scan_gpt", "select_train_step"]

A9B = ("{} is not ported yet: ROADMAP A9b; the port runs the dp, sharding, "
       "mp and pp axes")


def _unwrap_layers(model):
    """Follow wrapper chains (GroupShardedStage2, ShardingParallel,
    DataParallel) to the module that owns the parameters."""
    seen = set()
    while hasattr(model, "_layers") and id(model) not in seen:
        seen.add(id(model))
        model = model._layers
    return model


def _mesh_axes(mesh, axis=None, mp_axis=None, extra=()):
    """(the batch axes, the mp axis or None) of ``mesh``; an ``mp_axis``
    of degree 1 is dropped, as the reference drops it (:316-318). A pp
    degree above 1 needs the pipelined step (``extra`` names the axes it
    adds)."""
    if mesh.shape.get("ep", 1) > 1:
        raise NotImplementedError(A9B3B.format("the ep axis"))
    if mesh.shape.get("sep", 1) > 1:
        raise NotImplementedError(
            "the sep axis under the fused scan steps is not ported yet: "
            "ROADMAP A9b.5b (SegmentParallel trains a model that is not a "
            "scan_layers GPT)")
    if mesh.shape.get("pp", 1) > 1 and "pp" not in extra:
        raise ValueError(
            "a mesh with a pp degree above 1 runs the pipeline ring: use "
            "jit.PipelineScanTrainStep (select_train_step routes there)")
    if mp_axis is None:
        mp_axis = "mp" if mesh.shape.get("mp", 1) > 1 else None
    elif mesh.shape.get(mp_axis, 1) <= 1:
        mp_axis = None
    axes = denv.data_axes(mesh, axis)
    if not axes:
        axes = tuple(a for a in ("dp", "sharding") if a in mesh.shape) \
            or (mesh.axis_names[0],)
    if mp_axis is not None and mp_axis in axes:
        raise ValueError(f"mp_axis {mp_axis!r} is also the batch axis; "
                         "build the mesh with a data axis (degree 1 is "
                         "fine), e.g. build_mesh({'dp': 1, 'mp': N})")
    return axes, mp_axis


def _resolve_group(mesh=None, axis=None, group=None, mp_axis=None,
                   extra=()):
    """(the group the grads scatter over, the mp group or None): the
    flattened (batch axes and ``extra`` axes in the mesh's order, mp)
    group, mp fastest. (A group's ranks run in the order of global rank,
    as ``torch.distributed`` orders them: the mesh's order.)"""
    if group is not None:
        return group, None
    mesh = mesh or denv.get_mesh()
    axes, mp_axis = _mesh_axes(mesh, axis, mp_axis, extra)
    if extra:
        axes = tuple(a for a in mesh.axis_names
                     if a in axes or a in extra) + tuple(
            a for a in axes if a not in mesh.axis_names)
    if mp_axis is None:
        if mesh.degree(axes) == mesh.size:
            return coll.get_group(), None
        return coll.new_group(axes=axes, mesh=mesh), None
    return (coll.new_group(axes=axes + (mp_axis,), mesh=mesh),
            coll.new_group(axes=(mp_axis,), mesh=mesh))


class ShardedFusedScanTrainStep(FusedScanTrainStep):
    def __init__(self, model, optimizer, criterion=None, fused_head=False,
                 compute_dtype=None, layer_chunk=1, scan_unroll=1,
                 mesh=None, axis=None, mp_axis=None, ep_axis=None,
                 group=None, comm_bucket_mb=None, comm_quant=None,
                 scaler=None, guard_nonfinite=None, param_storage=None,
                 numerics=None):
        if ep_axis is not None:
            raise NotImplementedError(A9B3B.format("ep_axis (MoE experts)"))
        model = _unwrap_layers(model)
        refuse_moe(model, "ShardedFusedScanTrainStep")
        super().__init__(model, optimizer, criterion=criterion,
                         fused_head=fused_head, compute_dtype=compute_dtype,
                         layer_chunk=layer_chunk, scan_unroll=scan_unroll,
                         scaler=scaler, guard_nonfinite=guard_nonfinite,
                         numerics=numerics)
        extra = ()
        if group is None:
            mesh = mesh or denv.get_mesh()
            extra = self._extra_reduction_axes(mesh)
        self.group, self.mp_group = _resolve_group(mesh, axis, group,
                                                   mp_axis, extra)
        self._n = self.group.nranks
        self._rank = self.group.rank
        self._mp_n = 1 if self.mp_group is None else self.mp_group.nranks
        # the index over the batch axes and their count (the group is
        # mp fastest)
        inner = self._mp_n * self._pp_degree
        self._data_n = self._n // inner
        self._batch_rank = self._rank // inner
        if group is None:
            axes = _mesh_axes(mesh, axis, mp_axis, extra)[0]
            self._batch_rank = mesh.axis_index(axes)
        self._mp_kinds = None
        if self.mp_group is not None:
            self._setup_mp()
        if comm_quant is None:
            comm_quant = _flags.get_flag("FLAGS_comm_quant") or ""
        if comm_quant not in ("", "int8", "bf16"):
            raise ValueError(f"comm_quant {comm_quant!r} (int8|bf16|'')")
        self._quant = comm_quant
        if param_storage is None:
            param_storage = (_flags.get_flag("FLAGS_param_storage")
                             or "sharded")
        if param_storage not in ("sharded", "replicated"):
            raise ValueError(
                f"param_storage {param_storage!r} (sharded|replicated)")
        self._param_storage = param_storage
        if comm_bucket_mb is None:
            comm_bucket_mb = int(_flags.get_flag("FLAGS_comm_bucket_mb")
                                 or 0)
        cap = comm_bucket_mb * MB if comm_bucket_mb > 0 else 1 << 62
        pad = self._n * (coll.QUANT_BLOCK if comm_quant else 1)
        self._s_train = [j for j, p in enumerate(self._s_params)
                         if p.requires_grad]
        self._s_assign = build_buckets(
            [(j, tuple(self._s_params[j].shape[1:]),
              self._s_params[j].dtype) for j in self._s_train],
            bucket_bytes=cap, pad_multiple=pad)
        self._o_list = [p for _, p in self._o_params]
        self._o_assign = build_buckets(
            [(j, tuple(p.shape), p.dtype) for j, p in enumerate(self._o_list)],
            bucket_bytes=cap, pad_multiple=pad)
        self._s_segs = [shard_segments(b, self._rank, self._n)
                        for b in self._s_assign.buckets]
        self._o_segs = [shard_segments(b, self._rank, self._n)
                        for b in self._o_assign.buckets]
        self._built = False
        self._materialized = False
        self._bufs = {}             # reused step after step (`_buffer`)
        self._rng = None
        self.collectives_per_step = None
        self.local_loss = None

    _pp_degree = 1

    def _extra_reduction_axes(self, mesh):
        """Axes past the batch axes the grads scatter over (before mp):
        none here; the pipelined step adds ``pp``."""
        return ()

    # -- Megatron tensor parallelism over the mp group -------------------
    def _setup_mp(self):
        """The refusals (reference :538-557), each stacked leaf's kind
        (`convert.mp_block`; None: replicated) and the step's own copy
        of the template block with its Linears bound to the mp group."""
        from ..models.gpt import GPTPretrainingCriterion

        mp, cfg = self._mp_n, self.model.config
        if cfg.num_attention_heads % mp:
            raise ValueError(f"num_attention_heads {cfg.num_attention_heads}"
                             f" not divisible by the mp degree {mp}")
        if cfg.vocab_size % mp:
            raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by "
                             f"the mp degree {mp} (vocab-parallel LM head)")
        if cfg.attention_dropout_prob:
            raise ValueError(
                "attention dropout under mp > 1 would draw one mask stream "
                "for every rank's heads; train with attention_dropout_prob"
                "=0 (hidden dropout is fine)")
        if type(self._crit) is not GPTPretrainingCriterion:
            raise ValueError(
                "mp > 1 routes the LM head through the vocab-parallel fused "
                "CE; custom criteria are not representable there: use the "
                "default GPTPretrainingCriterion")
        if self.model.draft_heads is not None:
            raise ValueError("draft heads under mp > 1: the vocab-parallel "
                             "head carries the LM loss alone")
        tmpl = copy.deepcopy(self._template)
        roles = assign_roles(tmpl)
        subs = dict(tmpl.named_modules())
        kinds = []
        for _, pname in self._blocks._stacked_names:
            path, leaf = pname.rsplit(".", 1)
            sub = subs[path]
            role = roles.get(id(sub))
            kind = None
            if role == "column":
                parent = subs[path.rsplit(".", 1)[0] if "." in path else ""]
                if is_fused_proj(sub, attr_name=path.rsplit(".", 1)[-1]):
                    nh = getattr(parent, "num_heads", None)
                    hd = getattr(parent, "head_dim", None)
                    if not (nh and hd):
                        raise ValueError(
                            f"{pname}: a fused q|k|v Linear needs a parent "
                            "with num_heads / head_dim for its heads' block")
                    kind = ("heads", 0, nh, hd)
                else:
                    kind = ("split", 0)
            elif role == "row" and leaf == "weight":
                kind = ("split", 1)
            kinds.append(kind)
        for m in subs.values():
            role = roles.get(id(m))
            if role == "column":
                m.__class__, m.gather_output = ColumnParallelLinear, False
            elif role == "row":
                m.__class__, m.input_is_parallel = RowParallelLinear, True
            if role is not None:
                m._group = self.mp_group
            nh = getattr(m, "num_heads", None)
            if isinstance(nh, int) and hasattr(m, "head_dim"):
                m.num_heads = nh // mp
        self._mp_template = tmpl
        self._mp_kinds = kinds
        self._mp_replicated = {j for j, k in enumerate(kinds) if k is None}

    def mp_plan(self):
        """{state-dict name: kind} of the leaves this rank holds a block
        of (the stacked ones' dims past the layer dim), for
        `convert.mp_block`."""
        if self._mp_kinds is None:
            return {}
        prefix = next(n for n, p in self.model.named_parameters()
                      if p is self._s_params[0]).rsplit(".", 1)[0]
        plan = {}
        for (flat, _), kind in zip(self._blocks._stacked_names,
                                   self._mp_kinds):
            if kind is not None:
                plan[f"{prefix}.{flat}"] = (kind[0], kind[1] + 1) + kind[2:]
        head = "gpt.wte.weight" if self.model.lm_head is None \
            else "lm_head.weight"
        plan[head] = ("split", 0)
        return plan

    def _chunk(self, layers, h, seg):
        if self.mp_group is None:
            return super()._chunk(layers, h, seg)
        r, n = self.mp_group.rank, self._mp_n
        names = [pname for _, pname in self._blocks._stacked_names]
        for leaves in layers:
            h = functional_call(
                self._mp_template,
                {name: self._cc(mp_block(t, kind, r, n))
                 for name, t, kind in zip(names, leaves, self._mp_kinds)},
                (h, seg))
        return h

    def _head(self, o, x, labels):
        """Under mp: ln_f, then the vocab-parallel fused CE over this
        rank's rows of the head, the hiddens' grad summed over the mp
        group; the criterion's mean over the labels that are not -100."""
        if self.mp_group is None:
            return super()._head(o, x, labels)
        m, g = self.model, self.mp_group
        h = functional_call(m.gpt.ln_f,
                            {"weight": self._cc(o["gpt.ln_f.weight"]),
                             "bias": self._cc(o["gpt.ln_f.bias"])}, (x,))
        w = o["gpt.wte.weight"] if m.lm_head is None else o["lm_head.weight"]
        vloc = w.shape[0] // self._mp_n
        hid = c_identity(h.reshape(-1, h.shape[-1]), g)
        lbl = labels.reshape(-1)
        losses = sharded_fused_cross_entropy(
            hid, self._cc(w[g.rank * vloc:(g.rank + 1) * vloc]).contiguous(),
            lbl, g.rank * vloc, g)
        mask = (lbl != -100).to(losses.dtype)
        return (losses * mask).sum() / mask.sum().clamp(min=1.0)

    # -- layout ----------------------------------------------------------
    def _slen(self, b):
        return b.numel // self._n

    def _seg_views(self, segs, b, t):
        """``t`` (``[..., F/N]``, rank's shard of bucket ``b``) as one view
        a segment, along its last dim."""
        start = self._rank * self._slen(b)
        return [t[..., e.offset + lo - start:e.offset + hi - start]
                for e, lo, hi in segs]

    def _seg_params(self, segs, group):
        src = self._s_params if group == "s" else self._o_list
        return [src[e.key] for e, _, _ in segs]

    @torch.no_grad()
    def _build(self):
        """The flat buffers, the shards and the optimizer's sharded state,
        from the parameters as they are now."""
        L = self.model.config.num_layers
        s_assign, o_assign = self._s_assign, self._o_assign
        s_of = lambda j: self._s_params[j].detach()  # noqa: E731
        o_of = lambda j: self._o_list[j].detach()  # noqa: E731
        s_flat = [pack(b, s_of, lead=(L,)) for b in s_assign.buckets]
        o_flat = [pack(b, o_of) for b in o_assign.buckets]
        r = self._rank

        def rows(flat, b):
            s = self._slen(b)
            return flat[..., r * s:(r + 1) * s]

        if self._param_storage == "replicated":
            self._s_flat, self._o_flat = s_flat, o_flat
            for b, flat in zip(s_assign.buckets, s_flat):
                for j, v in unpack(flat, b).items():
                    self._s_params[j].data = v
            for b, flat in zip(o_assign.buckets, o_flat):
                for j, v in unpack(flat, b).items():
                    self._o_list[j].data = v
            self._s_p = [rows(f, b) for f, b in zip(s_flat,
                                                    s_assign.buckets)]
            self._o_p = [rows(f, b) for f, b in zip(o_flat,
                                                    o_assign.buckets)]
        else:
            self._s_p = [rows(f, b).clone() for f, b in
                         zip(s_flat, s_assign.buckets)]
            self._o_p = [rows(f, b).clone() for f, b in
                         zip(o_flat, o_assign.buckets)]
            del s_flat, o_flat
            self._free_params()
        self._s_state = [self._bucket_state(p, b, "s")
                         for p, b in zip(self._s_p, s_assign.buckets)]
        self._o_state = [self._bucket_state(p, b, "o")
                         for p, b in zip(self._o_p, o_assign.buckets)]
        if self._param_storage == "sharded":
            self._wrap_reads()
        self._built = True

    def _bucket_state(self, shard, b, group):
        """(fp32 master shard or None, m shard, v shard) of bucket ``b``."""
        opt = self._opt
        p0 = (self._s_params if group == "s" else self._o_list)[
            b.entries[0].key]
        use_mw = opt._use_master(p0)
        md = opt._moment_dtype or (torch.float32 if use_mw else p0.dtype)
        return (shard.float().clone() if use_mw else None,
                torch.zeros_like(shard, dtype=md),
                torch.zeros_like(shard, dtype=md))

    def _buffer(self, key, numel, dtype, dev):
        """A buffer made once and reused: the pack of a bucket's grads,
        the gathered bucket of a chunk's layer. Reuse is safe in stream
        order: a collective waits for the work queued before it, and the
        work after it for the collective."""
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(numel, dtype=dtype,
                                                device=dev)
        return buf

    # -- sharded storage: free, gather lazily, repack --------------------
    def _stored(self):
        return ([self._s_params[j] for j in self._s_train] + self._o_list)

    def _free_params(self):
        """Each stored parameter's data becomes a tensor of its shape with
        no storage (what it held goes back to the allocator once nothing
        else refers to it)."""
        for p in self._stored():
            e = torch.empty(p.shape, dtype=p.dtype, device=p.device)
            e.untyped_storage().resize_(0)
            p.data = e
        self._materialized = False

    def _gather_s(self, bi, i, quant=None):
        """Bucket ``bi``'s layer ``i`` gathered whole: ``[F]``."""
        b = self._s_assign.buckets[bi]
        shard = self._s_p[bi][i]
        q = self._quant if quant is None else quant
        if q:
            return coll.quantized_all_gather(shard, self.group, q)
        out = self._buffer(("gather", bi, i % self._layer_chunk), b.numel,
                           shard.dtype, shard.device)
        return coll.all_gather_into(out, shard, self.group)

    def _gather_o(self, bi, quant=None):
        b = self._o_assign.buckets[bi]
        shard = self._o_p[bi]
        q = self._quant if quant is None else quant
        if q:
            return coll.quantized_all_gather(shard, self.group, q)
        out = self._buffer(("gather_o", bi), b.numel, shard.dtype,
                           shard.device)
        return coll.all_gather_into(out, shard, self.group)

    @torch.no_grad()
    def full_params(self):
        """Gather the shard-stored parameters back into their own storage
        (exact gathers). Every rank must call it: it is collective."""
        if self._param_storage != "sharded" or self._materialized \
                or not self._built:
            return
        L = self.model.config.num_layers
        for p in self._stored():
            p.data = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        for bi, b in enumerate(self._s_assign.buckets):
            for i in range(L):
                for j, v in unpack(self._gather_s(bi, i, ""), b).items():
                    self._s_params[j].data[i].copy_(v)
        for bi, b in enumerate(self._o_assign.buckets):
            for j, v in unpack(self._gather_o(bi, ""), b).items():
                self._o_list[j].data.copy_(v)
        self._materialized = True

    @torch.no_grad()
    def _repack(self):
        """Parameters gathered since the last step (and maybe written):
        their shards from what they hold now, then their storage freed."""
        L = self.model.config.num_layers
        r = self._rank
        for bi, b in enumerate(self._s_assign.buckets):
            s = self._slen(b)
            flat = pack(b, lambda j: self._s_params[j].detach(), lead=(L,))
            self._s_p[bi].copy_(flat[:, r * s:(r + 1) * s])
        for bi, b in enumerate(self._o_assign.buckets):
            s = self._slen(b)
            flat = pack(b, lambda j: self._o_list[j].detach())
            self._o_p[bi].copy_(flat[r * s:(r + 1) * s])
        self._free_params()

    def _wrap_reads(self):
        """``model.parameters()`` / ``named_parameters()`` /
        ``state_dict()`` gather the shard-stored parameters first."""
        model, step = self.model, self

        def wrap(name):
            orig = getattr(type(model), name)

            def read(*a, **k):
                step.full_params()
                return orig(model, *a, **k)

            read.__doc__ = orig.__doc__
            object.__setattr__(model, name, read)

        for name in ("named_parameters", "state_dict"):
            wrap(name)

    # -- the layer leaves -------------------------------------------------
    def _layer_leaves(self, i, grad):
        """Layer ``i``'s leaves (one a stacked parameter, template order):
        a view of each stacked parameter (replicated), or of the layer's
        gathered buckets (sharded), detached; trainable ones
        ``requires_grad`` with ``grad``."""
        if self._param_storage == "replicated":
            leaves = [p.detach()[i] for p in self._s_params]
        else:
            leaves = [None if j in self._s_train else p.detach()[i]
                      for j, p in enumerate(self._s_params)]
            for bi, b in enumerate(self._s_assign.buckets):
                for j, v in unpack(self._gather_s(bi, i), b).items():
                    leaves[j] = v
        return [t.requires_grad_(grad and j in self._s_train)
                for j, t in enumerate(leaves)]

    def _outer_values(self):
        """{name: tensor} of every outer parameter (gathered under the
        sharded storage), detached."""
        vals = {n: p.detach() for n, p in self._outer}
        if self._param_storage == "sharded":
            names = [n for n, _ in self._o_params]
            for bi, b in enumerate(self._o_assign.buckets):
                for j, v in unpack(self._gather_o(bi), b).items():
                    vals[names[j]] = v
        return vals

    # -- one step ----------------------------------------------------------
    def __call__(self, ids, labels, segment_ids=None):
        if not self._built:
            self._build()
        elif self._materialized:
            self._repack()
        dev = self._s_p[0].device if self._s_p else self._o_p[0].device
        if self._dropout and self._rng is None:
            seed = (torch.cuda.initial_seed() if dev.type == "cuda"
                    else torch.initial_seed())
            g = torch.Generator(device=dev)
            g.manual_seed((seed + 1000003 * (self._batch_rank + 1))
                          % (1 << 63))
            self._rng = g.get_state()
        forked = [dev.index] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=forked,
                                   enabled=bool(self._dropout)):
            if self._dropout:
                _set_rng_state(dev, self._rng)
            with coll.counting() as got:
                loss = self._step(ids, labels, segment_ids, dev)
            if self._dropout:
                self._rng = _rng_state(dev)
        self.collectives_per_step = got
        return loss

    def _scatter(self, flat, out):
        """The group's sum of ``flat``, this rank's block into ``out``."""
        if self._quant:
            return out.copy_(coll.quantized_reduce_scatter(
                flat, self.group, self._quant))
        return coll.reduce_scatter_into(out, flat, self.group)

    def _combine_outer(self, head_g, emb):
        """{outer index: grad or None}: the head's grads ``head_g`` plus
        the embedding's ``emb`` (by name); under mp all but the head's
        vocab rows are replicated, so scaled by 1/mp."""
        mp, inv_mp = self.mp_group is not None, 1.0 / self._mp_n
        og = {}
        head_w = "gpt.wte.weight" if self.model.lm_head is None \
            else "lm_head.weight"
        for j, (k, p) in enumerate(self._o_params):
            gh, ge = head_g[j], emb.get(k)
            if mp:
                ge = None if ge is None else ge.mul_(inv_mp)
                if gh is not None and k != head_w:
                    gh = gh.mul_(inv_mp)
            if gh is None and ge is None:
                og[j] = None
            elif gh is None or ge is None:
                og[j] = gh if ge is None else ge
            else:
                og[j] = gh + ge if p.dtype == torch.float32 else \
                    (gh.float() + ge.float()).to(p.dtype)
        return og

    def _grads(self, ids, labels, seg, dev, scale):
        """Phases 1-3 over the rank's rows: ``(loss, G, OG, acts)``, the
        rank's loss, the scattered grads' shards and, with ``numerics``,
        the activation rows ``(sum of squares, count, origin)`` of each
        chunk, this rank's part of the group's sums."""
        K, C = self._layer_chunk, self._chunks
        n = self._n
        inv_n, inv_mp = 1.0 / self._data_n, 1.0 / self._mp_n
        mp = self.mp_group is not None
        s_assign, o_assign = self._s_assign, self._o_assign
        nm = self._numerics is not None
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        rng = bool(self._dropout)
        forked = [dev.index] if dev.type == "cuda" else []
        o_names = [nm_ for nm_, _ in self._o_params]
        train_idx = self._s_train

        # 1. forward without autograd over the rank's rows
        states, xs, act_sq, act_origin = [], [], [], []
        o_vals = self._outer_values()
        with torch.no_grad():
            if rng:
                emb_state = _rng_state(dev)
            h = self._embed(o_vals, ids, pos)
            in_fin = torch.isfinite(h).all() if nm else None
            for c in range(C):
                if rng:
                    states.append(_rng_state(dev))
                xs.append(h)
                layers = [self._layer_leaves(i, False)
                          for i in range(c * K, (c + 1) * K)]
                h = self._chunk(layers, h, seg)
                del layers
                if nm:
                    sq = torch.linalg.vector_norm(
                        h, dtype=torch.float32).square()
                    out_fin = torch.isfinite(sq)
                    act_sq.append(sq)
                    act_origin.append(in_fin & ~out_fin)
                    in_fin = out_fin
        act_n = float(h.numel())

        # 2. the head with autograd
        o_leaves = {k: (v.requires_grad_(True) if k in o_names else v)
                    for k, v in o_vals.items()}
        xL = h.requires_grad_()
        loss = self._head(o_leaves, xL, labels)
        head = torch.autograd.grad(
            loss, [xL] + [o_leaves[k] for k in o_names],
            grad_outputs=None if scale is None else scale.to(loss.dtype),
            allow_unused=True)
        dy, head_g = head[0], list(head[1:])
        del xL, o_leaves, head

        scatter = self._scatter

        # 3. one backward: each chunk's grads reduce-scattered a layer at a
        #    time; only the shards survive
        G = [torch.empty_like(p) for p in self._s_p]
        for c in reversed(range(C)):
            layers = [self._layer_leaves(i, True)
                      for i in range(c * K, (c + 1) * K)]
            x = xs[c].detach().requires_grad_()
            with torch.random.fork_rng(devices=forked, enabled=rng):
                if rng:
                    _set_rng_state(dev, states[c])
                with torch.enable_grad():
                    out = self._chunk(layers, x, seg)
            got = torch.autograd.grad(
                out, [x] + [lv[j] for lv in layers for j in train_idx], dy)
            dy = got[0]
            nt = len(train_idx)
            for k, i in enumerate(range(c * K, (c + 1) * K)):
                g_of = dict(zip(train_idx, got[1 + k * nt:1 + (k + 1) * nt]))
                if mp:
                    for j in self._mp_replicated.intersection(g_of):
                        g_of[j].mul_(inv_mp)
                for bi, b in enumerate(s_assign.buckets):
                    flat = pack(b, g_of.get, out=self._buffer(
                        ("pack", bi), b.numel, b.dtype, dev))
                    scatter(flat, G[bi][i])
                del g_of
            del got, out, layers, x
            xs[c] = None
        for t in G:
            t.mul_(inv_n)

        # the outer grads: the head's plus the embedding's
        leaves = {k: (v.detach().requires_grad_(True) if k in o_names
                      else v) for k, v in o_vals.items()}
        used = [k for k in ("gpt.wte.weight", "gpt.wpe.weight")
                if k in o_names]
        with torch.random.fork_rng(devices=forked, enabled=rng):
            if rng:
                _set_rng_state(dev, emb_state)
            with torch.enable_grad():
                x0 = self._embed(leaves, ids, pos)
        emb = dict(zip(used, torch.autograd.grad(
            x0, [leaves[k] for k in used], dy)))
        del leaves, x0, o_vals
        og = self._combine_outer(head_g, emb)
        del head_g, emb
        OG = [scatter(pack(b, og.get), torch.empty(
                  b.numel // n, dtype=b.dtype, device=dev)).mul_(inv_n)
              for b in o_assign.buckets]
        del og
        acts = None
        if nm:
            acts = (torch.stack(act_sq) * inv_mp,
                    torch.full((C,), act_n * inv_mp, device=dev),
                    torch.stack(act_origin).float() * inv_mp)
        return loss, G, OG, acts

    def _step(self, ids, labels, seg, dev):
        opt, K, C = self._opt, self._layer_chunk, self._chunks
        L = self.model.config.num_layers
        group = self.group
        s_assign, o_assign = self._s_assign, self._o_assign
        guard, nm = self._guard, self._numerics is not None
        scale = inv = None
        if guard is not None:
            if self._guard_state is None:
                self._guard_state = guard.init_state(dev)
            if guard.scaling:
                scale = self._guard_state["scale"]
                inv = torch.reciprocal(scale)
        ids, labels = ids.long(), labels.long()
        self._template.train()
        if self.mp_group is not None:
            self._mp_template.train()

        # 1-3. the loss, the grads' shards ([L, F/N] a stacked bucket,
        #      [F/N] an outer one) and the activation rows
        loss, G, OG, acts = self._grads(ids, labels, seg, dev, scale)

        # 4. the clip and the guard: one all-reduce of (sum, flag)
        s_params = [p for segs in self._s_segs
                    for p in self._seg_params(segs, "s")]
        o_params = [p for segs in self._o_segs
                    for p in self._seg_params(segs, "o")]
        o_grads = [v for bi, b in enumerate(o_assign.buckets)
                   for v in self._seg_views(self._o_segs[bi], b, OG[bi])]
        o_need = [getattr(p, "need_clip", True) for p in o_params]
        clip_scale = found = None
        if self._clip_global is not None or guard is not None:
            grads, need = [], []
            for bi, b in enumerate(s_assign.buckets):
                segs = self._s_segs[bi]
                seg_need = [getattr(p, "need_clip", True)
                            for p in self._seg_params(segs, "s")]
                for i in range(L):
                    grads += self._seg_views(segs, b, G[bi][i])
                    need += seg_need
            _, cs, f = norm_stats(
                grads + o_grads,
                need + o_need if self._clip_global is not None else None,
                inv, self._clip_global, group, dev)
            del grads
            if guard is not None:
                found = f
            if self._clip_global is not None:
                clip_scale = cs

        # 5. the update, chunks in reverse; the outer parameters last
        lr = opt.get_lr()
        adam_kw = dict(lr=lr, beta1=opt._beta1, beta2=opt._beta2,
                       eps=opt._epsilon, step=opt._step_tensor(),
                       found_inf=found, clip_scale=clip_scale)
        s_hyper = self._hyper(s_params)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        g_rows, p_rows, u_rows = [], [], []
        for c in reversed(range(C)):
            rows = range(c * K, (c + 1) * K)
            P, Gs, MW, M, V = [], [], [], [], []
            for bi, b in enumerate(s_assign.buckets):
                mw, m, v = self._s_state[bi]
                segs = self._s_segs[bi]
                for i in rows:
                    P += self._seg_views(segs, b, self._s_p[bi][i])
                    Gs += self._seg_views(segs, b, G[bi][i])
                    M += self._seg_views(segs, b, m[i])
                    V += self._seg_views(segs, b, v[i])
                    MW += (self._seg_views(segs, b, mw[i]) if mw is not None
                           else [None] * len(segs))
            hyper = {k: [] for k in s_hyper}
            for bi in range(len(s_assign.buckets)):
                lo = sum(len(s) for s in self._s_segs[:bi])
                for _ in rows:
                    for k, vals in s_hyper.items():
                        hyper[k] += vals[lo:lo + len(self._s_segs[bi])]
            if nm:
                g_rows.append(multi_tensor_norm(Gs, inv_scale=inv)[0][0])
            g_inv = self._value_clip(Gs, hyper["need_clip"], inv)
            if nm:
                values = [p if mw is None else mw for p, mw in zip(P, MW)]
                p_rows.append(multi_tensor_norm(values)[0][0])
                old = [t.clone() for t in values]
            multi_tensor_adam(P, Gs, MW, M, V, inv_scale=g_inv, bump=False,
                              **hyper, **adam_kw)
            if nm:
                torch._foreach_sub_(old, values)
                u = multi_tensor_norm(old)[0][0]
                u_rows.append(u if found is None
                              else torch.where(found, zero, u))
                del old
            if self._param_storage == "replicated":
                for bi, b in enumerate(s_assign.buckets):
                    for i in rows:
                        coll.all_gather_into(self._s_flat[bi][i],
                                             self._s_p[bi][i], group)
        del G
        P = [v for bi, b in enumerate(o_assign.buckets)
             for v in self._seg_views(self._o_segs[bi], b, self._o_p[bi])]
        MW = []
        for bi, b in enumerate(o_assign.buckets):
            mw = self._o_state[bi][0]
            MW += (self._seg_views(self._o_segs[bi], b, mw)
                   if mw is not None else [None] * len(self._o_segs[bi]))
        M = [v for bi, b in enumerate(o_assign.buckets)
             for v in self._seg_views(self._o_segs[bi], b,
                                      self._o_state[bi][1])]
        V = [v for bi, b in enumerate(o_assign.buckets)
             for v in self._seg_views(self._o_segs[bi], b,
                                      self._o_state[bi][2])]
        if nm:
            o_g_sq = multi_tensor_norm(o_grads, inv_scale=inv)[0][0]
        o_inv = self._value_clip(o_grads, o_need, inv)
        if nm:
            o_values = [p if mw is None else mw for p, mw in zip(P, MW)]
            o_p_sq = multi_tensor_norm(o_values)[0][0]
            o_old = [t.clone() for t in o_values]
        multi_tensor_adam(P, o_grads, MW, M, V, inv_scale=o_inv, bump=True,
                          **self._hyper(o_params), **adam_kw)
        if self._param_storage == "replicated":
            for bi in range(len(o_assign.buckets)):
                coll.all_gather_into(self._o_flat[bi], self._o_p[bi], group)
        if nm:
            torch._foreach_sub_(o_old, o_values)
            o_u_sq = multi_tensor_norm(o_old)[0][0]
            if found is not None:
                o_u_sq = torch.where(found, zero, o_u_sq)
            g_col = torch.stack(g_rows[::-1])
            bad = (~torch.isfinite(g_col)).float()
            # an mp group holds one copy of its rows' activations
            stats = assemble_stats(
                g_col, torch.stack(p_rows[::-1]), torch.stack(u_rows[::-1]),
                acts[0], acts[1], bad, acts[2], None,
                outer=outer_row(o_g_sq, o_p_sq, o_u_sq,
                                (~torch.isfinite(o_g_sq)).float()))
            coll.all_reduce(stats, coll.ReduceOp.SUM, group)
            self._numerics.on_step(stats)

        # 6. the guard state, the scheduler, the group's mean loss
        if guard is not None:
            self._guard_state = guard.update(self._guard_state, found)
            guard.writeback(self._guard_state)
        sched = getattr(opt, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()
        self.local_loss = loss.detach()      # this rank's rows' loss
        loss = self.local_loss.clone()
        coll.all_reduce(loss, coll.ReduceOp.AVG, group)
        return loss

    # -- state -------------------------------------------------------------
    def shard_numels(self):
        """Elements this rank holds a bucket: {"s": [L * F/N, ...], "o":
        [F/N, ...]} (the moments, masters and, sharded, parameters)."""
        return {"s": [t.numel() for t in self._s_p],
                "o": [t.numel() for t in self._o_p]}


def is_scan_gpt(model):
    """Whether ``model`` (or the module its wrappers hold) is a
    ``scan_layers`` GPT, which `select_train_step` gives a fused scan
    step."""
    from ..models.gpt import GPTStackedBlocks

    blocks = getattr(getattr(_unwrap_layers(model), "gpt", None), "blocks",
                     None)
    return isinstance(blocks, GPTStackedBlocks)


def _no_micro(kw, axes):
    """A micro-batch count is the pipeline's: refused off a pp mesh."""
    if "num_micro" in kw:
        raise ValueError(
            f"num_micro={kw['num_micro']} splits the batch over a pp ring; "
            f"the mesh {tuple(axes or ())} has no pp axis above degree 1")


def select_train_step(model, optimizer, criterion=None, mesh=None,
                      axis=None, group=None, auto=False, mp_axis=None,
                      ep_axis=None, **kw):
    """The step for ``model`` (reference :2121, :2212-2264): a
    ``scan_layers`` GPT on a mesh whose pp degree is above 1 gets
    `jit.pipeline_step.PipelineScanTrainStep` (the mesh needs a data
    axis, degree 1 is fine); over a data or mp degree above 1
    `ShardedFusedScanTrainStep` (dp x mp when the mesh's mp degree is
    above 1), at degree 1 `FusedScanTrainStep`; another model `TrainStep`
    (over ``criterion(model(ids), labels)``, else ``model.loss`` of the
    whole batch: ids, labels and, where given, a loss mask; of
    ``kw`` its ``accumulate_steps``, ``scaler``, ``guard_nonfinite`` and
    ``numerics``)."""
    from .train_step import TrainStep

    if auto:
        raise NotImplementedError(
            A9B.format("the auto-tuner (auto=True, A9b.6)"))
    if ep_axis is not None:
        raise NotImplementedError(A9B3B.format("ep_axis (MoE experts)"))
    layers = _unwrap_layers(model)
    if is_scan_gpt(layers):
        if group is None:
            mesh = mesh or denv.get_mesh()
            if mesh.shape.get("pp", 1) > 1 and axis != "pp":
                from .pipeline_step import PipelineScanTrainStep

                if axis is None and not any(
                        a in mesh.axis_names for a in ("sharding", "dp")):
                    raise ValueError(
                        f"pp mesh {mesh.axis_names} has no dp/sharding "
                        "axis to place the batch on; build it with one "
                        "(degree 1 is fine): build_mesh({'dp': 1, "
                        "'pp': N})")
                return PipelineScanTrainStep(
                    layers, optimizer, criterion=criterion, mesh=mesh,
                    axis=axis, pp_axis="pp", mp_axis=mp_axis, **kw)
            _no_micro(kw, mesh.axis_names)
            axes, mp = _mesh_axes(mesh, axis, mp_axis)
            if mesh.degree(axes + ((mp,) if mp else ())) > 1:
                return ShardedFusedScanTrainStep(
                    layers, optimizer, criterion=criterion, mesh=mesh,
                    axis=axis, mp_axis=mp, **kw)
        else:
            _no_micro(kw, group.axes)
            if group.nranks > 1:
                return ShardedFusedScanTrainStep(layers, optimizer,
                                                 criterion=criterion,
                                                 group=group, **kw)
        return FusedScanTrainStep(
            layers, optimizer, criterion=criterion,
            **{k: v for k, v in kw.items()
               if k in ("fused_head", "compute_dtype", "layer_chunk",
                        "scan_unroll", "numerics", "scaler",
                        "guard_nonfinite")})
    step_kw = {k: v for k, v in kw.items()
               if k in ("accumulate_steps", "scaler", "guard_nonfinite",
                        "numerics")}
    if criterion is not None:
        return TrainStep(model, lambda m, a, b: criterion(m(a), b),
                         optimizer, **step_kw)
    return TrainStep(model, lambda m, *batch: m.loss(*batch), optimizer,
                     **step_kw)
