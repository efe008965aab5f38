"""The pipelined fused-scan step: the port of paddle_tpu/jit/
pipeline_step.py's ``PipelineScanTrainStep``.

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["pp_degree"] = 2
    strategy.pipeline_configs = {"accumulate_steps": 4}
    fleet.init(is_collective=True, strategy=strategy)
    step = fleet.distributed_model(gpt_scan).train_step(opt)
    loss = step(*env.data_shard((ids, labels)))

`ShardedFusedScanTrainStep` splits the grads and the optimizer state
over the group; this step also splits the layers. The model's C =
num_layers / layer_chunk chunks are round-robined over the ``pp`` axis
as virtual stages: chunk ``c`` runs on stage ``c % pp`` in ring pass
``c // pp`` (reference :173-219), so a stage runs V = C / pp chunks. One
call, on each rank of a pipeline group (`distributed.fleet.
meta_parallel.spmd_pipeline.Ring`):

1. stage 0 embeds the rank's rows (the local dp batch) and splits them
   into ``num_micro`` micro-batches;
2. for each pass ``v``, ``pp + M - 1`` ring ticks without autograd:
   stage ``s`` runs its chunk ``s + pp * v`` on the micro-batch it holds
   and sends the result to stage ``s + 1`` (`collective.p2p_exchange`;
   a bubble tick moves nothing), keeping each micro-batch's input; the
   finished micro-batches come back to stage 0, which injects them into
   the next pass;
3. stage 0 runs the head over the whole local batch with autograd (the
   base step's masked mean: the micro-batches' accumulation is exact by
   construction) and its loss is summed over the pipeline group, so
   every rank returns it;
4. the reverse ring, pass by pass: each stage recomputes its chunk on
   each micro-batch from the input it kept, under the forward's dropout
   seeds, and sends the input's cotangent back; the chunk's grads sum
   over the micro-batches. After each pass, the pass's pp chunks are
   packed into the base step's bucket layout and reduce-scattered over
   the flattened (pp, data axes, mp) group, the owner stage contributing
   its grads and the other stages zeros (reference :370-420): the shards
   are the base step's; stage 0 adds the embedding's and the head's
   grads, the other stages zeros;
5. the clip, the guard and the update: the base step's, over the
   group's shards.

Parameter storage: under "replicated" every rank holds every layer (as
the reference's replicated stacks); under "sharded" every rank takes
part in each pass's gathers of the pass's pp chunks from the shards and
keeps its own chunk's alone (reference :173-219: one uniform collective
a layer, the owner keeps the result), so a rank holds at most its own
chunk's parameters whole.

Dropout follows the port's generator contract, not the reference's
offsets: before each (chunk, micro-batch) application the device
generator is seeded from (the process seed, the data rank, the step,
the chunk, the micro-batch), so masks are distinct per data rank, micro-
batch and layer, alike over the pp and mp ranks (and the same for any
pp degree), and the recompute replays them; the embedding's mask is the
slot of chunk C.

``num_micro`` must divide the local batch, and pp the chunk count. A pp
of degree 1 is allowed: the ring of one stage is the sequential micro-
batch accumulation, the reference configuration. `schedule_stats` is
the reference's schedule accounting, published to the metrics registry
as ``pipeline.bubble_fraction``, ``pipeline.num_micro`` and
``pipeline.degree``. With ``numerics`` a chunk's activation rows are
charged to its logical chunk id ``stage + pp * v`` (summed over its
micro-batches); the grad, parameter and update rows come from the
shards, as in the base step. The mp axis binds the mpu layers and the
vocab-parallel head exactly as the base step does.
"""
from __future__ import annotations

import hashlib

import torch

from ..distributed import collective as coll
from ..distributed.comm_bucketer import pack, unpack
from ..distributed.fleet.meta_parallel.spmd_pipeline import Ring
from ..incubate.distributed.models.moe.moe_layer import has_moe
from .sharded_scan import ShardedFusedScanTrainStep, _unwrap_layers

__all__ = ["PipelineScanTrainStep"]


def _reseed(dev, seed):
    if dev.type == "cuda":
        torch.cuda.default_generators[dev.index].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


class PipelineScanTrainStep(ShardedFusedScanTrainStep):
    """Hybrid (dp, pp[, mp]) train step for a ``scan_layers`` GPT."""

    # a pp of degree 1 is the sequential-accumulation reference
    _allow_degree_one = True
    _pp_axis = _mesh = None

    def __init__(self, model, optimizer, criterion=None, pp_axis=None,
                 num_micro=2, mesh=None, axis=None, **kw):
        if has_moe(_unwrap_layers(model)):
            # the reference refuses it too (its pipeline_step.py:124-130)
            raise ValueError(
                "MoE blocks under pipeline parallelism are not supported, "
                "as in the reference: the ring schedule does not thread "
                "the per-chunk aux-loss output. Train an MoE model with "
                "FusedScanTrainStep (its ep axis: ROADMAP A9b.3b)")
        self._pp_axis_arg = pp_axis
        self._num_micro = int(num_micro)
        super().__init__(model, optimizer, criterion=criterion, mesh=mesh,
                         axis=axis, **kw)
        if self._pp_axis is None:
            raise ValueError(
                "PipelineScanTrainStep needs a 'pp' mesh axis (the ring "
                "ppermutes over it; degree 1 is allowed as the "
                "sequential-accumulation reference); use "
                "ShardedFusedScanTrainStep on a dp-only mesh")
        C = self._chunks
        if C % self._pp_degree:
            raise ValueError(
                f"chunk count {C} (= num_layers/layer_chunk) not "
                f"divisible by pp degree {self._pp_degree}: the "
                "round-robin virtual-stage placement needs C % pp == 0")
        if self._num_micro < 1:
            raise ValueError("num_micro must be >= 1")
        mesh = self._mesh
        self.pp_group = coll.new_group(axes=(self._pp_axis,), mesh=mesh)
        self._ring = Ring(self.pp_group)
        self._stage = self._ring.stage
        cfg = self.model.config
        self._act_dtype = (self._compute_dtype
                           or self.model.gpt.wte.weight.dtype)
        self._hidden = cfg.hidden_size
        seed = (torch.cuda.initial_seed() if self._s_params[0].is_cuda
                else torch.initial_seed())
        self._seed0 = (seed + 1000003 * (self._batch_rank + 1)) % (1 << 63)
        self._steps = 0
        from ..observability import registry as _oreg

        stats = self.schedule_stats()
        reg = _oreg()
        for name, key in (("pipeline.bubble_fraction", "bubble_ratio"),
                          ("pipeline.num_micro", "num_micro"),
                          ("pipeline.degree", "pp")):
            reg.gauge(name).set_fn(lambda v=stats[key]: v)

    def _extra_reduction_axes(self, mesh):
        pp_axis = self._pp_axis_arg
        if pp_axis is None:
            pp_axis = "pp" if "pp" in mesh.axis_names else None
        elif pp_axis not in mesh.axis_names:
            pp_axis = None
        self._pp_axis = pp_axis
        self._pp_degree = int(mesh.shape[pp_axis]) if pp_axis else 1
        self._mesh = mesh
        return (pp_axis,) if pp_axis else ()

    def schedule_stats(self):
        """Analytic schedule accounting (the bubble-ratio probe): the
        ring runs V serial passes of pp + M - 1 ticks; a stage computes
        usefully on M of each pass's ticks."""
        pp, M = self._pp_degree, self._num_micro
        C = self.model.config.num_layers // self._layer_chunk
        V = C // pp
        ticks = V * (pp + M - 1)
        return {
            "pp": pp, "num_micro": M, "layer_chunks": C,
            "virtual_stages_per_rank": V,
            "ring_ticks": ticks,
            "useful_ticks_per_stage": V * M,
            "bubble_ratio": (pp - 1) / (pp + M - 1),
        }

    # -- dropout seeds ----------------------------------------------------
    def _seed(self, c, m):
        h = hashlib.blake2b(
            f"{self._seed0},{self._steps},{c},{m}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "little") >> 1

    # -- the rank's chunk of a pass ----------------------------------------
    def _pass_layers(self, v, grad):
        """This stage's chunk of pass ``v``: its K layers' leaves. Under
        the sharded storage every rank takes part in the gathers of the
        pass's pp chunks (uniform over the group) and keeps its own."""
        K, pp, me = self._layer_chunk, self._pp_degree, self._stage
        mine = None
        for owner in range(pp):
            rows = range((owner + pp * v) * K, (owner + pp * v + 1) * K)
            if self._param_storage == "replicated":
                if owner == me:
                    mine = [self._layer_leaves(i, grad) for i in rows]
                continue
            layers = []
            for i in rows:
                leaves = [None if j in self._s_train else p.detach()[i]
                          for j, p in enumerate(self._s_params)]
                for bi, b in enumerate(self._s_assign.buckets):
                    shard = self._s_p[bi][i]
                    if self._quant:
                        full = coll.quantized_all_gather(shard, self.group,
                                                         self._quant)
                    else:
                        full = coll.all_gather_into(self._buffer(
                            ("own" if owner == me else "gather", bi, i % K),
                            b.numel, shard.dtype, shard.device), shard,
                            self.group)
                    if owner == me:
                        for j, t in unpack(full, b).items():
                            leaves[j] = t
                if owner == me:
                    layers.append([t.requires_grad_(
                        grad and j in self._s_train)
                        for j, t in enumerate(leaves)])
            if owner == me:
                mine = layers
        return mine

    # -- phases 1-3 on the ring --------------------------------------------
    def _grads(self, ids, labels, seg, dev, scale):
        K, C = self._layer_chunk, self._chunks
        pp, M, me = self._pp_degree, self._num_micro, self._stage
        V = C // pp
        ring = self._ring
        inv_n, inv_mp = 1.0 / self._data_n, 1.0 / self._mp_n
        mp = self.mp_group is not None
        s_assign, o_assign = self._s_assign, self._o_assign
        nm = self._numerics is not None
        rng = bool(self._dropout)
        b, seq = ids.shape
        if b % M:
            raise ValueError(f"local batch {b} not divisible by num_micro "
                             f"{M}")
        mb = b // M
        pos = torch.arange(seq, device=ids.device)[None]
        o_names = [k for k, _ in self._o_params]
        train_idx = self._s_train
        nt = len(train_idx)
        segs = [None if seg is None else seg[m * mb:(m + 1) * mb]
                for m in range(M)]
        act_shape = (mb, seq, self._hidden)

        def like(m):
            return torch.empty(act_shape, dtype=self._act_dtype, device=dev)

        # 1. stage 0 embeds the rank's rows
        o_vals = self._outer_values()
        xs = None
        if me == 0:
            with torch.no_grad():
                if rng:
                    _reseed(dev, self._seed(C, 0))
                xs = list(self._embed(o_vals, ids, pos).split(mb))
        act_sq = torch.zeros(C, device=dev)
        act_n = torch.zeros(C, device=dev)
        act_origin = torch.zeros(C, device=dev)
        if nm and me == 0:
            fins = [torch.isfinite(x).all() for x in xs]

        # 2. the ring passes, forward
        saved = []
        for v in range(V):
            c = me + pp * v
            layers = self._pass_layers(v, False)
            sq_m, org_m = [], []

            def apply(m, x, c=c, layers=layers, sq_m=sq_m, org_m=org_m):
                if rng:
                    _reseed(dev, self._seed(c, m))
                y = self._chunk(layers, x, segs[m])
                if nm:
                    in_fin = (fins[m] if (me == 0 and v == 0) else
                              torch.isfinite(torch.linalg.vector_norm(
                                  x, dtype=torch.float32).square()))
                    sq = torch.linalg.vector_norm(
                        y, dtype=torch.float32).square()
                    sq_m.append(sq)
                    org_m.append(in_fin & ~torch.isfinite(sq))
                return y

            with torch.no_grad():
                xs, ins = ring.forward(apply, lambda m: xs[m], M, like)
            saved.append(ins)
            del layers
            if nm:
                act_sq[c] = torch.stack(sq_m).sum() * inv_mp
                act_n[c] = float(b * seq * self._hidden) * inv_mp
                act_origin[c] = torch.stack(org_m).float().sum() * inv_mp

        # 3. the head on stage 0, over the whole local batch; the loss is
        #    every rank's
        head_g = [None] * len(o_names)
        dys = None
        if me == 0:
            o_leaves = {k: (t.requires_grad_(True) if k in o_names else t)
                        for k, t in o_vals.items()}
            xL = torch.cat(xs).requires_grad_()
            loss = self._head(o_leaves, xL, labels)
            head = torch.autograd.grad(
                loss, [xL] + [o_leaves[k] for k in o_names],
                grad_outputs=None if scale is None else scale.to(
                    loss.dtype),
                allow_unused=True)
            dys, head_g = list(head[0].split(mb)), list(head[1:])
            del xL, o_leaves, head
            loss = loss.detach().float()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        if pp > 1:
            coll.all_reduce(loss, coll.ReduceOp.SUM, self.pp_group)
        xs = None

        # 4. the reverse ring, pass by pass; each pass's chunks scattered
        G = [torch.empty_like(p) for p in self._s_p]
        for v in reversed(range(V)):
            c = me + pp * v
            layers = self._pass_layers(v, True)
            acc = [None] * (K * nt)
            ins = saved[v]

            def vjp(m, d, c=c, layers=layers, acc=acc, ins=ins):
                x = ins[m].detach().requires_grad_()
                ins[m] = None
                if rng:
                    _reseed(dev, self._seed(c, m))
                with torch.enable_grad():
                    out = self._chunk(layers, x, segs[m])
                got = torch.autograd.grad(
                    out, [x] + [lv[j] for lv in layers for j in train_idx],
                    d)
                for k, g in enumerate(got[1:]):
                    acc[k] = g if acc[k] is None else acc[k].add_(g)
                return got[0]

            dys = ring.backward(vjp, dys, M, like)
            saved[v] = None
            del layers
            for owner in range(pp):
                co = owner + pp * v
                for k, i in enumerate(range(co * K, (co + 1) * K)):
                    g_of = (dict(zip(train_idx, acc[k * nt:(k + 1) * nt]))
                            if owner == me else None)
                    if g_of is not None and mp:
                        for j in self._mp_replicated.intersection(g_of):
                            g_of[j].mul_(inv_mp)
                    for bi, bk in enumerate(s_assign.buckets):
                        if g_of is None:
                            flat = self._zeros(("zero", bi), bk, dev)
                        else:
                            flat = pack(bk, g_of.get, out=self._buffer(
                                ("pack", bi), bk.numel, bk.dtype, dev))
                        self._scatter(flat, G[bi][i])
            del acc
        for t in G:
            t.mul_(inv_n)

        # the outer grads: stage 0's head and embedding, zeros elsewhere
        og = None
        if me == 0:
            leaves = {k: (t.detach().requires_grad_(True) if k in o_names
                          else t) for k, t in o_vals.items()}
            used = [k for k in ("gpt.wte.weight", "gpt.wpe.weight")
                    if k in o_names]
            if rng:
                _reseed(dev, self._seed(C, 0))
            with torch.enable_grad():
                x0 = self._embed(leaves, ids, pos)
            emb = dict(zip(used, torch.autograd.grad(
                x0, [leaves[k] for k in used], torch.cat(dys))))
            del leaves, x0
            og = self._combine_outer(head_g, emb)
            del emb
        del o_vals, head_g, dys
        n = self._n
        OG = []
        for bi, bk in enumerate(o_assign.buckets):
            flat = (pack(bk, og.get) if og is not None
                    else self._zeros(("zero_o", bi), bk, dev))
            OG.append(self._scatter(flat, torch.empty(
                bk.numel // n, dtype=bk.dtype, device=dev)).mul_(inv_n))
        self._steps += 1
        acts = (act_sq, act_n, act_origin) if nm else None
        return loss, G, OG, acts

    def _zeros(self, key, bucket, dev):
        """A zero flat of ``bucket`` made once (a collective reads it and
        writes no byte of it)."""
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.zeros(bucket.numel,
                                                dtype=bucket.dtype,
                                                device=dev)
        return buf
