"""Rank workers of the mp axis (tensor parallelism), and its runs on the
card: the counterpart of the dp x mp half of paddle_tpu/jit/
hybrid_selftest.py.

Each case is a function of one rank (`sharding_selftest.Ctx`) returning
numpy arrays; the caller computes the reference. Cases:

* ``mp_layers``: ``fleet.init`` at mp = the world, the mpu layers'
  outputs and gradient blocks, `ParallelCrossEntropy`, the RNG tracker,
  a small model through `TensorParallel` + `HybridParallelOptimizer`
  with the global-norm clip, the broadcasts;
* ``mp_dp``: at dp 2 x mp 2, `fused_allreduce_gradients` (the dp group
  alone) and the topology's groups;
* ``mp_sharding``: at sharding 2 x mp 2, the small model of
  ``mp_layers`` through `TensorParallel` and a `HybridParallelOptimizer`
  over `DygraphShardingOptimizer`, each sharding rank on its half of the
  rows;
* ``sharded_ce``: `sharded_fused_cross_entropy` over the group;
* ``sequence_parallel``: the sequence-parallel operators and layers;
* ``mp_scan``: ``fleet.init(dp, mp)`` -> ``fleet.distributed_model(gpt)
  .train_step(opt)``: `ShardedFusedScanTrainStep` over dp x mp, both
  storages (the sharded one's optimizer through
  ``fleet.distributed_optimizer``), tied and untied heads; dropout
  masks; collectives a step;
  the blocks the step binds.

`launch(case, nprocs, args)` / `start` run a case in gloo ranks on the
CPU (`sharding_selftest.launch` with this module).

On the card (two ranks share one card over gloo; one card a rank over
NCCL where there are two)::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m paddle_tpu_torch.distributed.mp_selftest [--nccl] [--steps 3]

trains GPT-3 1.3B at dp 1 x mp 2 (bf16 compute over fp32 parameters,
AdamW with ``ClipGradByGlobalNorm(1.0)``, 4 x 1024 tokens): losses,
step times, launches and collectives a step; then a tiny fp32 scan GPT
at mp 2 on the card against the same ranks on the CPU. Rank 0 prints
one JSON line. The weights are drawn on the card from seed 0, as a
world-of-one run draws them (`chip_smoke.py` phase 24(b) compares).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import sharding_selftest as _ss
from .sharding_selftest import Ctx, _block, _np

__all__ = ["CASES", "full_width", "launch", "launch_card", "main",
           "run_card", "start", "tiny_card_cpu", "world_one"]


def _t(a, dev, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.requires_grad_(grad)


def _init_mp(dp, mp, sharding=1):
    from .fleet import DistributedStrategy, fleet

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                        "sharding_degree": sharding}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def case_mp_layers(ctx):
    """Every mpu layer on seeded global weights (the reference's
    layouts), loss = sum(out * R) for a fixed R; outputs, the blocks'
    grads and the inputs' grads."""
    from .. import convert
    from .fleet.layers import mpu

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    hcg = _init_mp(1, n)
    out = {"hcg": [hcg.get_model_parallel_world_size(),
                   hcg.get_model_parallel_rank(),
                   hcg.get_data_parallel_world_size(),
                   hcg.get_model_parallel_group().nranks,
                   hcg.get_model_parallel_group_src_rank()]}

    def load(layer, named):
        layer.load_state_dict(convert.mp_state_dict_from_jax(
            named, layer, r, n))
        return layer

    # VocabParallelEmbedding
    emb = load(mpu.VocabParallelEmbedding(*a["emb_w"].shape),
               {"weight": a["emb_w"]})
    y = emb(_t(a["ids"], dev))
    (y * _t(a["r_emb"], dev)).sum().backward()
    out["emb_out"], out["emb_grad"] = _np(y), _np(emb.weight.grad)
    # ColumnParallelLinear, gather_output True
    x = _t(a["x"], dev, True)
    col = load(mpu.ColumnParallelLinear(*a["col_w"].shape,
                                        gather_output=True),
               {"weight": a["col_w"], "bias": a["col_b"]})
    y = col(x)
    (y * _t(a["r_col"], dev)).sum().backward()
    out["col_out"] = _np(y)
    out["col_grads"] = [_np(col.weight.grad).T, _np(col.bias.grad),
                        _np(x.grad)]
    # ColumnParallelLinear (gather_output False) -> RowParallelLinear
    # (input_is_parallel)
    x = _t(a["x"], dev, True)
    col = load(mpu.ColumnParallelLinear(*a["col_w"].shape,
                                        gather_output=False),
               {"weight": a["col_w"], "bias": a["col_b"]})
    row = load(mpu.RowParallelLinear(*a["row_w"].shape,
                                     input_is_parallel=True),
               {"weight": a["row_w"], "bias": a["row_b"]})
    mid = col(x)
    y = row(torch.nn.functional.gelu(mid))
    (y * _t(a["r_row"], dev)).sum().backward()
    out["pair_mid"], out["pair_out"] = _np(mid), _np(y)
    out["pair_grads"] = [_np(col.weight.grad).T, _np(col.bias.grad),
                         _np(row.weight.grad).T, _np(row.bias.grad),
                         _np(x.grad)]
    # RowParallelLinear on a whole input
    x2 = _t(a["x2"], dev, True)
    row = load(mpu.RowParallelLinear(*a["row_w"].shape,
                                     input_is_parallel=False),
               {"weight": a["row_w"], "bias": a["row_b"]})
    y = row(x2)
    (y * _t(a["r_row"], dev)).sum().backward()
    out["row_out"] = _np(y)
    out["row_grads"] = [_np(row.weight.grad).T, _np(row.bias.grad),
                        _np(x2.grad)]
    # ParallelCrossEntropy over the rank's vocab columns
    v = a["logits"].shape[-1] // n
    logits = _t(a["logits"][..., r * v:(r + 1) * v], dev, True)
    loss = mpu.ParallelCrossEntropy()(logits, _t(a["labels"], dev))
    (loss * _t(a["r_ce"], dev)).sum().backward()
    out["ce_loss"], out["ce_grad"] = _np(loss), _np(logits.grad)
    out.update(_rng_tracker(ctx, hcg))
    out.update(_tensor_parallel_train(ctx, hcg))
    out.update(_broadcasts(ctx, hcg))
    return out


def _rng_tracker(ctx, hcg):
    """Dropout masks under the tracker's state (distinct across mp ranks,
    repeating for a seed) and under the default generator (alike)."""
    from .fleet.layers.mpu import get_rng_state_tracker
    from .fleet.layers.mpu import model_parallel_random_seed

    x = torch.ones(256, device=ctx.device)
    tracker = get_rng_state_tracker()
    runs = []
    for _ in range(2):
        model_parallel_random_seed(7)
        with tracker.rng_state():
            a = torch.nn.functional.dropout(x, 0.5)
            b = torch.nn.functional.dropout(x, 0.5)
        c = torch.nn.functional.dropout(x, 0.5)
        runs.append(np.stack([_np(a), _np(b), _np(c)]))
    return {"rng_runs": runs}


def _tp_net(n, named, r, dev, vocab, hidden, ffn):
    """Embedding -> column (split) -> gelu -> row -> LayerNorm -> column
    logits over the vocab blocks, under the reference's names."""
    from .. import convert
    from ..nn import LayerNorm
    from .fleet.layers import mpu

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = mpu.VocabParallelEmbedding(vocab, hidden)
            self.fc1 = mpu.ColumnParallelLinear(hidden, ffn,
                                                gather_output=False)
            self.fc2 = mpu.RowParallelLinear(ffn, hidden,
                                             input_is_parallel=True)
            self.ln = LayerNorm(hidden)
            self.head = mpu.ColumnParallelLinear(hidden, vocab,
                                                 gather_output=False)
            self.ce = mpu.ParallelCrossEntropy()

        def forward(self, ids):
            h = self.emb(ids)
            h = h + self.fc2(torch.nn.functional.gelu(self.fc1(h)))
            return self.head(self.ln(h))

        def loss(self, ids, labels):
            return self.ce(self(ids), labels).mean()

    net = Net().to(dev)
    net.load_state_dict(convert.mp_state_dict_from_jax(named, net, r, n))
    return net


def _tensor_parallel_train(ctx, hcg):
    """The small model through ``fleet.distributed_model`` (a
    `TensorParallel`) and ``fleet.distributed_optimizer`` (AdamW with the
    global-norm clip), 3 `jit.TrainStep` s on the rank's rows of the
    data axes: losses, the global parameters (every rank's blocks,
    joined by the test), the clip's norm."""
    from ..jit import TrainStep
    from ..nn import ClipGradByGlobalNorm
    from ..nn.clip import mp_norm_stats
    from ..optimizer import AdamW
    from . import env
    from .fleet import fleet

    r, n = hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size()
    dev = ctx.device
    a = ctx.args["tp"]
    net = _tp_net(n, a["named"], r, dev, **a["dims"])
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=a["lr"], parameters=net.parameters(),
        grad_clip=ClipGradByGlobalNorm(a["clip"])))
    ids, labels = _t(a["ids"], dev), _t(a["labels"], dev)
    net.loss(ids, labels).backward()
    sq, _ = mp_norm_stats([(p, p.grad) for p in net.parameters()],
                          a["clip"], hcg.get_model_parallel_group())
    opt.clear_grad()
    step = TrainStep(model, lambda m, i, y: m.loss(i, y), opt)
    mine = env.data_shard([ids, labels])
    losses = [float(step(*mine)) for _ in range(a["steps"])]
    return {"tp_wrapper": type(model).__name__,
            "tp_opt": type(opt).__name__,
            "tp_inner": type(opt._inner_opt).__name__,
            "tp_losses": np.asarray(losses), "tp_grad_norm_sq": float(sq),
            "tp_coords": [hcg.get_sharding_parallel_rank(), r],
            "tp_state": {k: _np(v) for k, v in net.state_dict().items()}}


def _broadcasts(ctx, hcg):
    """`broadcast_mp_parameters` sends group rank 0's replicated
    parameters and leaves the blocks; `broadcast_input_data` sends its
    inputs."""
    from .fleet.layers import mpu
    from .fleet.utils.hybrid_parallel_util import (broadcast_input_data,
                                                   broadcast_mp_parameters)

    r = ctx.rank
    torch.manual_seed(100 + r)
    layer = mpu.RowParallelLinear(8, 4, input_is_parallel=True)
    block = layer.weight.detach().clone()
    with torch.no_grad():
        layer.bias.fill_(float(r + 1))
    broadcast_mp_parameters(layer, hcg)
    x = torch.full((3,), float(r), device=ctx.device)
    broadcast_input_data(hcg, x)
    return {"bcast_bias": _np(layer.bias),
            "bcast_block_kept": bool(torch.equal(block, layer.weight)),
            "bcast_input": _np(x)}


def case_mp_dp(ctx):
    """dp 2 x mp 2: the groups, and `fused_allreduce_gradients` averaging
    over the data-parallel group alone."""
    from .fleet.utils.hybrid_parallel_util import fused_allreduce_gradients

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    hcg = _init_mp(n // 2, 2)
    p = torch.nn.Parameter(torch.zeros(5, device=dev))
    p.grad = torch.full((5,), float(r), device=dev)
    fused_allreduce_gradients([p], hcg)
    return {"groups": [hcg.get_data_parallel_group().ranks,
                       hcg.get_model_parallel_group().ranks],
            "ranks": [hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank()],
            "grad": _np(p.grad)}


def case_mp_sharding(ctx):
    """sharding 2 x mp 2: `_tensor_parallel_train` with the optimizer's
    state sharded over the sharding axis (stage 1), the rows split over
    it."""
    return _tensor_parallel_train(ctx, _init_mp(1, 2, sharding=2))


# ---------------------------------------------------------------------------
# the vocab-parallel CE
# ---------------------------------------------------------------------------

def case_sharded_ce(ctx):
    """`sharded_fused_cross_entropy` on the rank's rows of W: the losses,
    dh (this rank's part, then summed by Megatron's f), dW (the rows)."""
    from ..ops.kernels.fused_cross_entropy import sharded_fused_cross_entropy
    from .fleet.layers.mpu import c_identity
    from .fleet.layers.mpu.mp_ops import mp_group

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    _init_mp(1, n)
    group = mp_group()
    out = {}
    for tag, c in ctx.args["cases"].items():
        v = c["w"].shape[0] // n
        h = _t(c["h"], dev, True)
        w = _t(c["w"][r * v:(r + 1) * v], dev, True)
        losses = sharded_fused_cross_entropy(c_identity(h, group), w,
                                             _t(c["labels"], dev), r * v,
                                             group)
        (losses * _t(c["g"], dev)).sum().backward()
        out[tag] = {"losses": _np(losses), "dh": _np(h.grad),
                    "dw": _np(w.grad)}
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def case_sequence_parallel(ctx):
    from .. import convert
    from .fleet.utils import sequence_parallel_utils as sp

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    _init_mp(1, n)
    out = {}
    x = a["x"]                                   # [s, b, h]
    xb = _t(_block(x, r, n), dev, True)
    y = sp.GatherOp.apply(xb)
    (y * _t(a["r_full"], dev)).sum().backward()
    out["gather"], out["gather_grad"] = _np(y), _np(xb.grad)
    xf = _t(x, dev, True)
    y = sp.ScatterOp.apply(xf)
    (y * _t(_block(a["r_full"], r, n), dev)).sum().backward()
    out["scatter"], out["scatter_grad"] = _np(y), _np(xf.grad)
    xb = _t(_block(x, r, n), dev, True)
    y = sp.AllGatherOp.apply(xb)
    (y * _t(a["r_full"], dev)).sum().backward()
    out["all_gather"], out["all_gather_grad"] = _np(y), _np(xb.grad)
    part = _t(x * (r + 1), dev, True)
    y = sp.ReduceScatterOp.apply(part)
    (y * _t(_block(a["r_full"], r, n), dev)).sum().backward()
    out["reduce_scatter"] = _np(y)
    out["reduce_scatter_grad"] = _np(part.grad)
    # the layers: column (sequence gathered) -> row (reduce-scattered)
    col = sp.ColumnSequenceParallelLinear(*a["col_w"].shape)
    col.load_state_dict(convert.mp_state_dict_from_jax(
        {"weight": a["col_w"], "bias": a["col_b"]}, col, r, n))
    row = sp.RowSequenceParallelLinear(*a["row_w"].shape)
    row.load_state_dict(convert.mp_state_dict_from_jax(
        {"weight": a["row_w"], "bias": a["row_b"]}, row, r, n))
    hooks = sp.register_sequence_parallel_allreduce_hooks(row)
    xb = _t(_block(x, r, n), dev, True)
    mid = col(xb)
    y = row(mid)
    (y * _t(_block(a["r_out"], r, n), dev)).sum().backward()
    out["sp_mid"], out["sp_out"] = _np(mid), _np(y)
    out["sp_grads"] = [_np(col.weight.grad).T, _np(col.bias.grad),
                       _np(row.weight.grad).T, _np(row.bias.grad),
                       _np(xb.grad)]
    out["sp_hooks"] = len(hooks)
    return out


# ---------------------------------------------------------------------------
# the dp x mp sharded scan
# ---------------------------------------------------------------------------

def _scan_gpt(ctx, named, config):
    from .. import convert
    from ..models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(**config, scan_layers=True),
                           device=ctx.device)
    model.load_state_dict(convert.state_dict_from_jax(named, model=model))
    model.train()
    return model


def case_mp_scan(ctx):
    """``fleet.init`` at dp x mp, then for each head and storage
    ``fleet.distributed_model(gpt).train_step(opt)`` for ``steps`` steps
    on the rank's dp rows."""
    from .. import convert
    from ..jit import ShardedFusedScanTrainStep
    from ..models import GPTPretrainingCriterion
    from . import collective as C
    from .fleet import fleet

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    mp = a["mp"]
    dp = n // mp
    hcg = _init_mp(dp, mp)
    d = hcg.get_data_parallel_rank()
    crit = GPTPretrainingCriterion()
    ids, labels = (_t(a[k], dev) for k in ("ids", "labels"))
    mine = [_block(ids, d, dp), _block(labels, d, dp)]
    out = {"coords": [d, hcg.get_model_parallel_rank()]}
    for head in a["heads"]:
        cfg = dict(a["config"], tie_word_embeddings=head == "tied")
        named = a["named"][head]
        for storage in ("replicated", "sharded"):
            model = _scan_gpt(ctx, named, cfg)
            opt = _ss._adamw(model, clip=a["clip"], lr=a["lr"])
            if storage == "sharded":    # the step takes its inner optimizer
                opt = fleet.distributed_optimizer(opt)
            step = fleet.distributed_model(model).train_step(
                opt, criterion=crit, param_storage=storage,
                guard_nonfinite=True, numerics=False)
            if not isinstance(step, ShardedFusedScanTrainStep):
                raise AssertionError(f"train_step gave {type(step)}")
            tag = f"{head}_{storage}"
            if storage == "replicated":
                plan = step.mp_plan()
                sd = model.state_dict()
                out[f"blocks_{head}"] = {
                    k: _np(convert.mp_block(sd[k], kind, step.mp_group.rank,
                                            mp))
                    for k, kind in plan.items()}
                out[f"plan_{head}"] = plan
            losses = [float(step(*mine)) for _ in range(a["steps"])]
            out[f"losses_{tag}"] = np.asarray(losses)
            out[f"local_{tag}"] = float(step.local_loss)
            out[f"params_{tag}"] = {k: _np(v) for k, v in
                                    model.state_dict().items()}
            out[f"calls_{tag}"] = step.collectives_per_step
            out[f"shards_{tag}"] = step.shard_numels()
        out[f"buckets_{head}"] = [b.numel for b in step._s_assign.buckets] \
            + [b.numel for b in step._o_assign.buckets]
    out["axes"] = [step.group.axes, step.mp_group.axes]
    # hidden dropout: every rank the same rows, so the masks alone part
    # the losses (alike across mp, distinct across dp)
    model = _scan_gpt(ctx, a["named"]["tied"],
                      dict(a["config"], hidden_dropout_prob=0.5))
    torch.manual_seed(0)
    step = fleet.distributed_model(model).train_step(
        _ss._adamw(model, clip=None, lr=a["lr"]), criterion=crit,
        numerics=False)
    step(ids[:2], labels[:2])
    out["dropout_local"] = float(step.local_loss)
    # what the mp step refuses
    refused = {}
    for what, over in (("heads", dict(num_attention_heads=1)),
                       ("attention_dropout",
                        dict(attention_dropout_prob=0.1))):
        model = _scan_gpt(ctx, a["named"]["tied"], dict(a["config"],
                                                        **over))
        try:
            ShardedFusedScanTrainStep(model, _ss._adamw(model),
                                      criterion=crit, mesh=hcg.mesh)
            refused[what] = ""
        except ValueError as e:
            refused[what] = str(e)
    model = _scan_gpt(ctx, a["named"]["tied"], a["config"])
    try:
        ShardedFusedScanTrainStep(model, _ss._adamw(model),
                                  criterion=lambda lg, lb: lg.sum(),
                                  mesh=hcg.mesh)
        refused["criterion"] = ""
    except ValueError as e:
        refused["criterion"] = str(e)
    out["refused"] = refused
    C.barrier()
    return out


def case_mp_nonfinite(ctx):
    """The small model of ``mp_layers`` through `TensorParallel`, a
    `HybridParallelOptimizer` (AdamW, the clip) and a `jit.TrainStep`
    with a `GradScaler`: a first step with an inf in rank 1's block's
    grad (every rank must skip it: the parameters unchanged and alike,
    the scale halved on every rank), then a clean step."""
    from ..amp import GradScaler
    from ..jit import TrainStep
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .fleet import fleet

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args["tp"]
    hcg = _init_mp(1, n)
    net = _tp_net(n, a["named"], hcg.get_model_parallel_rank(), dev,
                  **a["dims"])
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=a["lr"], parameters=net.parameters(),
        grad_clip=ClipGradByGlobalNorm(a["clip"])))
    scaler = GradScaler(init_loss_scaling=1024.0)
    step = TrainStep(model, lambda m, i, y: m.loss(i, y), opt,
                     scaler=scaler)
    ids, labels = env.data_shard([_t(a["ids"], dev), _t(a["labels"], dev)])
    state = lambda: {k: _np(v).copy()  # noqa: E731  (not views)
                     for k, v in net.state_dict().items()}
    before = state()
    hook = None
    if r == 1:
        hook = net.fc1.weight.register_hook(
            lambda g: g.index_fill(0, torch.tensor([0], device=g.device),
                                   float("inf")))
    step(ids, labels)
    skipped, scale = state(), scaler.get_loss_scaling()
    if hook is not None:
        hook.remove()
    step(ids, labels)
    return {"before": before, "skipped": skipped, "scale": scale,
            "stepped": state(), "scale_after": scaler.get_loss_scaling()}


CASES = {"mp_layers": case_mp_layers, "mp_dp": case_mp_dp,
         "mp_nonfinite": case_mp_nonfinite,
         "mp_sharding": case_mp_sharding,
         "sharded_ce": case_sharded_ce,
         "sequence_parallel": case_sequence_parallel,
         "mp_scan": case_mp_scan}


def start(case, nprocs, args=None, timeout=60):
    """`sharding_selftest.start` for this module's cases."""
    return _ss.start(case, nprocs, args, timeout, module=__name__)


def launch(case, nprocs, args=None, timeout=60, deadline=120):
    return start(case, nprocs, args, timeout).wait(deadline)


# ---------------------------------------------------------------------------
# on the card, under torch.distributed.run
# ---------------------------------------------------------------------------

def _counters():
    from ..ops.kernels import fused_cross_entropy as fce
    from ..ops.kernels import multi_tensor as mt
    from ..ops.kernels import splash_attention as sa

    return {"splash_fwd_wgmma_kernel": (sa.splash_attention_fwd,
                                        "launches_wgmma"),
            "splash_bwd_wgmma_kernels": (sa.splash_attention_bwd,
                                         "launches_wgmma"),
            "fused_ce_fwd_wgmma_kernel": (fce.fused_ce_fwd, "launches_wgmma"),
            "fused_ce_bwd_kernels": (fce.fused_ce_bwd, "launches"),
            "mt_adam_kernel": (mt.multi_tensor_adam, "launches"),
            "mt_norm_kernel": (mt.multi_tensor_norm, "launches")}


def _read(counters):
    return {k: getattr(f, a) for k, (f, a) in counters.items()}


def full_width_batch(cfg, dev, batch=4, seq=1024):
    """The 1.3B runs' global batch: ids and labels from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(2)]


def world_one(dev, steps=3, batch=4, seq=1024):
    """`full_width`'s model, optimizer and batch through a world-of-one
    `jit.FusedScanTrainStep` (phase 14's dtypes, the fused head): its
    losses, what the dp x mp run is held to."""
    from ..jit import FusedScanTrainStep
    from ..models import GPTForCausalLM, gpt_config
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", scan_layers=True)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    step = FusedScanTrainStep(model, opt, fused_head=True,
                              compute_dtype="bfloat16", numerics=False)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    losses = [float(step(ids, labels)) for _ in range(steps)]
    del step, opt, model
    return losses


def full_width(dev, steps=3, batch=4, seq=1024):
    """GPT-3 1.3B at dp 1 x mp (the world) through ``fleet.init`` ->
    ``fleet.distributed_model(model).train_step(AdamW +
    ClipGradByGlobalNorm(1.0))``: bf16 compute over fp32 parameters, bf16
    moments, weights from seed 0; the losses, step seconds, launches and
    collectives a step (the last step's); the sharded storage."""
    from ..models import GPTForCausalLM, gpt_config
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import collective as C
    from . import env
    from .fleet import fleet

    n = env.get_world_size()
    hcg = _init_mp(1, n)
    cfg = gpt_config("gpt3-1.3b", scan_layers=True)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    step = fleet.distributed_model(model).train_step(
        opt, compute_dtype="bfloat16", param_storage="sharded",
        numerics=False)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    counters = _counters()
    losses, times, launches = [], [], []
    C.reset_counts()
    for _ in range(steps):
        before = _read(counters)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = step(ids, labels)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        after = _read(counters)
        launches.append({k: after[k] - before[k] for k in after})
    result = {"losses": losses, "step_s": times,
              "launches_per_step": launches[-1],
              "collectives_per_step": step.collectives_per_step,
              "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
              "mp": n, "rank": env.get_rank(),
              "axes": [step.group.axes, step.mp_group.axes],
              "buckets": [len(step._s_assign.buckets),
                          len(step._o_assign.buckets)],
              "layers": cfg.num_layers}
    ranks = []
    C.all_gather_object(ranks, losses)
    result["rank_losses"] = ranks
    del step, opt, model
    return result


TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def tiny_card_cpu(dev, steps=3):
    """A tiny fp32 scan GPT at mp (the world) on the card and on the CPU
    over the same gloo ranks, from the same weights, AdamW with the clip,
    3 steps: the losses and the largest relative parameter difference
    (the keys' bias aside: `sharding_selftest.key_bias_out`)."""
    from ..models import GPTConfig, GPTForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from .fleet import fleet

    rng = np.random.default_rng(3)
    cfg = GPTConfig(**TINY, scan_layers=True)
    ref = GPTForCausalLM(cfg, device="cpu")
    sd = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.3)
                              .astype(np.float32))
          for k, v in ref.state_dict().items()}
    ids = rng.integers(0, TINY["vocab_size"], (4, 64))
    labels = rng.integers(0, TINY["vocab_size"], (4, 64))
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = GPTForCausalLM(cfg, device=d)
        model.load_state_dict(sd)
        model.train()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = fleet.distributed_model(model).train_step(
            opt, fused_head=True, numerics=False)
        batch = [torch.from_numpy(x).to(d) for x in (ids, labels)]
        out[where] = {
            "losses": [float(step(*batch)) for _ in range(steps)],
            "params": {k: v.detach().cpu() for k, v in
                       model.state_dict().items()}}
        del step, opt, model
    dl = max(abs(a - b) for a, b in zip(out["card"]["losses"],
                                        out["cpu"]["losses"]))
    dp = max(float(np.abs(_ss.key_bias_out(k, _np(a)) - _ss.key_bias_out(
                 k, _np(out["cpu"]["params"][k]))).max()
                   / max(np.abs(_np(out["cpu"]["params"][k])).max(), 1e-12))
             for k, a in out["card"]["params"].items())
    return {"losses_card": out["card"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "max_loss_diff": dl,
            "max_param_rel": dp}


def run_card(nccl=False, steps=3):
    """Phase 24(b)-(d)'s ranks: join the world (gloo sharing the card,
    or NCCL one card a rank), train GPT-3 1.3B at mp = the world, then
    the tiny model card against CPU; rank 0's result."""
    from . import env

    dev = env.init_parallel_env(backend=None if nccl else "gloo",
                                device=None if nccl else "cuda",
                                timeout=600)
    result = {"backend": env.get_backend(), "device": str(dev),
              "world": env.get_world_size()}
    t0 = time.perf_counter()
    result["gpt3_1.3b"] = full_width(dev, steps=steps)
    result["gpt3_1.3b"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    result["tiny_card_cpu"] = tiny_card_cpu(dev)
    env.reset()
    return result


def launch_card(nprocs=2, nccl=False, steps=3, deadline=900,
                module=__name__, extra=()):
    """`run_card` (of ``module``, with the arguments ``extra``) in
    ``nprocs`` ranks under ``torch.distributed.run`` (a free port on
    127.0.0.1): rank 0's result. Every rank is killed and this raises
    when the run passes ``deadline`` seconds or fails."""
    import signal
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nprocs), "--master_addr", "127.0.0.1", "--master_port",
           str(port), "-m", module, "--steps", str(steps)] + \
        (["--nccl"] if nccl else []) + list(extra)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=root, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise TimeoutError(f"{module} x{nprocs}: past the {deadline} s "
                           f"deadline, every rank killed\n{err[-3000:]}")
    if proc.returncode:
        raise RuntimeError(f"{module} x{nprocs}: exit {proc.returncode}"
                           f"\n{out[-2000:]}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worker")
    p.add_argument("--rank", type=int)
    p.add_argument("--nprocs", type=int)
    p.add_argument("--dir")
    p.add_argument("--timeout", type=float, default=60)
    p.add_argument("--nccl", action="store_true",
                   help="NCCL, one card a rank (default: gloo, ranks "
                        "sharing the card)")
    p.add_argument("--steps", type=int, default=3)
    a = p.parse_args(argv)
    if a.worker:
        _ss.worker(a.worker, a.rank, a.nprocs, a.dir, a.timeout, CASES)
        return 0
    result = run_card(a.nccl, a.steps)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
