"""Rank workers of the pp axis (pipeline parallelism), and its runs on the
card: the counterpart of the dp x pp half of paddle_tpu/jit/
hybrid_selftest.py.

Each case is a function of one rank (`sharding_selftest.Ctx`) returning
numpy arrays; the caller computes the reference. Cases:

* ``ring``: `collective.p2p_permute` and its reverse-ring backward;
  `pipeline_spmd` over a tanh-linear block at several micro-batch
  counts and ``num_chunks`` 2 (`pipeline_spmd_zb` too at one chunk);
  `pipeline_spmd_hetero` whose stages pass integer token ids and embed
  them;
* ``pp_layers``: ``fleet.init`` at pp n, a `PipelineLayer` with a
  tied `SharedLayerDesc` embedding through ``fleet.distributed_model``
  (`PipelineParallel`) and ``fleet.distributed_optimizer``: 3
  ``train_batch`` steps (AdamW, the global-norm clip, a `GradScaler`) at
  two ``accumulate_steps``, ``eval_batch``, and a step with an inf in
  the last stage's grads (every stage skips);
* ``gpt_pipe``: `models.GPTForCausalLMPipe` (chunks 1 and 2, and the
  zero-bubble ring) loss and grads;
* ``zero_bubble``: `zb_linear_pipeline`, `pipeline_spmd_zb` over the
  GPT block at several ``dw_chunk``, which grads a tick asks for,
  `GPTForCausalLMPipe(use_zero_bubble=True)` beside its AD ring, the
  refusals;
* ``pp_scan``: ``fleet.init(dp, mp, pp)`` -> ``fleet.distributed_model(
  gpt).train_step(opt)``: `jit.PipelineScanTrainStep`, both storages,
  tied and untied heads; the numerics rows, dropout, the refusals, the
  collectives a step.

`start(case, nprocs, args)` runs a case in gloo ranks on the CPU
(`sharding_selftest.start` with this module).

On the card (two ranks share one card over gloo; one card a rank over
NCCL where there are two)::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m paddle_tpu_torch.distributed.pipeline_selftest [--nccl]

trains GPT-3 1.3B at dp 1 x pp 2 (bf16 compute over fp32 parameters,
AdamW with ``ClipGradByGlobalNorm(1.0)``, 4 x 1024 tokens, 4 micro-
batches): losses, step times, launches, p2p transfers and collectives a
step; then a tiny fp32 scan GPT at pp 2 on the card against the same
ranks on the CPU, and `PipelineParallel` / `GPTForCausalLMPipe` on the
card against one rank running the whole model. Rank 0 prints one JSON
line (`launch_card`; ``--tiny`` runs the tiny models alone, and with
``--tiny-mp 2`` in four ranks the tiny scan GPT at pp 2 x mp 2).
``--zb`` runs the zero-bubble ring alone (`zb_full_width`: GPT-3 1.3B's
widths through `GPTForCausalLMPipe`, the AD ring then the zero-bubble
ring on the same weights; `zb_card_cpu`: a tiny zero-bubble pipe and
`zb_linear_pipeline`, card against CPU; with ``--tiny`` the latter
alone).
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
from .sharding_selftest import _block, _np

__all__ = ["CASES", "launch", "launch_card", "main", "run_card", "start",
           "tiny_pipe_model", "zb_card_cpu", "zb_full_width"]


def _t(a, dev, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.requires_grad_(grad)


def _init(dp=1, pp=1, mp=1, accumulate_steps=1, sharding=1):
    from .fleet import DistributedStrategy, fleet

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    s.pipeline_configs = {"accumulate_steps": accumulate_steps}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _tanh_block(ws, x):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x


def case_ring(ctx):
    """Over the pp group of ``n / (dp * sharding)`` stages (``dp``,
    ``sharding``: 1 unless given; each data rank runs its own ring):
    p2p_permute and its backward; pipeline_spmd on the rank's stage of
    ``W`` [n, nc, lps, h, h] for each ``(M, nc)`` (and at ``nc`` 1
    pipeline_spmd_zb); pipeline_spmd_hetero:
    stage 0 shifts int ids, stage 1 embeds them, the rest tanh-linear."""
    from . import collective as C
    from .fleet.meta_parallel.spmd_pipeline import (microbatch,
                                                    pipeline_spmd,
                                                    pipeline_spmd_hetero,
                                                    pipeline_spmd_zb,
                                                    unmicrobatch)

    dev, a = ctx.device, ctx.args
    dp, sh = a.get("dp", 1), a.get("sharding", 1)
    hcg = _init(dp=dp, pp=ctx.nprocs // (dp * sh), sharding=sh)
    group = hcg.get_pipe_parallel_group()
    r, n = hcg.get_stage_id(), group.nranks
    out = {"stage": r}
    x = _t(a["perm_x"][r], dev, True)
    y = C.p2p_permute(x, [(i, (i + 1) % n) for i in range(n)], group)
    (y * _t(a["perm_w"][r], dev)).sum().backward()
    out["perm"] = [_np(y), _np(x.grad)]
    half = C.p2p_permute(x.detach(), [(0, n - 1)], group)
    out["perm_partial"] = _np(half)
    for key, (M, nc) in a["spmd"].items():
        W = a["W"][key]
        w = _t(W[r] if nc > 1 else W[r][0], dev, True)
        xs = _t(a["x"][key], dev, True)
        got = unmicrobatch(pipeline_spmd(_tanh_block, w, microbatch(xs, M),
                                         group=group, num_chunks=nc))
        torch.sin(got).sum().backward()
        out[f"spmd_{key}"] = [_np(got), _np(w.grad), _np(xs.grad)]
        if nc == 1:         # the zero-bubble ring on the same stage
            w = _t(W[r][0], dev, True)
            xs = _t(a["x"][key], dev, True)
            got = unmicrobatch(pipeline_spmd_zb(
                _tanh_block, w, microbatch(xs, M), group=group))
            torch.sin(got).sum().backward()
            out[f"zb_{key}"] = [_np(got), _np(w.grad), _np(xs.grad)]
    h = a["het"]
    params = ({} if r == 0 else {"e": _t(h["E"], dev, True)} if r == 1
              else {"w": _t(h["Ws"][r], dev, True)})
    fns = ([lambda p, t: t + 1, lambda p, t: p["e"][t]]
           + [lambda p, t: torch.tanh(t @ p["w"])] * (n - 2))
    got = pipeline_spmd_hetero(fns, params, _t(h["ids"], dev), group=group)
    (got * _t(h["R"], dev)).sum().backward()
    out["het"] = [_np(got)] + [_np(v.grad) for v in params.values()]
    C.barrier()
    return out


# ---------------------------------------------------------------------------
# PipelineLayer / PipelineParallel
# ---------------------------------------------------------------------------

class EmbedPipe(torch.nn.Embedding):
    """The tied embedding of the tiny pipeline model."""


class TanhLinear(torch.nn.Linear):
    def forward(self, x):
        return torch.tanh(super().forward(x))


def _head(layer, x):
    return x @ layer.weight.t()


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def tiny_pipe_model(vocab, hidden, blocks, num_stages=None, stage_id=None,
                    seg_method="uniform"):
    """The tiny tied-embedding pipeline model: a `SharedLayerDesc`
    embedding, ``blocks`` tanh-linear layers, the embedding again as the
    head."""
    from .fleet.meta_parallel import LayerDesc, PipelineLayer, SharedLayerDesc

    descs = ([SharedLayerDesc("embed", EmbedPipe, None, "weight", vocab,
                              hidden)]
             + [LayerDesc(TanhLinear, hidden, hidden)
                for _ in range(blocks)]
             + [SharedLayerDesc("embed", EmbedPipe, _head, "weight", vocab,
                                hidden)])
    return PipelineLayer(descs, num_stages=num_stages, loss_fn=_ce,
                         seg_method=seg_method, stage_id=stage_id)


def _pp_train(ctx, a, accumulate, scaler=True, poison=None):
    """``steps`` train_batch steps of the tiny model from the reference's
    weights on the rank's rows of the data axes: (losses, state dict, the
    scaler's scale, the wrapper)."""
    from .. import convert
    from ..amp import GradScaler
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from .fleet import fleet

    dev = ctx.device
    fleet._strategy.pipeline_configs = {"accumulate_steps": accumulate}
    pl = tiny_pipe_model(**a["dims"]).to(dev)
    pl.load_state_dict(convert.pipeline_state_dict_from_jax(a["named"], pl))
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=a["lr"], parameters=pl.parameters(),
        epsilon=a["eps"], grad_clip=ClipGradByGlobalNorm(a["clip"])))
    sc = GradScaler(init_loss_scaling=1024.0) if scaler else None
    data = _rows(ctx, a)
    hooks = []
    if poison is not None and pl.get_stage_id() == poison:
        p = next(iter(pl.parameters()))
        hooks.append(p.register_hook(
            lambda g: g.index_fill(0, torch.tensor([0], device=g.device),
                                   float("inf"))))
    losses = [float(model.train_batch(data, opt, scaler=sc))
              for _ in range(a["steps"])]
    for h in hooks:
        h.remove()
    return (np.asarray(losses), {k: _np(v) for k, v in pl.state_dict().items()},
            None if sc is None else sc.get_loss_scaling(), model)


def _rows(ctx, a):
    """The rank's rows of the batch over the data axes (dp x sharding)."""
    from .fleet import fleet

    g = fleet.get_hybrid_communicate_group().get_sharding_data_group()
    return tuple(_block(_t(a[k], ctx.device), g.rank, g.nranks)
                 for k in ("ids", "labels"))


def case_pp_layers(ctx):
    """At pp ``n / (dp * sharding)`` (``dp``, ``sharding``: 1 unless
    given): `PipelineParallel` over the tiny tied model, each data rank
    on its own rows."""
    n, a = ctx.nprocs, ctx.args
    dp, sh = a.get("dp", 1), a.get("sharding", 1)
    hcg = _init(dp=dp, pp=n // (dp * sh), sharding=sh)
    out = {"hcg": [hcg.get_pipe_parallel_world_size(), hcg.get_stage_id(),
                   hcg.is_first_stage(), hcg.is_last_stage(),
                   hcg.get_p2p_next_rank(), hcg.get_p2p_prev_rank()]}
    for acc in a["accumulate"]:
        losses, sd, scale, model = _pp_train(ctx, a, acc)
        out[f"train_{acc}"] = {"losses": losses, "state": sd,
                               "scale": scale,
                               "wrapper": type(model).__name__}
    ev = model.eval_batch(_rows(ctx, a))
    out["eval"] = float(ev)
    # an inf in the last stage's grads: every stage skips the step
    _, sd, scale, _ = _pp_train(ctx, dict(a, steps=1), a["accumulate"][0],
                                poison=hcg.get_pipe_parallel_world_size()
                                - 1)
    out["poison"] = {"after": sd, "scale": scale}
    out["held_keys"] = sorted(sd)
    return out


# ---------------------------------------------------------------------------
# GPTForCausalLMPipe
# ---------------------------------------------------------------------------

def case_gpt_pipe(ctx):
    """Logits' loss and the rank's grads of `GPTForCausalLMPipe` from the
    reference's arrays, for each ``num_chunks``."""
    from .. import convert
    from ..models import GPTConfig, GPTForCausalLMPipe, GPTPretrainingCriterion

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    _init(pp=n)
    out = {}
    for nc, named in a["named"].items():
        model = GPTForCausalLMPipe(GPTConfig(**a["config"]), num_stages=n,
                                   num_micro=a["micro"], num_chunks=nc,
                                   device=dev)
        model.load_state_dict(convert.pipe_stage_from_jax(named, model))
        model.train()
        loss = GPTPretrainingCriterion()(model(_t(a["ids"], dev)),
                                         _t(a["labels"], dev))
        loss.backward()
        out[nc] = {"loss": float(loss),
                   "grads": {k: _np(p.grad) for k, p in
                             model.named_parameters()},
                   "stage": model.stage}
    # the zero-bubble ring on the chunks-1 weights
    model = GPTForCausalLMPipe(GPTConfig(**a["config"]), num_stages=n,
                               num_micro=a["micro"], use_zero_bubble=True,
                               device=dev)
    model.load_state_dict(convert.pipe_stage_from_jax(a["named"][1], model))
    model.train()
    loss = GPTPretrainingCriterion()(model(_t(a["ids"], dev)),
                                     _t(a["labels"], dev))
    loss.backward()
    out["zb"] = {"loss": float(loss), "grads": {
        k: _np(p.grad) for k, p in model.named_parameters()}}
    return out


# ---------------------------------------------------------------------------
# the zero-bubble ring
# ---------------------------------------------------------------------------

class _CountMM(torch.autograd.Function):
    """``x @ w`` whose backward records whether it was asked for ``w``'s
    grad, and whether ``w``'s leaf had a ``.grad`` by then."""

    seen = []

    @staticmethod
    def forward(ctx, x, w, leaf):
        ctx.save_for_backward(x, w)
        ctx.leaf = leaf
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _CountMM.seen.append((bool(ctx.needs_input_grad[1]),
                              ctx.leaf.grad is not None))
        return (g @ w.t(), x.transpose(-1, -2) @ g
                if ctx.needs_input_grad[1] else None, None)


def case_zero_bubble(ctx):
    """At pp = the world: `zb_linear_pipeline` on the rank's stage of
    ``W`` [n, d, d]; `pipeline_spmd_zb` over `GPTForCausalLMPipe`'s block
    body at each ``dw_chunk``; the grads a ring tick and the fold ask
    for (`_CountMM`), beside the AD ring's; `GPTForCausalLMPipe(
    use_zero_bubble=True)` and its AD ring on the same weights; the two
    refusals."""
    from .. import convert
    from ..models import GPTConfig, GPTForCausalLMPipe, GPTPretrainingCriterion
    from .fleet.meta_parallel.spmd_pipeline import (microbatch,
                                                    pipeline_spmd,
                                                    pipeline_spmd_zb,
                                                    unmicrobatch,
                                                    zb_linear_pipeline)

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    hcg = _init(pp=n)
    group = hcg.get_pipe_parallel_group()
    out = {"stage": hcg.get_stage_id()}
    w = _t(a["lin_w"][r], dev, True)
    xs = _t(a["lin_x"], dev, True)
    y = zb_linear_pipeline(w, xs, group=group)
    torch.sin(y).sum().backward()
    out["lin"] = [_np(y), _np(w.grad), _np(xs.grad)]
    # which grads a tick computes: the AD ring's ask for dW, the
    # zero-bubble ring's alone in the fold after the ring
    for tag, pipe in (("ad", pipeline_spmd), ("zb", pipeline_spmd_zb)):
        w = _t(a["lin_w"][r], dev, True)
        _CountMM.seen = []
        y = pipe(lambda p, x: torch.tanh(_CountMM.apply(x, p, w)), w,
                 _t(a["lin_x"], dev), group=group)
        y.sum().backward()
        out[f"seen_{tag}"] = list(_CountMM.seen)
        out[f"count_{tag}"] = _np(w.grad)
    cfg = GPTConfig(**a["config"])
    named = a["named"]
    model = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=a["micro"],
                               device=dev)
    model.load_state_dict(convert.pipe_stage_from_jax(named, model))
    model.train()
    flats = [f for f, _ in model._stacked_names]
    for c in a["dw_chunks"]:
        leaves = [getattr(model, f)[0].detach().requires_grad_()
                  for f in flats]
        x = _t(a["block_x"], dev, True)
        y = pipeline_spmd_zb(model._block_fn(), leaves, x, group=group,
                             dw_chunk=c)
        torch.sin(y).sum().backward()
        out[f"block_{c}"] = {"out": _np(y), "dx": _np(x.grad), "grads": {
            f: _np(t.grad)[None] for f, t in zip(flats, leaves)}}
    crit = GPTPretrainingCriterion()
    ids, labels = _t(a["ids"], dev), _t(a["labels"], dev)
    for zb in (False, True):
        model = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=a["micro"],
                                   use_zero_bubble=zb, device=dev)
        model.load_state_dict(convert.pipe_stage_from_jax(named, model))
        model.train()
        loss = crit(model(ids), labels)
        loss.backward()
        out["gpt_zb" if zb else "gpt_ad"] = {
            "loss": float(loss),
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}
    refused = {}
    for what, kw, c in (("chunks", dict(num_chunks=2), cfg),
                        ("dropout", {}, GPTConfig(**dict(
                            a["config"], hidden_dropout_prob=0.1)))):
        try:
            GPTForCausalLMPipe(c, num_stages=n, num_micro=a["micro"],
                               use_zero_bubble=True, device=dev, **kw)
            refused[what] = ""
        except ValueError as e:
            refused[what] = str(e)
    out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# the pipelined scan
# ---------------------------------------------------------------------------

def case_pp_scan(ctx):
    """``fleet.init(dp, mp, pp)`` then, for each head and storage,
    ``fleet.distributed_model(gpt).train_step(opt)`` for ``steps`` steps
    on the rank's dp rows."""
    from ..jit import PipelineScanTrainStep
    from ..models import GPTPretrainingCriterion
    from ..observability import registry
    from . import collective as C
    from .mp_selftest import _scan_gpt
    from .fleet import fleet

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    pp, mp, M = a["pp"], a["mp"], a["micro"]
    dp = n // (pp * mp)
    hcg = _init(dp, pp, mp, accumulate_steps=M)
    d = hcg.get_data_parallel_rank()
    crit = GPTPretrainingCriterion()
    ids, labels = (_t(a[k], dev) for k in ("ids", "labels"))
    mine = [_block(ids, d, dp), _block(labels, d, dp)]
    out = {"coords": [d, hcg.get_stage_id(), hcg.get_model_parallel_rank()]}
    for head in a["heads"]:
        cfg = dict(a["config"], tie_word_embeddings=head == "tied")
        named = a["named"][head]
        for storage in ("replicated", "sharded"):
            model = _scan_gpt(ctx, named, cfg)
            opt = _ss._adamw(model, clip=a["clip"], lr=a["lr"])
            if storage == "sharded":
                opt = fleet.distributed_optimizer(opt)
            step = fleet.distributed_model(model).train_step(
                opt, criterion=crit, param_storage=storage,
                guard_nonfinite=True, numerics=False)
            if not isinstance(step, PipelineScanTrainStep):
                raise AssertionError(f"train_step gave {type(step)}")
            tag = f"{head}_{storage}"
            losses = [float(step(*mine)) for _ in range(a["steps"])]
            out[f"losses_{tag}"] = np.asarray(losses)
            out[f"params_{tag}"] = {k: _np(v) for k, v in
                                    model.state_dict().items()}
            out[f"calls_{tag}"] = step.collectives_per_step
            out[f"shards_{tag}"] = step.shard_numels()
            out[f"buckets_{head}"] = \
                [b.numel for b in step._s_assign.buckets] + \
                [b.numel for b in step._o_assign.buckets]
    out["axes"] = [step.group.axes, step.pp_group.axes]
    out["stats"] = step.schedule_stats()
    reg = registry()
    out["gauges"] = [reg.gauge(g).value for g in (
        "pipeline.bubble_fraction", "pipeline.num_micro", "pipeline.degree")]
    # the numerics monitor's rows (tied head, clip, replicated storage)
    model = _scan_gpt(ctx, a["named"]["tied"], a["config"])
    step = fleet.distributed_model(model).train_step(
        _ss._adamw(model, clip=a["clip"], lr=a["lr"]), criterion=crit,
        numerics=True)
    step(*mine)
    out["rows"] = step._numerics.latest_rows()
    # hidden dropout 0.5, every rank the same rows: the masks alone part
    # the losses; torch's seed fixed, so the pp-1 ring can replay them
    out["dropout"] = []
    for _ in range(2):
        torch.manual_seed(0)
        model = _scan_gpt(ctx, a["named"]["tied"],
                          dict(a["config"], hidden_dropout_prob=0.5))
        step = fleet.distributed_model(model).train_step(
            _ss._adamw(model, clip=None, lr=a["lr"]), criterion=crit,
            numerics=False)
        out["dropout"].append([float(step(ids, labels)),
                               float(step.local_loss)])
    refused = {}
    model = _scan_gpt(ctx, a["named"]["tied"], a["config"])
    for what, kw in (("chunks", dict(layer_chunk=a["config"]["num_layers"])),
                     ("micro", dict(num_micro=3))):
        try:
            step = fleet.distributed_model(model).train_step(
                _ss._adamw(model), criterion=crit, numerics=False, **kw)
            step(*mine)
            refused[what] = ""
        except ValueError as e:
            refused[what] = str(e)
    out["refused"] = refused
    C.barrier()
    return out


CASES = {"ring": case_ring, "pp_layers": case_pp_layers,
         "gpt_pipe": case_gpt_pipe, "pp_scan": case_pp_scan,
         "zero_bubble": case_zero_bubble}


def start(case, nprocs, args=None, timeout=60):
    """`sharding_selftest.start` for this module's cases."""
    return _ss.start(case, nprocs, args, timeout, module=__name__)


def launch(case, nprocs, args=None, timeout=60, deadline=150):
    return start(case, nprocs, args, timeout).wait(deadline)


# ---------------------------------------------------------------------------
# on the card, under torch.distributed.run
# ---------------------------------------------------------------------------

def full_width(dev, steps=3, batch=4, seq=1024, micro=4):
    """GPT-3 1.3B at dp 1 x pp (the world) through ``fleet.init`` (the
    strategy's ``pp_degree`` and ``pipeline_configs``) ->
    ``fleet.distributed_model(model)
    .train_step(AdamW + ClipGradByGlobalNorm(1.0))``: bf16 compute over
    fp32 parameters, bf16 moments, weights from seed 0, the sharded
    storage; the losses, step seconds, launches, p2p transfers and
    collectives a step (the last step's), the peak memory."""
    from ..models import GPTForCausalLM, gpt_config
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import collective as C
    from . import env
    from .fleet import fleet
    from .mp_selftest import _counters, _read, full_width_batch

    n = env.get_world_size()
    hcg = _init(pp=n, accumulate_steps=micro)
    cfg = gpt_config("gpt3-1.3b", scan_layers=True)
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    step = fleet.distributed_model(model).train_step(
        opt, compute_dtype="bfloat16", fused_head=True,
        param_storage="sharded", numerics=False)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    counters = _counters()
    losses, times, launches = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        before = _read(counters)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = step(ids, labels)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        after = _read(counters)
        launches.append({k: after[k] - before[k] for k in after})
    calls = step.collectives_per_step
    result = {"losses": losses, "step_s": times,
              "launches_per_step": launches[-1],
              "collectives_per_step": calls,
              "p2p_per_step": {k: calls.get(k, 0) for k in ("send",
                                                            "recv")},
              "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
              "pp": n, "micro": micro, "rank": env.get_rank(),
              "stage": hcg.get_stage_id(),
              "schedule": step.schedule_stats(),
              "axes": [step.group.axes, step.pp_group.axes],
              "buckets": [len(step._s_assign.buckets),
                          len(step._o_assign.buckets)],
              "layers": cfg.num_layers}
    ranks = []
    C.all_gather_object(ranks, {k: result[k] for k in (
        "losses", "launches_per_step", "p2p_per_step", "stage",
        "max_memory_allocated", "step_s", "collectives_per_step")})
    result["ranks"] = ranks
    del step, opt, model
    return result


TINY = dict(vocab_size=128, hidden_size=64, num_layers=4,
            num_attention_heads=4, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def tiny_card_cpu(dev, steps=3, mp=1):
    """A tiny fp32 scan GPT at pp (the world / mp) x mp on the card and
    on the CPU over the same gloo ranks, from the same weights, AdamW with
    the clip, 3 steps of ``fleet.distributed_model(model).train_step``:
    the losses and the largest relative parameter difference (the keys'
    bias aside: `sharding_selftest.key_bias_out`)."""
    from ..models import GPTConfig, GPTForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .fleet import fleet

    n = env.get_world_size()
    _init(pp=n // mp, mp=mp, accumulate_steps=2)
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
    dl = max(abs(x - y) for x, y in zip(out["card"]["losses"],
                                        out["cpu"]["losses"]))
    dp = max(float(np.abs(_ss.key_bias_out(k, _np(v)) - _ss.key_bias_out(
                 k, _np(out["cpu"]["params"][k]))).max()
                   / max(np.abs(_np(out["cpu"]["params"][k])).max(), 1e-12))
             for k, v in out["card"]["params"].items())
    return {"losses_card": out["card"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "max_loss_diff": dl,
            "max_param_rel": dp, "pp": n // mp, "mp": mp}


def pipe_layers_card(dev, steps=2):
    """`PipelineParallel.train_batch` of the tiny tied-embedding model and
    `GPTForCausalLMPipe` (chunks 1 and 2) on the card at pp (the world),
    each against one rank running the whole model from the same weights:
    the largest loss and parameter (or grad) differences."""
    from ..models import (GPTConfig, GPTForCausalLM, GPTForCausalLMPipe,
                          GPTPretrainingCriterion)
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .fleet import fleet

    n, r = env.get_world_size(), env.get_rank()
    _init(pp=n, accumulate_steps=2)
    dims = dict(vocab=64, hidden=32, blocks=2 * n)
    rng = np.random.default_rng(5)
    whole = tiny_pipe_model(**dims, num_stages=1, stage_id=0)
    named = {k: (rng.standard_normal(tuple(v.shape)) * 0.3).astype(
        np.float32) for k, v in whole.state_dict().items()}
    ids = torch.from_numpy(rng.integers(0, 64, (8, 16)))
    labels = torch.from_numpy(rng.integers(0, 64, (8, 16)))
    out = {}

    def train(model, pl, d):
        pl.load_state_dict({k: torch.from_numpy(named[k]) for k in
                            pl.state_dict()})
        opt = AdamW(learning_rate=1e-2, parameters=pl.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5))
        data = (ids.to(d), labels.to(d))
        return ([float(model.train_batch(data, opt)) for _ in range(steps)],
                {k: _np(v) for k, v in pl.state_dict().items()})

    pl = tiny_pipe_model(**dims).to(dev)
    got = train(fleet.distributed_model(pl), pl, dev)
    from .fleet.meta_parallel import PipelineParallel

    one = tiny_pipe_model(**dims, num_stages=1, stage_id=0).to(dev)
    want = train(PipelineParallel(one, None, fleet._strategy), one,
                 dev)
    out["pipeline_parallel"] = {
        "losses": got[0], "world1_losses": want[0],
        "max_loss_diff": max(abs(x - y) for x, y in zip(got[0], want[0])),
        "max_param_rel": max(float(np.abs(v - want[1][k]).max()
                                   / max(np.abs(want[1][k]).max(), 1e-12))
                             for k, v in got[1].items())}
    cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=4 * n // 2,
                    num_attention_heads=4, max_position_embeddings=128,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    plain = GPTForCausalLM(GPTConfig(**{**cfg.__dict__,
                                        "scan_layers": True}), device=dev)
    crit = GPTPretrainingCriterion()
    ids2 = torch.from_numpy(rng.integers(0, 64, (4, 128))).to(dev)
    lab2 = torch.from_numpy(rng.integers(0, 64, (4, 128))).to(dev)
    lp = crit(plain(ids2), lab2)
    lp.backward()
    psd = dict(plain.named_parameters())
    for nc in (1, 2):
        pipe = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=2,
                                  num_chunks=nc, device=dev)
        lps = pipe.layers_per_stage
        with torch.no_grad():
            for name, p in pipe.named_parameters():
                if name.startswith("blocks__"):
                    full = psd[f"gpt.blocks.{name}"]
                    rows = [c * n + r for c in range(nc)]
                    sl = torch.stack([full[q * lps:(q + 1) * lps]
                                      for q in rows])
                    p.copy_(sl.reshape(p.shape))
                else:
                    p.copy_(psd[f"gpt.{name}"])
        pipe.train()
        loss = crit(pipe(ids2), lab2)
        loss.backward()
        worst = 0.0
        for name, p in pipe.named_parameters():
            if name.startswith("blocks__"):
                g = psd[f"gpt.blocks.{name}"].grad
                rows = [c * n + r for c in range(nc)]
                want_g = torch.stack([g[q * lps:(q + 1) * lps]
                                      for q in rows]).reshape(p.shape)
            else:
                want_g = psd[f"gpt.{name}"].grad
            worst = max(worst, float((p.grad - want_g).abs().max()
                                     / want_g.abs().max().clamp(min=1e-12)))
        out[f"gpt_pipe_c{nc}"] = {"loss": float(loss), "plain": float(lp),
                                  "max_grad_rel": worst}
    return out


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def zb_full_width(dev, batch=4, seq=1024, micro=4, cfg=None):
    """Phase 27(a): GPT-3 1.3B's widths (bf16, dropout 0, weights from
    seed 0) through `GPTForCausalLMPipe` at pp = the world, ``micro``
    micro-batches of the ``batch x seq`` tokens: the AD ring, then the
    zero-bubble ring (``use_zero_bubble=True``) on the same weights and
    batch, after a warm-up pass; each ring's loss, seconds and launches
    of one forward and
    backward, and the largest gap of a grad to the AD ring's relative to
    that tensor's largest element (every rank's, gathered). ``cfg``: a
    `GPTConfig` in place of GPT-3 1.3B's (a rehearsal on the CPU)."""
    from ..models import (GPTForCausalLMPipe, GPTPretrainingCriterion,
                          gpt_config)
    from . import collective as C
    from . import env
    from .mp_selftest import _counters, _read, full_width_batch

    n = env.get_world_size()
    hcg = _init(pp=n)
    cfg = cfg or gpt_config("gpt3-1.3b")
    cuda = torch.device(dev).type == "cuda"
    model = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=micro,
                               device=dev, dtype=torch.bfloat16, seed=0)
    model.train()
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    crit = GPTPretrainingCriterion()
    counters = _counters()
    out, grads = {}, {}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for tag in ("warm-up", "ad", "zb"):       # the first pass warms up
        model.use_zero_bubble = tag == "zb"
        before = _read(counters)
        _sync(dev)
        t0 = time.perf_counter()
        loss = crit(model(ids), labels)
        loss.backward()
        _sync(dev)
        secs = time.perf_counter() - t0
        after = _read(counters)
        if tag != "warm-up":
            out[tag] = {"loss": float(loss), "s": secs,
                        "launches": {k: after[k] - before[k] for k in after}}
            grads[tag] = {k: p.grad.float()
                          for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    gap = {k: float((grads["zb"][k] - g).abs().max()
                    / g.abs().max().clamp(min=1e-30))
           for k, g in grads["ad"].items()}
    worst = max(gap, key=gap.get)
    mine = {"stage": hcg.get_stage_id(), "layers": model.layers_per_stage,
            "max_grad_rel": gap[worst], "worst": worst,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None),
            **out}
    ranks = []
    C.all_gather_object(ranks, mine)
    del model, grads
    return {"pp": n, "micro": micro, "tokens": [batch, seq],
            "num_layers": cfg.num_layers, "ranks": ranks}


def _zb_tiny_cfg(n):
    from ..models import GPTConfig

    return GPTConfig(vocab_size=64, hidden_size=64, num_layers=2 * n,
                     num_attention_heads=4, max_position_embeddings=128,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def zb_card_cpu(dev):
    """Phase 27(b)-(c): a tiny fp32 `GPTForCausalLMPipe(use_zero_bubble=
    True)` (2 layers a stage, 4 x 128 tokens, 2 micro-batches) and
    `zb_linear_pipeline` ([8, 4, 64] over a [64, 64] stage) at pp = the
    world, on the card and on the CPU over the same gloo ranks from the
    same numpy weights: the largest loss / output and relative grad
    differences (every rank's)."""
    from ..models import GPTForCausalLMPipe, GPTPretrainingCriterion
    from . import collective as C
    from . import env
    from .fleet.meta_parallel.spmd_pipeline import zb_linear_pipeline

    n = env.get_world_size()
    hcg = _init(pp=n)
    stage = hcg.get_stage_id()
    group = hcg.get_pipe_parallel_group()
    cfg = _zb_tiny_cfg(n)
    rng = np.random.default_rng(20 + stage)
    shapes = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=2,
                                device="cpu").state_dict()
    sd = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.2)
                              .astype(np.float32)) for k, v in shapes.items()}
    data = np.random.default_rng(21)
    ids = torch.from_numpy(data.integers(0, 64, (4, 128)))
    labels = torch.from_numpy(data.integers(0, 64, (4, 128)))
    w = (data.standard_normal((n, 64, 64)) * 0.3).astype(np.float32)
    x = data.standard_normal((8, 4, 64)).astype(np.float32)
    got = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = GPTForCausalLMPipe(cfg, num_stages=n, num_micro=2,
                                   use_zero_bubble=True, device=d)
        model.load_state_dict(sd)
        model.train()
        loss = GPTPretrainingCriterion()(model(ids.to(d)), labels.to(d))
        loss.backward()
        ws, xs = _t(w[stage], d, True), _t(x, d, True)
        y = zb_linear_pipeline(ws, xs, group=group)
        torch.sin(y).sum().backward()
        got[where] = {"loss": float(loss),
                      "grads": {k: p.grad.cpu() for k, p in
                                model.named_parameters()},
                      "lin": [y.detach().cpu(), ws.grad.cpu(),
                              xs.grad.cpu()]}
    card, cpu = got["card"], got["cpu"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    mine = {"stage": stage,
            "gpt_loss_diff": abs(card["loss"] - cpu["loss"]),
            "gpt_max_grad_rel": max(rel(g, cpu["grads"][k])
                                    for k, g in card["grads"].items()),
            "lin_max_out_diff": float((card["lin"][0] - cpu["lin"][0])
                                      .abs().max()),
            "lin_max_grad_rel": max(rel(a, b) for a, b in
                                    zip(card["lin"][1:], cpu["lin"][1:]))}
    ranks = []
    C.all_gather_object(ranks, mine)
    return {"pp": n, "ranks": ranks}


def run_card(nccl=False, steps=3, tiny=False, tiny_mp=1, zb=False):
    """Phase 25's ranks: join the world (gloo sharing the card, or NCCL
    one card a rank), then GPT-3 1.3B at pp = the world, the tiny scan GPT
    card against CPU, `PipelineParallel` and `GPTForCausalLMPipe` card
    against one rank; rank 0's result. With ``tiny`` the tiny runs alone
    (the tiny scan GPT at pp (the world / ``tiny_mp``) x ``tiny_mp``, and
    at mp 1 the eager pipeline)."""
    from . import env

    dev = env.init_parallel_env(backend=None if nccl else "gloo",
                                device=None if nccl else "cuda",
                                timeout=600)
    result = {"backend": env.get_backend(), "device": str(dev),
              "world": env.get_world_size()}
    if zb:
        if not tiny:
            t0 = time.perf_counter()
            result["zb_1.3b"] = zb_full_width(dev)
            result["zb_1.3b"]["wall_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        result["zb_card_cpu"] = zb_card_cpu(dev)
        env.reset()
        return result
    if not tiny:
        t0 = time.perf_counter()
        result["gpt3_1.3b"] = full_width(dev, steps=steps)
        result["gpt3_1.3b"]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    result["tiny_card_cpu"] = tiny_card_cpu(dev, mp=tiny_mp)
    if tiny_mp == 1:
        result["pipe_layers"] = pipe_layers_card(dev)
    env.reset()
    return result


def launch_card(nprocs=2, nccl=False, steps=3, deadline=900, tiny=False,
                tiny_mp=1, zb=False):
    """`run_card` in ``nprocs`` ranks under ``torch.distributed.run`` (a
    free port on 127.0.0.1): rank 0's result. Every rank is killed and
    this raises when the run passes ``deadline`` seconds or fails."""
    from .mp_selftest import launch_card as _launch

    return _launch(nprocs, nccl, steps, deadline, module=__name__,
                   extra=(["--tiny"] if tiny else [])
                   + (["--zb"] if zb else [])
                   + ["--tiny-mp", str(tiny_mp)])


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
    p.add_argument("--tiny", action="store_true",
                   help="the tiny runs alone (no GPT-3 1.3B)")
    p.add_argument("--tiny-mp", type=int, default=1,
                   help="the tiny scan GPT's mp degree (pp: the rest)")
    p.add_argument("--zb", action="store_true",
                   help="the zero-bubble ring alone (phase 27)")
    a = p.parse_args(argv)
    if a.worker:
        _ss.worker(a.worker, a.rank, a.nprocs, a.dir, a.timeout, CASES)
        return 0
    result = run_card(a.nccl, a.steps, a.tiny, a.tiny_mp, a.zb)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
