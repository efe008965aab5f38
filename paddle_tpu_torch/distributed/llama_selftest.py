"""Rank workers of LLaMA under the mp and pp axes, and its runs on the
card (with the sep axis beside them too): the counterpart of the
reference's ``test_config5_tp_pp_sp_slice`` (tests/test_llama_bert.py),
and of its `PipelineParallel` over a `PipelineLayer` of LLaMA's pieces
(the CPU cases beside sep: `sep_selftest`'s ``sep_mp``, ``sep_pp`` and
``sep_hybrid``).

Each case is a function of one rank (`sharding_selftest.Ctx`) returning
numpy arrays; the caller computes the reference. Cases:

* ``llama_mp``: ``fleet.init(dp, mp)``, then for each head (tied,
  untied) a `models.LlamaForCausalLM` built under the fleet (the rank's
  Megatron blocks, placed by `llama_sharding_rules`) with the
  reference's weights (`convert.mp_state_dict_from_jax`), its whole
  logits, and ``fleet.distributed_model(llama).train_step(AdamW +
  ClipGradByGlobalNorm)`` on the rank's rows of the data axes: losses,
  the rank's state; a model drawn from a seed (the world of one's
  tensors, block for block); with ``o2`` the untied model through
  ``amp.decorate(level="O2")`` and recompute;
* ``llama_pp``: ``fleet.init(dp, mp, pp)``, `models.LlamaForCausalLMPipe`
  with the reference's weights (`convert.pipeline_state_dict_from_jax`)
  through ``fleet.distributed_model`` (`PipelineParallel`) and
  ``fleet.distributed_optimizer``: ``train_batch`` losses, the rank's
  state and coordinates.

`launch(case, nprocs, args)` / `start` run a case in gloo ranks on the
CPU (`sharding_selftest.launch` with this module).

On the card (the ranks share one card over gloo; NCCL one card a rank
with ``--nccl``)::

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m paddle_tpu_torch.distributed.llama_selftest [--nccl] [--steps 3]

trains LLaMA-7B's widths (hidden 4096, 32 heads, intermediate 11008,
vocab 32000; 8 layers) at dp 1 x mp (the world) in bf16 through
``amp.decorate(level="O2")`` with recompute, AdamW with
``ClipGradByGlobalNorm(1.0)``, 4 x 2048 tokens: losses, step times,
launches and collectives a step; then a tiny fp32 GQA LLaMA at mp 2 on
the card against the same ranks on the CPU. With ``--pp 2`` (8 ranks)
the same model at tp (the world / 2) x pp 2 through `PipelineParallel`
(``accumulate_steps`` 4): losses, sends and receives, peak memory; then
the tiny model at pp 2 x mp 2. With ``--sep 2`` the sep axis beside
them (``--layers``, ``--batch``, ``--micro`` set the depth, the rows of
2048 tokens and the micro-batches; the model runs the ring): mp (the
world / 2) x sep 2 through `SegmentParallel`, or with ``--pp 2`` tp x
pp 2 x sep 2. Rank 0 prints one JSON line. The weights are drawn on the
card from seed 0, as `world_one` draws them (`chip_smoke.py` phases 26
and 30 compare).
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

__all__ = ["CASES", "FULL_WIDTH", "TINY", "full_width", "launch",
           "launch_card", "main", "pipe_full_width", "run_card", "start",
           "tiny_card_cpu", "world_one"]


def _t(a, dev, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.requires_grad_(grad)


def _init(dp=1, mp=1, pp=1, accumulate_steps=1, sep=1):
    from .fleet import DistributedStrategy, fleet

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sep_degree": sep}
    s.pipeline_configs = {"accumulate_steps": accumulate_steps}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _adamw(model, a):
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    return AdamW(learning_rate=a["lr"], parameters=model.parameters(),
                 epsilon=a.get("eps", 1e-8), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(a["clip"]))


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# dp x mp
# ---------------------------------------------------------------------------

def case_llama_mp(ctx):
    """At dp ``n / mp`` x ``mp``: for each head the reference's weights
    through ``fleet.distributed_model(llama).train_step(opt)``."""
    from .. import convert
    from ..models import LlamaConfig, LlamaForCausalLM
    from . import env
    from .fleet import fleet

    dev, a = ctx.device, ctx.args
    mp = a["mp"]
    hcg = _init(dp=ctx.nprocs // mp, mp=mp)
    r = hcg.get_model_parallel_rank()
    ids, labels = _t(a["ids"], dev), _t(a["labels"], dev)
    mine = env.data_shard([ids, labels])
    out = {"coords": [hcg.get_data_parallel_rank(), r]}
    for head in a["heads"]:
        cfg = LlamaConfig(**a["config"], tie_word_embeddings=head == "tied")
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(convert.mp_state_dict_from_jax(
            a["named"][head], model, r, mp))
        model.train()
        with torch.no_grad():
            logits = model(ids[:1])
        wrapped = fleet.distributed_model(model)
        step = wrapped.train_step(_adamw(model, a), numerics=False)
        losses = [float(step(*mine)) for _ in range(a["steps"])]
        out[head] = {"logits": _np(logits), "losses": np.asarray(losses),
                     "state": _state(model),
                     "types": [type(wrapped).__name__, type(step).__name__,
                               type(step.optimizer).__name__]}
    # drawn from a seed: the blocks of the world of one's tensors
    seeded = LlamaForCausalLM(LlamaConfig(**a["config"]), device=dev,
                              seed=a["seed"])
    out["seeded"] = _state(seeded)
    if a.get("o2"):
        out["o2"] = _o2_run(ctx, a, mine)
    return out


def _o2_run(ctx, a, mine):
    """The untied model in bf16 through ``amp.decorate(level="O2")``
    (fp32 masters) with recompute: losses and the masters, as the
    rank's blocks."""
    from .. import convert
    from ..amp import decorate
    from ..models import LlamaConfig, LlamaForCausalLM
    from .fleet import fleet

    mp = a["mp"]
    r = fleet.get_hybrid_communicate_group().get_model_parallel_rank()
    cfg = LlamaConfig(**a["config"], use_recompute=True)
    model = LlamaForCausalLM(cfg, device=ctx.device)
    model.load_state_dict(convert.mp_state_dict_from_jax(
        a["named"]["untied"], model, r, mp))
    model.train()
    opt = _adamw(model, a)
    model, opt = decorate(models=model, optimizers=opt, level="O2")
    step = fleet.distributed_model(model).train_step(opt, numerics=False)
    losses = [float(step(*mine)) for _ in range(a["steps"])]
    masters = {n: _np(opt._master_weights[p])
               for n, p in model.named_parameters()}
    return {"losses": np.asarray(losses), "masters": masters}


# ---------------------------------------------------------------------------
# pp (x mp)
# ---------------------------------------------------------------------------

def case_llama_pp(ctx):
    """At dp ``n / (pp * mp)`` x pp x mp: `LlamaForCausalLMPipe` from the
    reference's `PipelineLayer` arrays through `PipelineParallel`."""
    from .. import convert
    from ..models import LlamaConfig
    from ..models.llama import LlamaForCausalLMPipe
    from .fleet import fleet

    dev, a = ctx.device, ctx.args
    mp, pp = a["mp"], a["pp"]
    hcg = _init(dp=ctx.nprocs // (mp * pp), mp=mp, pp=pp,
                accumulate_steps=a["accumulate"])
    r = hcg.get_model_parallel_rank()
    pl = LlamaForCausalLMPipe(LlamaConfig(**a["config"]), device=dev)
    pl.load_state_dict(convert.pipeline_state_dict_from_jax(
        a["named"], pl, r, mp))
    pl.train()
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(_adamw(pl, a))
    g = hcg.get_sharding_data_group()
    data = tuple(_block(_t(a[k], dev), g.rank, g.nranks)
                 for k in ("ids", "labels"))
    losses = [float(model.train_batch(data, opt))
              for _ in range(a["steps"])]
    return {"losses": np.asarray(losses), "state": _state(pl),
            "coords": [hcg.get_data_parallel_rank(), hcg.get_stage_id(), r],
            "wrapper": type(model).__name__}


def case_llama_hybrid(ctx):
    """At dp 1 x pp x mp: the reference's weights (the rank's blocks under
    mp) through ``fleet.distributed_model(llama).train_step(opt)`` on the
    whole batch."""
    from .. import convert
    from ..models import LlamaConfig, LlamaForCausalLM
    from .fleet import fleet

    dev, a = ctx.device, ctx.args
    mp, pp = a["mp"], a["pp"]
    hcg = _init(mp=mp, pp=pp)
    r = hcg.get_model_parallel_rank()
    model = LlamaForCausalLM(LlamaConfig(**a["config"]), device=dev)
    model.load_state_dict(convert.mp_state_dict_from_jax(a["named"], model,
                                                         r, mp))
    model.train()
    wrapped = fleet.distributed_model(model)
    step = wrapped.train_step(_adamw(model, a), numerics=False)
    data = [_t(a[k], dev) for k in ("ids", "labels")]
    losses = [float(step(*data)) for _ in range(a["steps"])]
    return {"losses": np.asarray(losses), "state": _state(model),
            "coords": [hcg.get_stage_id(), r],
            "types": [type(wrapped).__name__,
                      type(step.optimizer).__name__]}


CASES = {"llama_mp": case_llama_mp, "llama_pp": case_llama_pp,
         "llama_hybrid": case_llama_hybrid}


def start(case, nprocs, args=None, timeout=60):
    """`sharding_selftest.start` for this module's cases."""
    return _ss.start(case, nprocs, args, timeout, module=__name__)


def launch(case, nprocs, args=None, timeout=60, deadline=120):
    return start(case, nprocs, args, timeout).wait(deadline)


# ---------------------------------------------------------------------------
# on the card, under torch.distributed.run
# ---------------------------------------------------------------------------

# LLaMA-7B's widths (llama_config("llama-7b")), depth cut to 8 layers
FULL_WIDTH = dict(num_layers=8, use_recompute=True)


def _counters():
    from ..ops.kernels import fused_cross_entropy as fce
    from ..ops.kernels import multi_tensor as mt

    return {"fused_ce_fwd_wgmma_kernel": (fce.fused_ce_fwd, "launches_wgmma"),
            "fused_ce_bwd_kernels": (fce.fused_ce_bwd, "launches"),
            "mt_adam_kernel": (mt.multi_tensor_adam, "launches"),
            "mt_norm_kernel": (mt.multi_tensor_norm, "launches")}


def _read(counters):
    return {k: getattr(f, a) for k, (f, a) in counters.items()}


def full_width_config(**over):
    from ..models import llama_config

    return llama_config("llama-7b", **{**FULL_WIDTH, **over})


def full_width_batch(cfg, dev, batch=4, seq=2048):
    """The global batch: ids and labels from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)
            for _ in range(2)]


def _cuda(dev):
    return torch.device(dev).type == "cuda"


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if _cuda(dev) else None


def _o2(model):
    """AdamW(1e-4) with bf16 moments and the clip, the model in bf16
    through ``amp.decorate(level="O2")`` (phase 16's dtypes)."""
    from ..amp import decorate
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    return decorate(models=model, optimizers=opt, level="O2")


def world_one(dev, steps=3, batch=4, seq=2048, cfg=None):
    """`full_width`'s model, optimizer and batch through a world-of-one
    `jit.TrainStep`: its losses, what the mp and pp runs are held to."""
    from ..jit import TrainStep
    from ..models import LlamaForCausalLM

    cfg = cfg or full_width_config()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.train()
    model, opt = _o2(model)
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                     numerics=False)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    losses = [float(step(ids, labels)) for _ in range(steps)]
    del step, opt, model
    return losses


def _grad_buckets(model):
    """The grads' buckets of one `fused_allreduce_gradients` over the
    model's parameters (`comm_bucketer.build_buckets`'s count)."""
    from .comm_bucketer import build_buckets

    return len(build_buckets([(i, tuple(p.shape), p.dtype) for i, p in
                              enumerate(model.parameters())
                              if p.requires_grad]).buckets)


def _timed_steps(run, steps, dev):
    """``run()`` ``steps`` times: losses, seconds, launches and
    collectives of each step (the last step's returned)."""
    from . import collective as C

    counters = _counters()
    losses, times, launches = [], [], []
    for _ in range(steps):
        before = _read(counters)
        if _cuda(dev):
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with C.counting() as calls:
            loss = run()
            losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        after = _read(counters)
        launches.append({k: after[k] - before[k] for k in after})
    return losses, times, launches[-1], calls


def full_width(dev, steps=3, batch=4, seq=2048, cfg=None, sep=1):
    """LLaMA-7B's widths at dp 1 x mp (the world / ``sep``) x ``sep``
    through ``fleet.init`` -> ``fleet.distributed_model(llama).
    train_step(AdamW + ClipGradByGlobalNorm(1.0))`` (`TensorParallel`,
    or at ``sep`` above 1 `SegmentParallel`: each rank its block of the
    sequence), `_o2`'s dtypes, weights from seed 0: the losses, step
    seconds, launches and collectives a step (the last step's), the
    peak memory; every rank's losses."""
    from ..models import LlamaForCausalLM
    from . import collective as C
    from . import env
    from .fleet import fleet

    n = env.get_world_size()
    hcg = _init(mp=n // sep, sep=sep)
    cfg = cfg or full_width_config()
    if _cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.train()
    model, opt = _o2(model)
    step = fleet.distributed_model(model).train_step(opt, numerics=False)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    losses, times, launches, calls = _timed_steps(
        lambda: step(ids, labels), steps, dev)
    result = {"losses": losses, "step_s": times,
              "launches_per_step": launches, "collectives_per_step": calls,
              "max_memory_allocated": _peak(dev),
              "mp": n // sep, "sep": sep, "rank": env.get_rank(),
              "mp_rank": hcg.get_model_parallel_rank(),
              "sep_rank": hcg.get_sep_parallel_rank(),
              "grad_buckets": _grad_buckets(model),
              "head_rows": int(model.head_weight().shape[0]),
              "layers": cfg.num_layers,
              "types": [type(step.model).__name__, type(step).__name__,
                        type(step.optimizer).__name__]}
    ranks = []
    C.all_gather_object(ranks, losses)
    result["rank_losses"] = ranks
    del step, opt, model
    return result


def pipe_full_width(dev, steps=2, batch=4, seq=2048, pp=2, micro=4,
                    cfg=None, sep=1):
    """`full_width`'s model at tp (the world / (``pp`` x ``sep``)) x pp
    x ``sep`` through `models.LlamaForCausalLMPipe` ->
    ``fleet.distributed_model`` (`PipelineParallel`, ``micro``
    micro-batches, each cut to the rank's block of the sequence at
    ``sep`` above 1) and ``train_batch``: losses, step seconds,
    launches, sends / receives and collectives a step, the peak memory,
    of every rank."""
    from ..models.llama import LlamaForCausalLMPipe
    from . import collective as C
    from . import env
    from .fleet import fleet

    n = env.get_world_size()
    hcg = _init(mp=n // (pp * sep), pp=pp, accumulate_steps=micro, sep=sep)
    cfg = cfg or full_width_config()
    if _cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)
    pl = LlamaForCausalLMPipe(cfg, device=dev, seed=0)
    pl.train()
    pl, opt = _o2(pl)
    model = fleet.distributed_model(pl)
    ids, labels = full_width_batch(cfg, dev, batch, seq)
    losses, times, launches, calls = _timed_steps(
        lambda: model.train_batch((ids, labels), opt), steps, dev)
    by = calls["by_group"]
    result = {"losses": losses, "step_s": times, "launches_per_step":
              launches, "collectives_per_step": calls,
              "p2p_per_step": {k: by.get(f"{k}@pp", 0)
                               for k in ("send", "recv")},
              "max_memory_allocated": _peak(dev),
              "stage": hcg.get_stage_id(),
              "mp_rank": hcg.get_model_parallel_rank(),
              "sep_rank": hcg.get_sep_parallel_rank(),
              "grad_buckets": _grad_buckets(pl),
              "layers": sum(type(m).__name__ == "LlamaDecoderLayer"
                            for m, _ in pl.run_function),
              "rank": env.get_rank(), "pp": pp, "mp": n // (pp * sep),
              "sep": sep, "micro": micro, "wrapper": type(model).__name__}
    ranks = []
    C.all_gather_object(ranks, result)
    del model, opt, pl
    return {"ranks": ranks, "losses": losses}


TINY = dict(vocab_size=128, hidden_size=64, num_layers=4,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, max_position_embeddings=64)


def tiny_card_cpu(dev, mp=2, pp=1, steps=3, sep=1):
    """A tiny fp32 GQA LLaMA (KV heads 2) at dp x pp x sep x mp (the
    world) on the card and on the CPU over the same gloo ranks, from the
    same weights (the CPU generator's draw: the card's draws other
    numbers), AdamW with the clip, 3 steps (`LlamaForCausalLMPipe`
    through ``train_batch`` at ``pp`` above 1, else ``train_step``; the
    ring at ``sep`` above 1): the losses and the largest relative
    difference of the rank's parameters."""
    from ..models import LlamaConfig, LlamaForCausalLM
    from ..models.llama import LlamaForCausalLMPipe
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .fleet import fleet

    n = env.get_world_size()
    _init(dp=n // (mp * pp * sep), mp=mp, pp=pp, accumulate_steps=2,
          sep=sep)
    cfg = LlamaConfig(**TINY, use_ring_attention=sep > 1)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY["vocab_size"], (4, 32))
    labels = rng.integers(0, TINY["vocab_size"], (4, 32))
    out, drawn = {}, None
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = (LlamaForCausalLMPipe(cfg, device=d, seed=3) if pp > 1
                 else LlamaForCausalLM(cfg, device=d, seed=3))
        if drawn is None:       # the CPU's draw, on both
            drawn = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(drawn)
        model.train()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        wrapped = fleet.distributed_model(model)
        batch = env.data_shard([torch.from_numpy(x).to(d)
                                for x in (ids, labels)])
        if pp > 1:
            opt = fleet.distributed_optimizer(opt)
            run = lambda: wrapped.train_batch(tuple(batch), opt)  # noqa
        else:
            step = wrapped.train_step(opt, numerics=False)
            run = lambda: step(*batch)  # noqa: E731
        out[where] = {"losses": [float(run()) for _ in range(steps)],
                      "params": {k: v.detach().cpu() for k, v in
                                 model.state_dict().items()}}
        del model, opt, wrapped
    dl = max(abs(a - b) for a, b in zip(out["card"]["losses"],
                                        out["cpu"]["losses"]))
    dp = max(float((a - out["cpu"]["params"][k]).abs().max()
                   / out["cpu"]["params"][k].abs().max().clamp(min=1e-12))
             for k, a in out["card"]["params"].items())
    return {"losses_card": out["card"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "max_loss_diff": dl,
            "max_param_rel": dp, "mp": mp, "pp": pp, "sep": sep}


def run_card(nccl=False, steps=3, pp=1, sep=1, layers=None, batch=4,
             micro=4):
    """Phase 26's and phase 30's ranks: join the world (gloo sharing the
    card, or NCCL one card a rank), train LLaMA-7B's widths (``layers``
    deep, default 8; ``batch`` x 2048 tokens) at mp = the world / ``sep``
    x ``sep`` (``pp`` 1) or at tp (the world / (``pp`` x ``sep``)) x pp x
    ``sep`` (``micro`` micro-batches), then the tiny model card against
    CPU (mp 2, at ``pp`` 2 pp 2 x mp 2, x ``sep``); rank 0's result.
    Under sep the model runs the ring (``use_ring_attention``)."""
    from . import env

    dev = env.init_parallel_env(backend=None if nccl else "gloo",
                                device=None if nccl else "cuda",
                                timeout=900)
    result = {"backend": env.get_backend(), "device": str(dev),
              "world": env.get_world_size()}
    over = {} if layers is None else {"num_layers": layers}
    cfg = full_width_config(**over, use_ring_attention=sep > 1)
    t0 = time.perf_counter()
    if pp == 1:
        result["llama_7b"] = full_width(dev, steps=steps, batch=batch,
                                        cfg=cfg, sep=sep)
    else:
        result["llama_7b"] = pipe_full_width(dev, steps=steps, batch=batch,
                                             pp=pp, micro=micro, cfg=cfg,
                                             sep=sep)
    result["llama_7b"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if not nccl:
        t0 = time.perf_counter()
        result["tiny_card_cpu"] = tiny_card_cpu(dev, mp=2, pp=pp, sep=sep)
        result["tiny_card_cpu"]["wall_s"] = time.perf_counter() - t0
    env.reset()
    return result


def launch_card(nprocs=4, nccl=False, steps=3, pp=1, deadline=900, sep=1,
                layers=None, batch=4, micro=4):
    """`run_card` in ``nprocs`` ranks under ``torch.distributed.run`` (a
    free port on 127.0.0.1): rank 0's result. Every rank is killed and
    this raises when the run passes ``deadline`` seconds or fails."""
    from .mp_selftest import launch_card as _launch

    extra = ["--pp", str(pp), "--sep", str(sep), "--batch", str(batch),
             "--micro", str(micro)]
    if layers is not None:
        extra += ["--layers", str(layers)]
    return _launch(nprocs, nccl, steps, deadline, module=__name__,
                   extra=extra)


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
    p.add_argument("--pp", type=int, default=1,
                   help="the pipeline degree (mp: the rest of the world)")
    p.add_argument("--sep", type=int, default=1,
                   help="the sep degree (mp: the rest of the world)")
    p.add_argument("--layers", type=int, default=None,
                   help="decoder layers (default 8)")
    p.add_argument("--batch", type=int, default=4,
                   help="rows of 2048 tokens")
    p.add_argument("--micro", type=int, default=4,
                   help="micro-batches at --pp above 1")
    a = p.parse_args(argv)
    if a.worker:
        _ss.worker(a.worker, a.rank, a.nprocs, a.dir, a.timeout, CASES)
        return 0
    result = run_card(a.nccl, a.steps, a.pp, a.sep, a.layers, a.batch,
                      a.micro)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
