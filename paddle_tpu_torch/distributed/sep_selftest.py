"""Rank workers of the sep axis (sequence blocks) and its runs on the
card: the counterpart of the reference's tests/test_ring_attention.py,
one process a sep rank.

Each case is a function of one rank (`sharding_selftest.Ctx`) returning
numpy arrays; the caller computes the reference. Cases:

* ``ring``: ``fleet.init(sep_degree=n)``, then for each problem of the
  arguments (global q, k, v and a cotangent, causal or not, fp32 or
  bf16) the rank's blocks through `ring_attention` or
  `ring_flash_attention` and their backward: the rank's blocks of the
  output and of the three grads; and the flash ring's refusal of a block
  that is not a multiple of 128;
* ``sep``: ``fleet.init(dp_degree=d, sep_degree=n / d)``: the rank's
  coordinates and groups; for a GPT (and with ``llama`` a GQA LLaMA),
  ring and gathered K/V, the reference's weights (`convert`) through
  ``fleet.distributed_model`` (`SegmentParallel`): the reference's
  ``crit(model(ids), labels)`` on the rank's rows, the grad of
  ``wte`` after ``apply_collective_grads``, then 3 steps of
  ``train_step(AdamW + ClipGradByGlobalNorm)`` over ``model.loss(ids,
  labels, loss_mask)``: losses and the final parameters;
* ``sep_mp``: ``fleet.init(mp_degree=m, sep_degree=n / m)``: a GQA
  LLaMA built under the fleet (the rank's Megatron blocks of the
  reference's weights), ring and gathered K/V, through
  ``fleet.distributed_model`` (`SegmentParallel`): the criterion's loss
  over the whole logits, then 3 ``train_step`` s over ``model.loss(ids,
  labels)``: losses, the rank's blocks, coordinates and groups;
* ``sep_pp`` / ``sep_hybrid``: ``fleet.init(pp_degree=p, sep_degree,
  mp_degree=1 / 2)``: `LlamaForCausalLMPipe` from the reference's weights
  (`pipe_name`) through `PipelineParallel` (each micro-batch cut to the
  rank's block) and ``fleet.distributed_optimizer``: ``eval_batch``'s
  loss, then ``train_batch`` losses and the rank's state; ``sep_pp``
  also what `GPTForCausalLMPipe` says under the sep group (it refuses).

`launch(case, nprocs, args)` / `start` run a case in gloo ranks on the
CPU (`sharding_selftest.launch` with this module). LLaMA-7B's widths at
mp x sep and tp x pp x sep on the card are `llama_selftest.launch_card`
with ``sep`` (``chip_smoke.py`` phase 30).

On the card (``chip_smoke.py`` phase 29; the ranks share one card over
gloo, NCCL one card a rank with ``--nccl``)::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m paddle_tpu_torch.distributed.sep_selftest [--nccl] [--steps 3] \\
        [--layers L]

(a) `ring_flash_card`: `ring_flash_attention` at GPT-3 1.3B's attention
widths ``[4, 4096, 32, 64]`` (fp32 and bf16, causal and not) against
the plain full attention of the same inputs, computed first in each
rank, its launches of #7 / #8; (b) `gpt_full_width`: GPT-3 1.3B's widths
with ``use_ring_attention=True`` in bf16 (fp32 masters, bf16 moments,
AdamW with the clip, recompute) through ``fleet.distributed_model(...).
train_step`` on 4 x 2048 tokens, a rank holding 4 x 1024: losses, step
times, launches a step, peak memory (`gpt_world_one` is the world of one
it is held to); (c) `llama_full_width`: LLaMA-7B's widths at 2 layers
with the ring, one fp32 step's loss and grads against the world of one
computed in rank 0 first; (d) `tiny_card_cpu`: a tiny fp32 GPT and LLaMA
card against CPU over the same ranks. Rank 0 prints one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import sharding_selftest as _ss
from .llama_selftest import _adamw
from .sharding_selftest import _np

__all__ = ["CASES", "gpt_full_width", "gpt_world_one", "launch",
           "launch_card", "llama_full_width", "main", "pipe_name",
           "ring_flash_card", "run_card", "start", "tiny_card_cpu"]

FULL_WIDTH = dict(batch=4, seq=2048, steps=3)      # phase 29(b)
RING_SHAPE = (4, 4096, 32, 64)                     # phase 29(a)
LLAMA_LAYERS, LLAMA_TOKENS = 2, (2, 2048)          # phase 29(c)


def _init(dp=1, sep=1, mp=1, pp=1, accumulate_steps=1):
    from .fleet import DistributedStrategy, fleet

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sep_degree": sep,
                        "mp_degree": mp, "pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": accumulate_steps}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def pipe_name(name, num_layers):
    """The `LlamaForCausalLMPipe` (the reference's `PipelineLayer`) name
    of `LlamaForCausalLM`'s parameter ``name``: the embedding entry 0,
    decoder layer i entry i + 1, the final norm L + 1, the head L + 2."""
    L = num_layers
    if name == "llama.embed_tokens.weight":
        return "_layers_list.0.embed_tokens.weight"
    if name == "llama.norm.weight":
        return f"_layers_list.{L + 1}.weight"
    if name == "lm_head.weight":
        return f"_layers_list.{L + 2}.lm_head.weight"
    head, i, rest = name.split(".", 3)[1:]
    if head != "layers":
        raise KeyError(name)
    return f"_layers_list.{int(i) + 1}.{rest}"


def _groups(hcg):
    """This rank's groups' ranks, by axis."""
    return {k: list(g.ranks) for k, g in (
        ("dp", hcg.get_data_parallel_group()),
        ("mp", hcg.get_model_parallel_group()),
        ("pp", hcg.get_pipe_parallel_group()),
        ("sep", hcg.get_sep_parallel_group()),
        ("dp_sep", hcg.get_dp_sep_parallel_group()),
        ("check", hcg.get_check_parallel_group()))}


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# CPU cases
# ---------------------------------------------------------------------------

def case_ring(ctx):
    """Each problem's rank blocks through the ring, forward and backward
    (``sum(out * cot)``)."""
    from .fleet.meta_parallel import (ring_attention, ring_flash_attention,
                                      sep_shard)

    hcg = _init(sep=ctx.nprocs)
    g = hcg.get_sep_parallel_group()
    out = {"sep_rank": hcg.get_sep_parallel_rank()}
    for key, p in ctx.args["problems"].items():
        dtype = getattr(torch, p["dtype"])
        q, k, v = (sep_shard(_t(p[x], ctx.device, dtype), g)
                   .detach().requires_grad_() for x in ("q", "k", "v"))
        cot = sep_shard(_t(p["cot"], ctx.device, dtype), g)
        fn = ring_flash_attention if p["kind"] == "flash" else ring_attention
        o = fn(q, k, v, g, causal=p["causal"])
        (o.float() * cot.float()).sum().backward()
        out[key] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                    "dv": _np(v.grad)}
    try:
        x = torch.zeros(1, 64, 2, 16)
        ring_flash_attention(x, x, x, g)
        out["refuse_block"] = ""
    except ValueError as e:
        out["refuse_block"] = str(e)
    return out


def _model_run(ctx, family, ring, named, batch):
    """One model of ``family`` (``gpt`` / ``llama``) from the reference's
    weights through ``fleet.distributed_model``: the criterion's loss on
    the rank's rows and the embedding's grad after the sync, then
    ``train_step`` losses and the final parameters."""
    from .. import convert
    from ..models import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                          LlamaConfig, LlamaForCausalLM)
    from .fleet import fleet

    a = ctx.args
    if family == "gpt":
        model = GPTForCausalLM(GPTConfig(**a["gpt"], use_ring_attention=ring),
                               device=ctx.device)
        emb = "gpt.wte.weight"
    else:
        model = LlamaForCausalLM(LlamaConfig(**a["llama"],
                                             use_ring_attention=ring),
                                 device=ctx.device)
        emb = "llama.embed_tokens.weight"
    model.load_state_dict(convert.state_dict_from_jax(named, model=model))
    model.train()
    wrapped = fleet.distributed_model(model)
    ids, labels, mask = batch
    loss = GPTPretrainingCriterion()(wrapped(ids), labels)
    loss.backward()
    wrapped.apply_collective_grads()
    grad = _np(dict(model.named_parameters())[emb].grad)
    for p in model.parameters():
        p.grad = None
    step = wrapped.train_step(_adamw(model, a), numerics=False)
    losses = [float(step(ids, labels, mask)) for _ in range(a["steps"])]
    return {"wrapper": type(wrapped).__name__, "fwd_loss": float(loss),
            "emb_grad": grad, "losses": np.asarray(losses),
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def case_sep(ctx):
    """At dp ``a["dp"]`` x sep (the rest): coordinates, groups, and the
    models through `SegmentParallel`."""
    from . import env

    a = ctx.args
    dp = a["dp"]
    hcg = _init(dp=dp, sep=ctx.nprocs // dp)
    out = {"coords": [hcg.get_data_parallel_rank(),
                      hcg.get_sep_parallel_rank()],
           "degrees": [hcg.get_data_parallel_world_size(),
                       hcg.get_sep_parallel_world_size()],
           "groups": {k: list(g.ranks) for k, g in (
               ("dp", hcg.get_data_parallel_group()),
               ("sep", hcg.get_sep_parallel_group()),
               ("dp_sep", hcg.get_dp_sep_parallel_group()))}}
    batch = env.data_shard([_t(a[k], ctx.device) for k in
                            ("ids", "labels", "mask")])
    for family in a["families"]:
        for ring in (True, False):
            out[f"{family}_{'ring' if ring else 'gathered'}"] = _model_run(
                ctx, family, ring, a["named"][family], batch)
    return out


def _coords(hcg):
    return [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
            hcg.get_sep_parallel_rank(), hcg.get_model_parallel_rank()]


def case_sep_mp(ctx):
    """At mp ``a["mp"]`` x sep (the rest): a GQA LLaMA built under the
    fleet (the rank's Megatron blocks of the reference's weights, with
    the ring and with the gathered K/V) through
    ``fleet.distributed_model`` (`SegmentParallel`): the reference's
    ``crit(model(ids), labels)`` on the whole logits (gathered over mp
    and sep), then ``train_step(AdamW + ClipGradByGlobalNorm)`` over
    ``model.loss(ids, labels)``: losses and the rank's blocks."""
    from .. import convert
    from ..models import (GPTPretrainingCriterion, LlamaConfig,
                          LlamaForCausalLM)
    from .fleet import fleet
    from .llama_selftest import _adamw, _state

    a, dev = ctx.args, ctx.device
    mp = a["mp"]
    hcg = _init(mp=mp, sep=ctx.nprocs // mp)
    r = hcg.get_model_parallel_rank()
    ids, labels = _t(a["ids"], dev), _t(a["labels"], dev)
    out = {"coords": _coords(hcg), "groups": _groups(hcg)}
    for ring in (True, False):
        model = LlamaForCausalLM(LlamaConfig(**a["llama"],
                                             use_ring_attention=ring),
                                 device=dev)
        model.load_state_dict(convert.mp_state_dict_from_jax(
            a["named"], model, r, mp))
        model.train()
        wrapped = fleet.distributed_model(model)
        with torch.no_grad():
            fwd = float(GPTPretrainingCriterion()(wrapped(ids), labels))
        step = wrapped.train_step(_adamw(model, a), numerics=False)
        losses = [float(step(ids, labels)) for _ in range(a["steps"])]
        out["ring" if ring else "gathered"] = {
            "fwd_loss": fwd, "losses": np.asarray(losses),
            "state": _state(model),
            "found_group": list(step.optimizer._found_group.ranks),
            "types": [type(wrapped).__name__,
                      type(step.optimizer).__name__]}
    return out


def _pipe_case(ctx, mp):
    """At pp ``a["pp"]`` x sep x ``mp``: `LlamaForCausalLMPipe` from the
    reference's weights (`pipe_name`; the rank's stage, under mp its
    blocks) through ``fleet.distributed_model`` (`PipelineParallel`,
    ``a["accumulate"]`` micro-batches) and ``fleet.distributed_optimizer``,
    with the ring and with the gathered K/V: ``eval_batch``'s loss, then
    ``train_batch`` losses and the rank's state."""
    from .. import convert
    from ..models import LlamaConfig
    from ..models.llama import LlamaForCausalLMPipe
    from .fleet import fleet
    from .llama_selftest import _adamw, _state

    a, dev = ctx.args, ctx.device
    pp = a["pp"]
    hcg = _init(mp=mp, pp=pp, sep=ctx.nprocs // (pp * mp),
                accumulate_steps=a["accumulate"])
    r = hcg.get_model_parallel_rank()
    L = a["llama"]["num_layers"]
    named = {pipe_name(k, L): v for k, v in a["named"].items()}
    data = (_t(a["ids"], dev), _t(a["labels"], dev))
    out = {"coords": _coords(hcg), "groups": _groups(hcg)}
    for ring in (True, False):
        pl = LlamaForCausalLMPipe(LlamaConfig(**a["llama"],
                                              use_ring_attention=ring),
                                  device=dev)
        pl.load_state_dict(convert.pipeline_state_dict_from_jax(
            named, pl, r, mp))
        pl.train()
        model = fleet.distributed_model(pl)
        fwd = float(model.eval_batch(data))
        opt = fleet.distributed_optimizer(_adamw(pl, a))
        losses = [float(model.train_batch(data, opt))
                  for _ in range(a["steps"])]
        out["ring" if ring else "gathered"] = {
            "fwd_loss": fwd, "losses": np.asarray(losses),
            "state": _state(pl), "wrapper": type(model).__name__,
            "found_group": list(opt._found_group.ranks)}
    if mp == 1:
        out["gpt_pipe"] = _gpt_pipe_refusal(dev, pp)
    return out


def _gpt_pipe_refusal(dev, pp):
    """What `GPTForCausalLMPipe` says under the fleet's sep group: its
    error, or "" had it been built."""
    from ..models import GPTConfig
    from ..models.gpt_pipe import GPTForCausalLMPipe

    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=32)
    try:
        GPTForCausalLMPipe(cfg, num_stages=pp, num_micro=2, device=dev)
    except NotImplementedError as e:
        return str(e)
    return ""


def case_sep_pp(ctx):
    """`_pipe_case` at pp x sep."""
    return _pipe_case(ctx, mp=1)


def case_sep_hybrid(ctx):
    """`_pipe_case` at mp 2 x pp x sep."""
    return _pipe_case(ctx, mp=2)


CASES = {"ring": case_ring, "sep": case_sep, "sep_mp": case_sep_mp,
         "sep_pp": case_sep_pp, "sep_hybrid": case_sep_hybrid}


def launch(case, nprocs, args=None, timeout=60, deadline=150):
    """`sharding_selftest.launch` with this module's cases."""
    return _ss.launch(case, nprocs, args, timeout, deadline,
                      module=__name__)


def start(case, nprocs, args=None, timeout=60):
    return _ss.start(case, nprocs, args, timeout, module=__name__)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _sync(dev):
    if _ss._cuda(dev):
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    if _ss._cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if _ss._cuda(dev) else None


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _counts():
    from ..ops.kernels import flash_attention as fa

    return {"flash_fwd": fa.flash_attention_fwd.launches
            + fa.flash_attention_fwd.launches_wgmma,
            "flash_bwd": fa.flash_attention_bwd.launches
            + fa.flash_attention_bwd.launches_wgmma}


def _plain_full(q, k, v, dout, causal):
    """The plain full attention of the tiled pair (`flash_attention_ref`,
    `flash_attention_bwd_ref`) over the whole sequence, one batch row at
    a time (the scores of a row are ``[1, h, s, s]`` fp32)."""
    from ..ops.kernels import flash_attention as fa

    outs, grads = [], []
    for i in range(q.shape[0]):
        sl = [t[i:i + 1] for t in (q, k, v, dout)]
        o, lse = fa.flash_attention_ref(*sl[:3], causal, return_lse=True)
        outs.append(o)
        grads.append(fa.flash_attention_bwd_ref(*sl[:3], o, lse, sl[3],
                                                causal))
    return (torch.cat(outs), *(torch.cat([g[j] for g in grads])
                               for j in range(3)))


def ring_flash_card(dev, shape=RING_SHAPE):
    """Phase 29(a) in a rank: for fp32 and bf16, causal and not, the
    rank's blocks through `ring_flash_attention` (twice: bit for bit) and
    its backward, against the rank's blocks of the plain full attention
    of the same inputs (drawn on the card from seed 0), computed first;
    the ring's launches of #7 / #8 and its seconds."""
    from .fleet.meta_parallel import ring_flash_attention, sep_shard
    from . import collective as C
    from .fleet import fleet

    g = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        base = [torch.randn(shape, device=dev, generator=gen) * s
                for s in (1.0, 1.0, 1.0, 0.1)]
        for causal in (True, False):
            q, k, v, do = (t.to(dtype) for t in base)
            want = [sep_shard(t, g) for t in _plain_full(q, k, v, do,
                                                         causal)]
            blocks = [sep_shard(t, g).detach() for t in (q, k, v, do)]
            got, secs, counts = [], [], []
            for _ in range(2):
                qb, kb, vb = (t.clone().requires_grad_()
                              for t in blocks[:3])
                c0 = _counts()
                _sync(dev)
                t0 = time.perf_counter()
                o = ring_flash_attention(qb, kb, vb, g, causal=causal)
                _sync(dev)
                t1 = time.perf_counter()
                c1 = _counts()
                o.backward(blocks[3])
                _sync(dev)
                t2 = time.perf_counter()
                c2 = _counts()
                got.append([o.detach(), qb.grad, kb.grad, vb.grad])
                secs.append([t1 - t0, t2 - t1])
                counts.append({"flash_fwd": c1["flash_fwd"]
                               - c0["flash_fwd"],
                               "flash_bwd": c2["flash_bwd"]
                               - c1["flash_bwd"]})
            big = max(float(w.float().abs().max()) for w in want[1:])
            rows.append({
                "dtype": str(dtype).split(".")[-1], "causal": causal,
                "shape": list(shape),
                "max_abs_err": float((got[0][0].float()
                                      - want[0].float()).abs().max()),
                "max_grad_rel": max(float((a.float() - w.float()).abs()
                                          .max()) / big
                                    for a, w in zip(got[0][1:], want[1:])),
                "same_twice": all(torch.equal(a, b)
                                  for a, b in zip(*got)),
                "launches": counts[0], "launches_again": counts[1],
                "fwd_s": [s[0] for s in secs], "bwd_s": [s[1] for s in secs],
                "finite": all(bool(torch.isfinite(t).all())
                              for t in got[0])})
            del q, k, v, do, want, blocks, got
            torch.cuda.empty_cache()
    rec = {"sep_rank": g.rank, "rows": rows}
    ranks = []
    C.all_gather_object(ranks, rec)
    return ranks


def _gpt_cfg(layers=None, seq=FULL_WIDTH["seq"]):
    from ..models import gpt_config

    return gpt_config("gpt3-1.3b", use_recompute=True,
                      use_ring_attention=True, max_position_embeddings=seq,
                      **({} if layers is None else {"num_layers": layers}))


def gpt_world_one(dev, steps=FULL_WIDTH["steps"], layers=None):
    """Phase 29(b)'s world of one: the same model, optimizer and global
    batch through a `jit.TrainStep` (dense attention: a world of one has
    no ring): losses, launches a step, peak memory."""
    return _ss.stage3_world_one(dev, steps=steps, batch=FULL_WIDTH["batch"],
                                seq=FULL_WIDTH["seq"],
                                cfg=_gpt_cfg(layers))


def gpt_full_width(dev, steps=FULL_WIDTH["steps"], layers=None):
    """Phase 29(b) in a rank: GPT-3 1.3B's widths with the ring (bf16
    weights, fp32 masters, bf16 moments, AdamW with the clip, recompute)
    through ``fleet.distributed_model(model).train_step(opt)`` on the
    rank's block of 4 x 2048 tokens (the fleet's sep degree is the
    world): losses, step seconds, the last step's launches and
    collectives, peak memory, every rank's."""
    from .. import jit  # noqa: F401  (the step's module, for its counters)
    from . import collective as C
    from . import env
    from .fleet import fleet
    from .mp_selftest import full_width_batch

    cfg, model, opt = _ss._stage3_model(dev, _gpt_cfg(layers))
    wrapped = fleet.distributed_model(model)
    step = wrapped.train_step(opt, numerics=False)
    batch = full_width_batch(cfg, dev, FULL_WIDTH["batch"],
                             FULL_WIDTH["seq"])
    _reset_peak(dev)
    calls = []

    def after():
        calls.append(dict(C.calls_by_group))

    C.reset_counts()
    losses, secs, launches, _ = _ss._timed(step, batch, steps, dev, after)
    per_step = {k: v - calls[-2].get(k, 0) for k, v in calls[-1].items()} \
        if len(calls) > 1 else calls[-1]
    rec = {"rank": env.get_rank(), "losses": losses, "step_s": secs,
           "launches_per_step": launches, "collectives_per_step": per_step,
           "wrapper": type(wrapped).__name__,
           "max_memory_allocated": _peak(dev)}
    ranks = []
    C.all_gather_object(ranks, rec)
    del step, opt, wrapped, model
    _free()
    return {"layers": cfg.num_layers, "tokens": [FULL_WIDTH["batch"],
                                                 FULL_WIDTH["seq"]],
            "ranks": ranks}


def _llama_grads(model, ids, labels, loss_fn):
    loss = loss_fn(ids, labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad
                                  for n, p in model.named_parameters()}


def llama_full_width(dev, layers=LLAMA_LAYERS, tokens=LLAMA_TOKENS):
    """Phase 29(c) in a rank: LLaMA-7B's widths at ``layers`` layers,
    fp32, weights from seed 0: rank 0 first runs the world of one (the
    fleet's topology set aside: dense attention over the whole batch),
    then every rank its block with the ring through `SegmentParallel`
    (``loss``, then ``apply_collective_grads``): the loss and the
    largest relative grad difference (over each tensor's largest
    element), on rank 0."""
    from ..models import LlamaForCausalLM, llama_config
    from . import collective as C
    from .fleet import fleet
    from .fleet import topology

    cfg = llama_config("llama-7b", num_layers=layers,
                       use_ring_attention=True,
                       max_position_embeddings=tokens[1])
    rng = np.random.default_rng(2)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, tokens))
                   .to(dev) for _ in range(2))
    hcg = fleet.get_hybrid_communicate_group()
    want = None
    if hcg.get_sep_parallel_rank() == 0:
        topology.set_hybrid_communicate_group(None)
        try:
            m1 = LlamaForCausalLM(cfg, device=dev, seed=0)
            m1.train()
            loss1, g1 = _llama_grads(m1, ids, labels, m1.loss)
            want = (loss1, {n: g.detach().clone() for n, g in g1.items()})
            del m1, g1
        finally:
            topology.set_hybrid_communicate_group(hcg)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.train()
    wrapped = fleet.distributed_model(model)
    _reset_peak(dev)
    t0 = time.perf_counter()
    loss, grads = _llama_grads(model, ids, labels, wrapped.loss)
    wrapped.apply_collective_grads()
    _sync(dev)
    secs = time.perf_counter() - t0
    rec = {"loss": loss, "step_s": secs, "max_memory_allocated": _peak(dev)}
    if want is not None:
        rec["world1_loss"] = want[0]
        rec["loss_diff"] = abs(loss - want[0])
        rec["max_grad_rel"] = max(
            float((grads[n] - w).abs().max() / w.abs().max().clamp(
                min=1e-30)) for n, w in want[1].items())
    ranks = []
    C.all_gather_object(ranks, rec)
    del model, wrapped, grads, want
    _free()
    return {"model": "llama-7b widths", "layers": layers,
            "tokens": list(tokens), "ranks": ranks}


TINY_GPT = dict(vocab_size=128, hidden_size=64, num_layers=2,
                num_attention_heads=4, max_position_embeddings=64)
TINY_LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=96, max_position_embeddings=64)


def tiny_card_cpu(dev, steps=3):
    """Phase 29(d) in a rank: a tiny fp32 GPT and a GQA LLaMA with the
    ring through `SegmentParallel` on the card and on the CPU over the
    same gloo ranks, from the CPU's draw of the weights: the loss of a
    forward, the largest relative grad difference, and ``steps`` AdamW
    steps' losses."""
    from ..models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                          LlamaForCausalLM)
    from . import env
    from .fleet import fleet

    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (4, 64))
    labels = rng.integers(0, 128, (4, 64))
    a = {"lr": 1e-3, "eps": 1e-8, "clip": 1.0}
    out = {}
    for family, build in (
            ("gpt", lambda d: GPTForCausalLM(GPTConfig(
                **TINY_GPT, use_ring_attention=True), device=d, seed=3)),
            ("llama", lambda d: LlamaForCausalLM(LlamaConfig(
                **TINY_LLAMA, use_ring_attention=True), device=d, seed=3))):
        runs, drawn = {}, None
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = build(d)
            if drawn is None:
                drawn = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(drawn)
            model.train()
            wrapped = fleet.distributed_model(model)
            batch = env.data_shard([torch.from_numpy(x).to(d)
                                    for x in (ids, labels)])
            loss = wrapped.loss(*batch)
            loss.backward()
            wrapped.apply_collective_grads()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
            for p in model.parameters():
                p.grad = None
            step = wrapped.train_step(_adamw(model, a), numerics=False)
            runs[where] = {"loss": float(loss), "grads": grads,
                           "losses": [float(step(*batch))
                                      for _ in range(steps)]}
            del model, wrapped, step
        c, p = runs["card"], runs["cpu"]
        out[family] = {
            "loss_card": c["loss"], "loss_cpu": p["loss"],
            "loss_diff": abs(c["loss"] - p["loss"]),
            "max_grad_rel": max(float((g - p["grads"][n]).abs().max()
                                      / p["grads"][n].abs().max().clamp(
                                          min=1e-30))
                                for n, g in c["grads"].items()),
            "losses_card": c["losses"], "losses_cpu": p["losses"],
            "max_step_loss_diff": max(abs(x - y) for x, y in
                                      zip(c["losses"], p["losses"]))}
    return out


def run_card(nccl=False, steps=3, layers=None):
    """Phase 29's ranks: join the world (gloo sharing the card, or NCCL
    one card a rank) at sep = the world; (a)-(d) over gloo, (b) alone
    over NCCL; rank 0's result."""
    from . import env

    dev = env.init_parallel_env(backend=None if nccl else "gloo",
                                device=None if nccl else "cuda",
                                timeout=600)
    _init(sep=env.get_world_size())
    result = {"backend": env.get_backend(), "device": str(dev),
              "world": env.get_world_size()}
    parts = [("gpt", lambda: gpt_full_width(dev, steps, layers))]
    if not nccl:
        parts = [("ring", lambda: ring_flash_card(dev))] + parts + [
            ("llama", lambda: llama_full_width(dev)),
            ("tiny", lambda: tiny_card_cpu(dev))]
    for tag, run in parts:
        t0 = time.perf_counter()
        result[tag] = run()
        result[f"{tag}_wall_s"] = time.perf_counter() - t0
    env.reset()
    return result


def launch_card(nprocs=2, nccl=False, steps=3, layers=None, deadline=900):
    """`run_card` in ``nprocs`` ranks under ``torch.distributed.run``:
    rank 0's result (`mp_selftest.launch_card`: every rank killed past
    ``deadline``)."""
    from .mp_selftest import launch_card as _launch

    return _launch(nprocs, nccl, steps, deadline, module=__name__,
                   extra=[] if layers is None else ["--layers", str(layers)])


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
    p.add_argument("--layers", type=int, default=None)
    a = p.parse_args(argv)
    if a.worker:
        _ss.worker(a.worker, a.rank, a.nprocs, a.dir, a.timeout, CASES)
        return 0
    result = run_card(a.nccl, a.steps, a.layers)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
