"""Where the training step's time goes on the card.

    [FLAGS_splash_attn=0] python -m paddle_tpu_torch.profile_training \\
        [--steps N] [--seq S] [--batch B] [--per-param]
    python -m paddle_tpu_torch.profile_training --resnet [--batch B]
    python -m paddle_tpu_torch.profile_training --fused-scan [--seq S] \
        [--batch B]
    python -m paddle_tpu_torch.profile_training --sharded \
        [--storage sharded|replicated] [--seq S] [--batch B]
    python -m paddle_tpu_torch.profile_training --llama [--seq S] \
        [--batch B]
    python -m paddle_tpu_torch.profile_training --bert [--seq S] \
        [--batch B]
    python -m paddle_tpu_torch.profile_training --moe [--seq S] \
        [--batch B]

Builds the configuration of ``chip_smoke.py`` phases 9-10 (GPT-3 1.3B
width, bf16 weights from seed 0, fp32 masters, bf16 AdamW moments,
global-norm clip 1.0, recompute, ``--batch`` x ``--seq`` random tokens
from seed 0, default 8 x 1024; the position table is ``--seq`` long),
takes two warm-up steps, then ``--steps`` steps (default 2) under
``torch.profiler`` and prints one JSON line: the wall time per step, the
device time summed over every kernel (one stream, so kernels never
overlap), the device's idle share of the wall, kernels launched per step,
the device time of each training kernel (splash, or with
``FLAGS_splash_attn`` off, which the registry reads from the environment,
the flash kernels of the length's path; and the fused cross entropy), of
the optimizer, of the matrix products and of everything else, and the
top kernels by device time. The optimizer's time is every kernel
launched between ``opt.step()``'s entry and its exit (a
``record_function`` range: by default the fused AdamW's two kernels,
``mt_norm_kernel`` and ``mt_adam_kernel``, also reported by name; with
``--per-param``, ``use_multi_tensor=False``, the per-parameter loop's
aten calls and the clip's norm kernel), beside the range's span on the
device, which holds the gaps between its kernels too. Needs a CUDA
card.

``--resnet`` profiles ``chip_smoke.py`` phase 12's step instead
(ResNet-50 from seed 0, fp32, Momentum(0.1, 0.9), CrossEntropyLoss, a
``--batch`` of 3 x 224 x 224 random images, default 32) and splits its
device time into cuDNN's convolutions (their layout transposes
included), batch norm, pooling, the optimizer (the kernels inside
``opt.step()``: the per-parameter Momentum loop's aten calls) and the
rest (ReLU, residual adds, the Linear, the loss, grad accumulation).
A kernel's group is that of the operator that launched it
(``aten::convolution``, ``ConvolutionBackward0``, ``aten::batch_norm``,
...), not its name: cuDNN's convolution kernels and cuBLAS's matrix
products are named alike. The sums of gradients that meet at a tensor
count as the rest.

``--fused-scan`` profiles ``chip_smoke.py`` phase 14's step
(`jit.FusedScanTrainStep` over GPT-3 1.3B with ``scan_layers``: fp32
parameters from seed 0, bf16 compute, AdamW with bf16 moments, no clip,
the fused head, one layer a chunk) twice, with the numerics monitor on
(the default) and off, and splits the monitor-on step into attention
(splash), the fused CE, the matrix products, the optimizer
(``mt_adam_kernel``), the numerics monitor (the device time the monitor
adds: busy time on minus busy time off) and the rest.

``--sharded`` profiles ``chip_smoke.py`` phase 23(b)'s step: phase
14's model and optimizer through `jit.ShardedFusedScanTrainStep` over a
world of one rank on NCCL (`distributed.init_parallel_env`), with the
``--storage`` given (default "sharded"), the numerics monitor off, and
splits it into attention (splash), the fused CE, the matrix products,
the optimizer on the shards (``mt_adam_kernel`` and ``mt_norm_kernel``),
the copies that pack grads into buckets and move shards (kernels named
``copy`` or ``cat``, and device-to-device memcpys: a world of one's
collectives and same-dtype ``copy_``), the NCCL kernels and the rest,
with the device's idle share of the wall.

``--llama`` profiles ``chip_smoke.py`` phase 16's step (TinyLlama-1.1B
from seed 0 through ``amp.decorate(level="O2")``, AdamW with fp32
masters and bf16 moments, clip 1.0, recompute, ``--batch`` x ``--seq``
random tokens, default 4 x 2048) with the numerics monitor on and off,
and splits the monitor-on step into the dense attention (its two
batched products, scale, mask, casts and softmax, forward, recompute and
backward: every kernel launched under an ``aten::bmm`` (only the
attention's products are batched; the Linear layers' are ``aten::mm``)
or under an operator with an input of ``batch * heads * seq * seq``
elements, the score matrix), the fused CE, the other matrix products,
the optimizer (the kernels inside ``opt.step()``), the numerics monitor
(busy time on minus off) and the rest (RMSNorm, RoPE, SwiGLU, the
residual adds, the embedding).

``--moe`` profiles ``chip_smoke.py`` phase 31(b)'s step (GPT-3 1.3B's
widths at 8 of 24 layers with 8 experts a layer, gshard, capacity factor
2, weights from seed 0, through phase 14's `jit.FusedScanTrainStep`
configuration, the numerics monitor on) and splits it into attention
(splash), the fused CE, the experts' batched products (kernels launched
under an ``aten::bmm`` / ``aten::baddbmm`` or under their backward:
only the experts' products are batched there), the routing (the gate's
softmax, argmax and slot counts, the dispatch's and the combine's row
copies: kernels under those operators or their backward), the other
matrix products (the Linear layers' and the router's), the optimizer
(``mt_adam_kernel``) and the rest (the monitor, norms, gelu, adds).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .jit import FusedScanTrainStep, TrainStep
from .amp import decorate
from .models import (BertForSequenceClassification, GPTForCausalLM,
                     GPTPretrainingCriterion, LlamaForCausalLM, bert_config,
                     gpt_config, llama_config)
from .nn import ClipGradByGlobalNorm, CrossEntropyLoss
from .optimizer import AdamW, Momentum
from .utils import flags
from .vision.models import resnet50

_KERNELS = ("splash_fwd_wgmma_kernel", "splash_fwd_kernel",
            "splash_delta_kernel", "splash_dq_wgmma_kernel",
            "splash_dkdv_wgmma_kernel", "splash_dkdv_kernel",
            "splash_dq_kernel",
            "flash_single_fwd_wgmma_kernel", "flash_single_fwd_kernel",
            "flash_single_dq_wgmma_kernel", "flash_single_dkdv_wgmma_kernel",
            "flash_single_dq_kernel", "flash_single_dkdv_kernel",
            "flash_fwd_wgmma_kernel", "flash_fwd_kernel",
            "flash_delta_kernel", "flash_dq_wgmma_kernel",
            "flash_dkdv_wgmma_kernel", "flash_dkdv_kernel", "flash_dq_kernel",
            "fused_ce_fwd_wgmma_kernel", "fused_ce_fwd_kernel",
            "fused_ce_combine_kernel",
            "fused_ce_bwd_wgmma_kernel<0>", "fused_ce_bwd_wgmma_kernel<1>",
            "fused_ce_bwd_wgmma_kernel<2>", "fused_ce_dh_kernel",
            "fused_ce_dw_kernel", "fused_ce_cast_kernel")
_GEMM = ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")
_OPTIMIZER = ("mt_norm_kernel", "mt_adam_kernel")
_RANGE = "optimizer.step"
# the ResNet step's groups by the operator (lower case) that launched a
# kernel: the forward's aten operator or the backward's autograd node (the
# 1 x 1 adaptive pool runs as a mean, its backward as MeanBackward). Not
# the engine's ``evaluate_function`` range around a node: it also holds
# the sums of gradients that meet at a tensor (the residual adds').
_ENGINE = "autograd::engine::evaluate_function"
_RESNET_GROUPS = (
    ("batch_norm", ("batch_norm", "batchnorm")),
    ("pooling", ("pool", "meanbackward")),
    ("convolution", ("convolution",)),
)


def _annotate(opt):
    """Mark every ``opt.step()`` as a profiler range."""
    step = opt.step

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(_RANGE):
            return step(*args, **kwargs)

    opt.step = annotated


def build(batch=8, seq=1024, seed=0, per_param=False):
    """(step, ids, labels) of the phase-9/10 configuration (with
    ``per_param``, AdamW's ``use_multi_tensor=False``)."""
    cfg = gpt_config("gpt3-1.3b", use_recompute=True,
                     max_position_embeddings=seq)
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0),
                use_multi_tensor=not per_param)
    _annotate(opt)
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt)
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.max_position_embeddings)
    dev = next(model.parameters()).device
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    return step, ids, labels


def build_fused_scan(batch=8, seq=1024, seed=0):
    """(model, opt, ids, labels) of ``chip_smoke.py`` phase 14."""
    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=seq,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     scan_layers=True)
    model = GPTForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    return model, opt, ids, labels


def profile_fused_scan(batch, seq, steps):
    """One JSON line: the fused-scan step's device time by column, with
    the numerics monitor on and off; the monitor's column is the
    difference of the two runs' busy time over the same model."""
    model, opt, ids, labels = build_fused_scan(batch, seq)
    runs = {}
    for numerics in (True, False):
        step = FusedScanTrainStep(model, opt,
                                  criterion=GPTPretrainingCriterion(),
                                  fused_head=True, compute_dtype="bfloat16",
                                  layer_chunk=1, numerics=numerics)
        kernels, _, wall = _profile(step, (ids, labels), steps)

        def share(names):
            return sum(us for k, (us, _) in kernels.items()
                       if any(n in k.lower() for n in names)) / 1e6 / steps

        cols = {"attention_s_per_step": share(("splash",)),
                "fused_ce_s_per_step": share(("fused_ce",)),
                "gemm_s_per_step": share(_GEMM),
                "optimizer_s_per_step": share(("mt_adam_kernel",))}
        busy = share(("",))
        runs[numerics] = {
            "wall_s_per_step": wall / steps,
            "device_busy_s_per_step": busy,
            "device_idle_share": 1.0 - busy * steps / wall,
            "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
            **cols, "other_s_per_step": busy - sum(cols.values()),
            "training_kernels_s_per_step": {
                n: t for n in _KERNELS if (t := share((n.lower(),))) > 0},
            "top_kernels": _top(kernels)}
    on, off = runs[True], runs[False]
    numerics = on["device_busy_s_per_step"] - off["device_busy_s_per_step"]
    on["numerics_s_per_step"] = numerics
    on["other_s_per_step"] -= numerics
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "step": "FusedScanTrainStep", "model": "gpt3-1.3b",
        "seq": seq, "batch": batch, "steps": steps,
        **on, "numerics_off": off}))


MOE_LAYERS, MOE_EXPERTS = 8, 8
# the operators (lower case) of the MoE routing, forward and backward
_ROUTING = ("softmax", "cumsum", "argmax", "index_copy", "indexcopy",
            "index_select", "indexselect", "index_add", "gather",
            "aten::where", "aten::eq", "aten::lt")


def build_moe(batch=8, seq=1024, seed=0):
    """(step, ids, labels) of ``chip_smoke.py`` phase 31(b)."""
    cfg = gpt_config("gpt3-1.3b", num_layers=MOE_LAYERS,
                     num_experts=MOE_EXPERTS, scan_layers=True,
                     use_recompute=True, recompute_policy="dots",
                     max_position_embeddings=seq, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    step = FusedScanTrainStep(model, opt,
                              criterion=GPTPretrainingCriterion(),
                              fused_head=True, compute_dtype="bfloat16",
                              layer_chunk=1)
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    return step, ids, labels


def _moe_group(ev):
    """"experts" or "routing" for a kernel launched under ``ev`` (by
    ``ev`` or an operator around it), else None."""
    while ev is not None:
        name = ev.name.lower()
        if "bmm" in name:
            return "experts"
        if any(r in name for r in _ROUTING):
            return "routing"
        ev = ev.cpu_parent
    return None


def profile_moe(batch, seq, steps):
    """One JSON line: phase 31(b)'s MoE step by column (module
    docstring)."""
    step, ids, labels = build_moe(batch, seq)
    kernels, prof, wall = _profile(step, (ids, labels), steps)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / steps
    groups = {"experts": 0.0, "routing": 0.0, "gemm": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in ev.kernels:
            g = _moe_group(ev)
            if g is None and any(m in k.name.lower() for m in _GEMM):
                g = "gemm"
            if g is not None:
                groups[g] += k.duration / 1e6 / steps

    def share(names):
        return sum(us for key, (us, _) in kernels.items()
                   if any(n in key.lower() for n in names)) / 1e6 / steps

    cols = {"attention_s_per_step": share(("splash",)),
            "fused_ce_s_per_step": share(("fused_ce",)),
            "expert_products_s_per_step": groups["experts"],
            "routing_s_per_step": groups["routing"],
            "gemm_s_per_step": groups["gemm"],
            "optimizer_s_per_step": share(("mt_adam_kernel",))}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "step": "FusedScanTrainStep", "model": "gpt3-1.3b widths, MoE",
        "layers": MOE_LAYERS, "experts": MOE_EXPERTS, "seq": seq,
        "batch": batch, "steps": steps,
        "wall_s_per_step": wall / steps, "device_busy_s_per_step": busy,
        "device_idle_share": 1.0 - busy * steps / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
        **cols, "other_s_per_step": busy - sum(cols.values()),
        "top_kernels": _top(kernels)}))


def profile_sharded(batch, seq, steps, storage):
    """One JSON line: the sharded fused-scan step's device time by
    column (see the module docstring)."""
    from .distributed import env
    from .jit import ShardedFusedScanTrainStep

    env.init_parallel_env()
    model, opt, ids, labels = build_fused_scan(batch, seq)
    step = ShardedFusedScanTrainStep(
        model, opt, criterion=GPTPretrainingCriterion(), fused_head=True,
        compute_dtype="bfloat16", layer_chunk=1, param_storage=storage,
        numerics=False)
    kernels, _, wall = _profile(step, (ids, labels), steps)

    def share(names):
        return sum(us for k, (us, _) in kernels.items()
                   if any(n in k.lower() for n in names)) / 1e6 / steps

    cols = {"attention_s_per_step": share(("splash",)),
            "fused_ce_s_per_step": share(("fused_ce",)),
            "gemm_s_per_step": share(_GEMM),
            "optimizer_s_per_step": share(_OPTIMIZER),
            "pack_gather_copies_s_per_step": share(("copy", "cat",
                                                    "memcpy")),
            "nccl_s_per_step": share(("nccl",))}
    busy = share(("",))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "step": "ShardedFusedScanTrainStep", "param_storage": storage,
        "world": env.get_world_size(), "model": "gpt3-1.3b", "seq": seq,
        "batch": batch, "steps": steps,
        "wall_s_per_step": wall / steps, "device_busy_s_per_step": busy,
        "device_idle_share": 1.0 - busy * steps / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
        **cols, "other_s_per_step": busy - sum(cols.values()),
        "collectives_per_step": step.collectives_per_step,
        "top_kernels": _top(kernels)}))
    env.reset()


def build_llama(batch=4, seq=2048, seed=0):
    """(model, opt, ids, labels) of ``chip_smoke.py`` phase 16."""
    cfg = llama_config("tinyllama-1.1b", use_recompute=True)
    model = LlamaForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    decorate(models=model, optimizers=opt, level="O2")
    _annotate(opt)
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    return model, opt, ids, labels


def _is_attention(ev, scores):
    """Whether ``ev`` or an operator around it is the dense attention's:
    a batched product or an einsum (LLaMA's and BERT's Linear layers
    multiply with ``aten::mm`` / ``aten::addmm``), or an input of
    ``scores`` elements."""
    while ev is not None:
        if "bmm" in ev.name or "einsum" in ev.name:
            return True
        for shape in ev.input_shapes or ():
            if shape and int(np.prod(shape)) == scores:
                return True
        ev = ev.cpu_parent
    return False


def profile_llama(batch, seq, steps):
    """One JSON line: TinyLlama-1.1B's step (phase 16) by column, with
    the numerics monitor on and off."""
    model, opt, ids, labels = build_llama(batch, seq)
    cfg = model.config
    scores = batch * cfg.num_attention_heads * seq * seq
    runs = {}
    for numerics in (True, False):
        step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                         numerics=numerics)
        kernels, prof, wall = _profile(step, (ids, labels), steps,
                                       record_shapes=True)
        busy = sum(us for us, _ in kernels.values()) / 1e6 / steps
        attention = gemm = 0.0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CPU:
                continue
            for k in ev.kernels:
                if _is_attention(ev, scores):
                    attention += k.duration
                elif any(g in k.name.lower() for g in _GEMM):
                    gemm += k.duration

        def share(names):
            return sum(us for key, (us, _) in kernels.items()
                       if any(n in key.lower() for n in names)) / 1e6 / steps

        fused = sum(share((n,)) for n in _OPTIMIZER)
        optimizer, span = _optimizer_time(prof, steps, fused)
        cols = {"attention_s_per_step": attention / 1e6 / steps,
                "fused_ce_s_per_step": share(("fused_ce",)),
                "gemm_s_per_step": gemm / 1e6 / steps,
                "optimizer_s_per_step": optimizer}
        runs[numerics] = {
            "wall_s_per_step": wall / steps,
            "device_busy_s_per_step": busy,
            "device_idle_share": 1.0 - busy * steps / wall,
            "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
            **cols, "optimizer_span_s_per_step": span,
            "other_s_per_step": busy - sum(cols.values()),
            "top_kernels": _top(kernels)}
    on, off = runs[True], runs[False]
    numerics = on["device_busy_s_per_step"] - off["device_busy_s_per_step"]
    on["numerics_s_per_step"] = numerics
    on["other_s_per_step"] -= numerics
    on["attention_share_of_busy"] = (on["attention_s_per_step"]
                                     / on["device_busy_s_per_step"])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "step": "TrainStep",
        "model": "tinyllama-1.1b", "seq": seq, "batch": batch,
        "steps": steps, **on, "numerics_off": off}))


def build_bert(batch=32, seq=128, seed=0):
    """(step, ids, mask, labels) of ``chip_smoke.py`` phase 20's
    fine-tune step."""
    model = BertForSequenceClassification(bert_config("bert-base"),
                                          num_classes=2, seed=seed)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters(),
                multi_precision=True)
    decorate(models=model, optimizers=opt, level="O2")
    _annotate(opt)
    crit = CrossEntropyLoss()
    step = TrainStep(model, lambda m, i, k, y: crit(m(i, attention_mask=k),
                                                    y), opt)
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    ids = rng.integers(0, model.bert.config.vocab_size, (batch, seq))
    lengths = rng.integers(seq // 4, seq + 1, (batch,))
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int64)
    labels = rng.integers(0, 2, (batch,))
    return step, *(torch.from_numpy(a).to(dev) for a in (ids, mask, labels))


def profile_bert(batch, seq, steps):
    """One JSON line: BERT-base's fine-tune step (phase 20) by column."""
    step, ids, mask, labels = build_bert(batch, seq)
    cfg = step.model.bert.config
    scores = batch * cfg.num_attention_heads * seq * seq
    kernels, prof, wall = _profile(step, (ids, mask, labels), steps,
                                   record_shapes=True)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / steps
    # the profiler's host cost stretches a short step's wall: the idle
    # share is taken against the same steps timed without it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(ids, mask, labels)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / steps
    attention = gemm = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in ev.kernels:
            if _is_attention(ev, scores):
                attention += k.duration
            elif any(g in k.name.lower() for g in _GEMM):
                gemm += k.duration
    fused = sum(us for key, (us, _) in kernels.items()
                if any(n in key for n in _OPTIMIZER)) / 1e6 / steps
    optimizer, span = _optimizer_time(prof, steps, fused)
    cols = {"attention_s_per_step": attention / 1e6 / steps,
            "gemm_s_per_step": gemm / 1e6 / steps,
            "optimizer_s_per_step": optimizer}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "step": "TrainStep",
        "model": "bert-base", "seq": seq, "batch": batch, "steps": steps,
        "dtype": "bfloat16 via amp.decorate O2 (fp32 masters)",
        "dropout": cfg.hidden_dropout_prob,
        "wall_s_per_step": plain_wall,
        "wall_s_per_step_profiled": wall / steps,
        "device_busy_s_per_step": busy,
        "device_idle_share": 1.0 - busy / plain_wall,
        "device_idle_share_profiled": 1.0 - busy * steps / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
        **cols, "optimizer_span_s_per_step": span,
        "other_s_per_step": busy - sum(cols.values()),
        "attention_share_of_busy": cols["attention_s_per_step"] / busy,
        "top_kernels": _top(kernels)}))


def build_resnet(batch=32, seed=0):
    """(step, images, labels) of ``chip_smoke.py`` phase 12."""
    model = resnet50(num_classes=1000, seed=seed)
    crit = CrossEntropyLoss()
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    _annotate(opt)
    step = TrainStep(model, lambda m, x, y: crit(m(x), y), opt)
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    x = torch.from_numpy(rng.standard_normal((batch, 3, 224, 224))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(dev)
    return step, x, y


def _profile(step, batch, steps, record_shapes=False):
    """``steps`` steps under the profiler after two warm-up steps: (the
    device time and count of each kernel, the profiler, the wall)."""
    for _ in range(2):                                 # warm-up
        float(step(*batch))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts,
                                record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # the range also shows on the device as a span: not a kernel
        if dev_us > 0 and ev.device_type == cuda and ev.key != _RANGE:
            us, n = kernels.get(ev.key, (0.0, 0))
            kernels[ev.key] = (us + dev_us, n + ev.count)
    return kernels, prof, wall


def _optimizer_time(prof, steps, fused=0.0):
    """Seconds a step of the kernels inside ``opt.step()`` (the aten
    calls' device time, attributed to the range, plus ``fused``: ours,
    launched through ctypes and attributed to no operator), and the
    range's span on the device, the gaps between its kernels included."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ranges = [ev for ev in prof.events() if ev.name == _RANGE]
    inside = sum(ev.device_time_total for ev in ranges
                 if ev.device_type == cpu) / 1e6 / steps + fused
    span = sum(ev.time_range.elapsed_us() for ev in ranges
               if ev.device_type == cuda) / 1e6 / steps
    return inside, span


def _top(kernels):
    return [{"name": k[:90], "s": us / 1e6, "count": n}
            for k, (us, n) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:15]]


def _optimizer_step_alone(step, batch):
    """One more forward and backward, then ``opt.step()`` alone under the
    profiler: its kernels (copies and fills not counted), their device
    time, and the host time of the call."""
    step.loss_fn(step.model, *batch).backward()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.optimizer.step()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    step.optimizer.clear_grad()
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not any(w in ev.name.lower() for w in ("memcpy",
                                                         "memset"))]
    return {"kernels": len(kernels),
            "device_ms": sum(ev.time_range.elapsed_us()
                             for ev in kernels) / 1e3,
            "host_ms": host * 1e3}


def _kernels_under(ev):
    """(name, device us) of each kernel ``ev`` and its children launched."""
    for k in ev.kernels:
        yield k.name, k.duration
    for child in ev.cpu_children:
        yield from _kernels_under(child)


def _resnet_group(ev):
    if ev.name.startswith(_ENGINE):
        return None
    name = ev.name.lower()
    return next((group for group, marks in _RESNET_GROUPS
                 if any(m in name for m in marks)), None)


def profile_resnet(batch, steps):
    """One JSON line: the ResNet-50 step's device time by group."""
    step, x, y = build_resnet(batch)
    kernels, prof, wall = _profile(step, (x, y), steps)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / steps
    optimizer, span = _optimizer_time(prof, steps)
    groups = dict.fromkeys((g for g, _ in _RESNET_GROUPS), 0.0)
    named = {g: {} for g in groups}
    for ev in prof.events():
        group = _resnet_group(ev)
        if group is None or ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        outer = ev.cpu_parent
        while outer is not None and _resnet_group(outer) is None:
            outer = outer.cpu_parent
        if outer is None:     # the outermost operator of its group
            groups[group] += ev.device_time_total / 1e6 / steps
            for name, us in _kernels_under(ev):
                named[group][name] = named[group].get(name, 0.0) + us
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": "resnet50",
        "batch": batch, "dtype": "float32", "steps": steps,
        "wall_s_per_step": wall / steps,
        "device_busy_s_per_step": busy,
        "device_idle_share": 1.0 - busy * steps / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / steps,
        **{f"{g}_s_per_step": t for g, t in groups.items()},
        "optimizer_s_per_step": optimizer,
        "optimizer_span_s_per_step": span,
        "other_s_per_step": busy - sum(groups.values()) - optimizer,
        "optimizer_step_alone": _optimizer_step_alone(step, (x, y)),
        "group_top_kernels": {
            g: [{"name": k[:90], "s_per_step": us / 1e6 / steps}
                for k, us in sorted(n.items(), key=lambda kv: -kv[1])[:12]]
            for g, n in named.items()},
        "top_kernels": _top(kernels),
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2,
                    help="steps under the profiler")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a row; default 1024 (2048 with --llama)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows (images with --resnet) a step; default 8 "
                         "(32 with --resnet)")
    ap.add_argument("--per-param", action="store_true",
                    help="AdamW's per-parameter loop (use_multi_tensor="
                         "False) instead of the fused kernels")
    ap.add_argument("--resnet", action="store_true",
                    help="ResNet-50's fp32 step (chip_smoke.py phase 12) "
                         "instead of GPT's; --batch defaults to 32")
    ap.add_argument("--llama", action="store_true",
                    help="TinyLlama-1.1B's bf16 O2 step (chip_smoke.py "
                         "phase 16), the numerics monitor on and off; "
                         "--seq defaults to 2048, --batch to 4")
    ap.add_argument("--bert", action="store_true",
                    help="BERT-base's bf16 O2 fine-tune step "
                         "(chip_smoke.py phase 20); --seq defaults to "
                         "128, --batch to 32")
    ap.add_argument("--moe", action="store_true",
                    help="phase 31(b)'s MoE fused-scan step (GPT-3 1.3B's "
                         "widths, 8 layers, 8 experts)")
    ap.add_argument("--fused-scan", action="store_true",
                    help="GPT-3 1.3B through FusedScanTrainStep "
                         "(chip_smoke.py phase 14), the numerics monitor "
                         "on and off")
    ap.add_argument("--sharded", action="store_true",
                    help="GPT-3 1.3B through ShardedFusedScanTrainStep "
                         "over a world of one rank (chip_smoke.py phase "
                         "23(b))")
    ap.add_argument("--storage", default="sharded",
                    choices=("sharded", "replicated"),
                    help="param_storage of --sharded")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA card")
    if args.resnet:
        profile_resnet(args.batch or 32, args.steps)
        return
    if args.fused_scan:
        profile_fused_scan(args.batch or 8, args.seq or 1024, args.steps)
        return
    if args.sharded:
        profile_sharded(args.batch or 8, args.seq or 1024, args.steps,
                        args.storage)
        return
    if args.llama:
        profile_llama(args.batch or 4, args.seq or 2048, args.steps)
        return
    if args.bert:
        profile_bert(args.batch or 32, args.seq or 128, args.steps)
        return
    if args.moe:
        profile_moe(args.batch or 8, args.seq or 1024, args.steps)
        return
    args.batch, args.seq = args.batch or 8, args.seq or 1024
    step, ids, labels = build(args.batch, args.seq,
                              per_param=args.per_param)
    kernels, prof, wall = _profile(step, (ids, labels), args.steps)
    busy = sum(us for us, _ in kernels.values()) / 1e6

    def share(names):
        return sum(us for k, (us, _) in kernels.items()
                   if any(n in k.lower() for n in names)) / 1e6

    ours = {n: t for n in _KERNELS
            if (t := share((n.lower(),)) / args.steps) > 0}
    gemm = share(_GEMM) / args.steps
    # every kernel launched inside opt.step()'s range: ours are taken by
    # name
    fused = {n: t for n in _OPTIMIZER
             if (t := share((n.lower(),)) / args.steps) > 0}
    optimizer, span = _optimizer_time(prof, args.steps, sum(fused.values()))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "seq": args.seq, "batch": args.batch,
        "FLAGS_splash_attn": flags.get_flag("FLAGS_splash_attn"),
        "steps": args.steps,
        "wall_s_per_step": wall / args.steps,
        "device_busy_s_per_step": busy / args.steps,
        "device_idle_share": 1.0 - busy / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / args.steps,
        "training_kernels_s_per_step": ours,
        "optimizer": "per-parameter" if args.per_param else "fused",
        "optimizer_s_per_step": optimizer,
        "optimizer_span_s_per_step": span,
        "optimizer_kernels_s_per_step": fused,
        "gemm_s_per_step": gemm,
        "other_s_per_step": (busy / args.steps - gemm - sum(ours.values())
                             - optimizer),
        "top_kernels": _top(kernels),
    }))


if __name__ == "__main__":
    main()
