"""GPT with pipelined decoder blocks: the port of paddle_tpu/models/
gpt_pipe.py (:32-198).

The reference stacks the blocks' parameters on a leading
``[n_stages, (num_chunks,) layers_per_stage, ...]`` dim sharded over the
pp axis and runs them through `pipeline_spmd`'s ring; the embedding and
ln_f / the tied head live outside the ring. Here a rank of the pipeline
group holds its stage's slice alone, ``[1, (num_chunks,)
layers_per_stage, ...]`` under the reference's names
(``blocks__attn__qkv__weight``, ...; a Linear weight ``[..., out, in]``,
the torch layout), and runs it through the port's `pipeline_spmd`
(`distributed.fleet.meta_parallel.spmd_pipeline`); the blocks are the
port's `GPTBlock` (a template on the ``meta`` device over the slices, as
`GPTStackedBlocks` runs it), so on the card causal attention reaches the
splash kernels. Every rank embeds and runs the head (the ring's output
is replicated), as the reference's outer parameters are replicated; the
grads carry no factor of the stage count (`pipeline_spmd`'s backward).
`convert.pipe_stage_from_jax` / `pipe_stage_to_jax` carry the
reference's stacked arrays to a rank's slice and back.

``use_zero_bubble=True`` runs the ring through `pipeline_spmd_zb`
(the reference's dW-deferred backward: the reverse ticks compute dX
alone, the blocks' weight grads fold after the ring). As in the
reference it takes ``num_chunks=1`` only and refuses dropout: the
reference's backward re-traces the block and would draw other masks;
the port's recompute replays the generator and could keep them, but
holds the reference's contract.

Under a fleet whose sep degree is above 1 the model raises
``NotImplementedError`` naming ROADMAP A9b.5b, at construction and at
each forward: nothing cuts its input to the rank's block of the
sequence, so its blocks' attention would take the sep branch over the
whole sequence at local positions, and a sep rank above 0 would read
its peers' copies as earlier positions (a 2 x 2 gloo run: sep rank 1's
loss 4.164549 against 4.164278, silently).
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn
from torch.func import functional_call

from ..distributed.fleet.meta_parallel.ring_attention import sep_group
from ..distributed.fleet.meta_parallel.spmd_pipeline import (
    _pipe_group, microbatch, pipeline_spmd, pipeline_spmd_zb, unmicrobatch)
from ..framework.device import resolve_device
from ..incubate.distributed.models.moe.moe_layer import A9B3B
from .gpt import GPTBlock, GPTConfig, LayerNorm

__all__ = ["GPTForCausalLMPipe", "gpt_pipe_sharding_rules"]


def _refuse_sep():
    if sep_group() is not None:
        raise NotImplementedError(
            "GPTForCausalLMPipe under a sep degree above 1 is not ported "
            "yet: ROADMAP A9b.5b (nothing cuts its input to the rank's "
            "block of the sequence; LlamaForCausalLMPipe through "
            "PipelineParallel runs pp x sep)")


class GPTForCausalLMPipe(nn.Module):
    """GPT with pipelined decoder blocks.

    Args:
      config: `GPTConfig`; ``num_layers`` divides by ``num_stages *
        num_chunks``.
      num_stages: the pp degree (the pipeline group's size).
      num_micro: micro-batches a forward (the batch divides by it).
      num_chunks: virtual stages a rank (interleave; default 1).
      group: the pipeline group (default: the fleet's pipe group, else
        the world); this rank's stage is its rank there.
      use_zero_bubble: the dW-deferred ring (`pipeline_spmd_zb`).

    A config with experts raises, naming ROADMAP A9b.3b: the ring threads
    no aux loss (the reference refuses MoE under pp too).
    """

    def __init__(self, config: GPTConfig, num_stages, num_micro,
                 num_chunks=1, group=None, use_zero_bubble=False,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        _refuse_sep()
        if config.num_experts:
            # the ring threads no aux loss, as the reference's does not
            raise NotImplementedError(A9B3B.format(
                "GPTForCausalLMPipe with experts (MoE under pp)"))
        self.use_zero_bubble = bool(use_zero_bubble)
        if use_zero_bubble and num_chunks != 1:
            raise ValueError("zero-bubble supports num_chunks=1 only")
        if use_zero_bubble and (config.hidden_dropout_prob
                                or config.attention_dropout_prob):
            raise ValueError(
                "use_zero_bubble requires zero dropout (the hand-written "
                "backward re-traces the block; see pipeline_spmd_zb)")
        self.config = config
        self.num_stages = int(num_stages)
        self.num_micro = int(num_micro)
        self.num_chunks = int(num_chunks)
        total = self.num_stages * self.num_chunks
        if config.num_layers % total:
            raise ValueError(
                f"num_layers {config.num_layers} must divide by "
                f"num_stages*num_chunks {total}")
        self.layers_per_stage = config.num_layers // total
        self._group = _pipe_group(group)
        if self._group.nranks != self.num_stages:
            raise ValueError(f"num_stages {self.num_stages}, the pipeline "
                             f"group has {self._group.nranks} ranks")
        self.stage = max(self._group.rank, 0)
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                **factory)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **factory)
        self.drop = nn.Dropout(config.hidden_dropout_prob)
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon, **factory)
        template = GPTBlock(config, device="meta", dtype=dtype)
        template.use_recompute = False      # the ring recomputes
        object.__setattr__(self, "_template", template)
        self._stacked_names = []
        lead = ((1, self.layers_per_stage) if self.num_chunks == 1 else
                (1, self.num_chunks, self.layers_per_stage))
        for pname, p in template.named_parameters():
            flat = "blocks__" + pname.replace(".", "__")
            self.register_parameter(flat, nn.Parameter(torch.empty(
                lead + tuple(p.shape), **factory)))
            self._stacked_names.append((flat, pname))
        self._init_weights(dev, seed)

    @torch.no_grad()
    def _init_weights(self, dev, seed):
        """The parameters outside the ring (replicated, as the
        reference's are) from ``seed`` alike on every stage, the stage's
        block slices from ``seed + 1 + stage``."""
        outer = torch.Generator(device=dev).manual_seed(seed)
        inner_gen = torch.Generator(device=dev).manual_seed(
            seed + 1 + self.stage)
        std = self.config.initializer_range
        resid = 1.0 / math.sqrt(2.0 * self.config.num_layers)
        lead = 2 if self.num_chunks == 1 else 3
        for name, p in self.named_parameters():
            stacked = name.startswith("blocks__")
            inner = p.ndim - (lead if stacked else 0)
            if inner >= 2:
                p.normal_(0.0, std, generator=inner_gen if stacked
                          else outer)
                if re.search(r"(out_proj|fc2)__weight$", name):
                    p.mul_(resid)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def stacked(self):
        """The rank's stage slices, one a block parameter (template
        order)."""
        return [getattr(self, flat) for flat, _ in self._stacked_names]

    def _block_fn(self):
        template, names = self._template, self._stacked_names
        template.train(self.training)

        def block_fn(leaves, x):
            for i in range(self.layers_per_stage):
                x = functional_call(
                    template, {pname: t[i] for (_, pname), t in
                               zip(names, leaves)}, (x, None))
            return x

        return block_fn

    def forward(self, input_ids, position_ids=None):
        """Logits ``[b, s, vocab]`` (the head tied to ``wte``)."""
        _refuse_sep()
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids.long())
                      + self.wpe(position_ids.long()))
        stage = [t[0] for t in self.stacked()]
        xs = microbatch(x, self.num_micro)
        if self.use_zero_bubble:
            out = pipeline_spmd_zb(self._block_fn(), stage, xs,
                                   group=self._group)
        else:
            out = pipeline_spmd(self._block_fn(), stage, xs,
                                group=self._group,
                                num_chunks=self.num_chunks)
        hidden = self.ln_f(unmicrobatch(out))
        return hidden @ self.wte.weight.t()


def gpt_pipe_sharding_rules(tp_axis="mp", fsdp_axis=None, num_chunks=1):
    """Reference :178: the Megatron TP / ZeRO-3 specs of the stacked
    block parameters (their leading dims (pp, (chunks,) layers): pp-
    sharded, the rest replicated) and of the embeddings outside the
    ring, as ``(name regex, spec)`` pairs."""
    lead = ("pp", None) if num_chunks == 1 else ("pp", None, None)

    def spec(*axes):
        return lead + tuple(axes)

    return [
        (r"blocks__attn__qkv__weight$", spec(fsdp_axis, tp_axis)),
        (r"blocks__attn__qkv__bias$", spec(tp_axis)),
        (r"blocks__attn__out_proj__weight$", spec(tp_axis, fsdp_axis)),
        (r"blocks__mlp__fc1__weight$", spec(fsdp_axis, tp_axis)),
        (r"blocks__mlp__fc1__bias$", spec(tp_axis)),
        (r"blocks__mlp__fc2__weight$", spec(tp_axis, fsdp_axis)),
        (r"blocks__", lead),
        (r"\bwte\.weight$", (tp_axis, fsdp_axis)),
        (r"\bwpe\.weight$", (None, fsdp_axis)),
    ]
