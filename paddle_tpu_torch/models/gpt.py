"""GPT: the model of paddle_tpu/models/gpt.py in PyTorch, for training
and serving.

Parameter names are those of the reference's ``named_parameters()``
(``gpt.wte.weight``, ``gpt.blocks.0.attn.qkv.weight``, ...,
``gpt.ln_f.bias``, ``lm_head.weight`` when the head is untied), so
`convert.state_dict_from_jax` carries a reference checkpoint across by
name. The Linear layers are ``torch.nn.Linear`` (weight ``[out, in]``;
the reference's is ``[in, out]``, and the converter transposes).

Training: ``forward`` / ``loss`` run full-sequence causal attention
through `nn.functional.scaled_dot_product_attention` (the splash kernel,
with packed-sequence ``segment_ids``; with ``FLAGS_splash_attn`` off, the
flash kernels), ``use_recompute`` checkpoints each block (its attention
forward runs again in the backward; with ``recompute_policy="dots"`` only
what lies between the Linear products, which are kept), and ``loss``
feeds the final
hiddens to the fused LM-head cross entropy (`fused_lm_loss`), so the
``[tokens, vocab]`` logits never exist. Serving runs over a `PagedKVCache` with fp, int8 or int4 pools:
``decode_step`` (one token per slot, the paged decode kernels) and
``prefill_chunk`` (one bounded window per slot, the paged chunk
kernels; over a `DenseKVCache`, the reference's XLA attention in plain
PyTorch: the speculative verify). Generation (``generate``, over
`jit.GenerationEngine`) adds ``prefill``, a causal pass over the whole
prompt through the splash kernel that fills a paged or a
`DenseKVCache`, whose decode runs
`incubate.nn.functional.masked_multihead_attention`.

``num_draft_heads=k`` adds the reference's self-speculative draft heads
(``draft_heads``, zero-initialised ``hidden x hidden`` Linears): head j
proposes the token j+2 positions ahead through ``h + silu(W_j h)`` and
the shared LM head (`GPTForCausalLM.draft_logits`), and ``loss`` adds
their auxiliary cross entropy (`draft_head_loss`, weighted by
``draft_head_loss_weight``) through the fused CE.

``scan_layers=True`` stores the decoder stack as one ``[num_layers,
...]`` parameter per block parameter (`GPTStackedBlocks`, the
reference's names), which `jit.FusedScanTrainStep` trains one layer
chunk at a time; such a model trains and evaluates, and refuses the
cached serving paths, as the reference does.

Sequence parallelism (the sep axis). Under a fleet whose sep degree is
above 1 (`distributed.fleet.meta_parallel.SegmentParallel`) a rank's
input is its block of the sequence: the default position ids are the
block's global positions, attention runs over the sep group
(`ring_attention` with ``use_ring_attention``, else the rank's queries
over the gathered K/V, `sep_gathered_attention`), and ``loss`` sums the
tokens' losses and counts over the group, so every rank holds the
global mean. ``use_ring_attention`` at a world of one (or a sep degree
of 1) runs the dense path, as the reference's does. Stricter than the
reference, which falls back to dense attention there: attention
dropout, segment ids, a ``scan_layers`` stack and draft heads under a
sep degree above 1 raise, naming ROADMAP A9b.5b.

``num_experts=E`` makes every block's MLP an `MoEBlock` (the
reference's mixture of experts on one rank: `incubate.distributed.
models.moe.MoELayer` over E `ExpertFFN`s of the MLP's geometry, the
``moe_gate`` rule, ``moe_capacity_factor``), under the reference's names
(``gpt.blocks.{i}.mlp.moe.gate_weight``, ``...experts__fc1__weight``
``[E, in, out]``, ...; stacked ``[L, E, ...]`` under ``blocks__mlp__moe__``
in a scan model). Such a block returns ``(x, aux)``, its load-balance
aux loss beside its output, so the aux reaches the loss's graph through
a recomputed block too; ``loss`` adds ``moe_aux_weight`` times the
layers' mean (`GPTModel.moe_aux`), and `jit.FusedScanTrainStep` the
same. Generation runs the blocks' MoE as the reference's does, the
capacity from each call's own token count. The ep axis, and an MoE
model under a sep degree above 1 or the distributed steps, are ROADMAP
A9b.3b and raise.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..distributed.fleet.layers.mpu.mp_ops import mp_allreduce
from ..distributed.fleet.meta_parallel.ring_attention import (
    ring_attention, sep_gathered_attention, sep_group)
from ..distributed.fleet.recompute import POLICIES, recompute
from ..framework.device import resolve_device
from ..incubate.distributed.models.moe.moe_layer import (A9B3B, ExpertFFN,
                                                         MoELayer)
from ..incubate.nn import functional as IF
from ..inference.kv_cache import (decode_plan, dense_write_chunk,
                                  dense_write_prefill,
                                  layer_scales, prefill_plan,
                                  prefill_write_index, slot_rows,
                                  write_layer)
from ..nn import functional as PF
from ..ops.kernels.paged_attention import (paged_attention,
                                           paged_attention_chunk)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTModel", "GPTPretrainingCriterion", "GPTStackedBlocks",
           "draft_head_loss", "fused_lm_loss", "match_sharding",
           "token_mean"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0          # 0 -> 4 * hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    recompute_policy: str = None        # None / "full" / "nothing", "dots"
    scan_layers: bool = False
    # self-speculative draft heads: head j predicts the token j+2
    # positions ahead; their auxiliary CE is weighted into `loss`
    num_draft_heads: int = 0
    draft_head_loss_weight: float = 0.1
    # attention over the sep group's ring (module docstring)
    use_ring_attention: bool = False
    # mixture-of-experts FFN (module docstring): the aux loss weighs
    # moe_aux_weight in `loss`
    num_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_gate: str = "gshard"            # "gshard" (top-2), "switch" (top-1)
    moe_aux_weight: float = 1e-2

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        if self.recompute_policy not in POLICIES:
            raise ValueError(
                f"unknown recompute policy {self.recompute_policy!r}; use "
                f"'dots' or 'nothing'/'full'")


# sizes follow the GPT-3 paper table
GPT_CONFIGS = {
    "gpt3-125m": dict(hidden_size=768, num_layers=12, num_attention_heads=12),
    "gpt3-350m": dict(hidden_size=1024, num_layers=24, num_attention_heads=16),
    "gpt3-1.3b": dict(hidden_size=2048, num_layers=24, num_attention_heads=32),
    "gpt3-2.7b": dict(hidden_size=2560, num_layers=32, num_attention_heads=32),
    "gpt3-6.7b": dict(hidden_size=4096, num_layers=32, num_attention_heads=32),
    "gpt3-13b": dict(hidden_size=5120, num_layers=40, num_attention_heads=40),
}


def gpt_config(name: str, **overrides) -> GPTConfig:
    kw = dict(GPT_CONFIGS[name])
    kw.update(overrides)
    return GPTConfig(**kw)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that, like the reference's, normalises in the
    dtype of its weight and returns the input's dtype: after
    ``amp.decorate(level="O2")`` the weights stay fp32 while activations
    are bf16, a mix torch would not cast by itself."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = nn.Linear(h, 3 * h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)
        self.dropout_p = config.attention_dropout_prob
        self.use_ring = config.use_ring_attention

    def forward(self, x, segment_ids=None):
        """Causal self-attention over [b, s, h]; ``segment_ids`` [b, s]
        keeps packed documents apart. q/k/v go to the kernel as strided
        views of the qkv product, without a copy. Under a sep degree
        above 1, ``x`` is the rank's block of the sequence (module
        docstring)."""
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        sep = sep_group()
        if sep is None:
            out = PF.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout_p,
                training=self.training, segment_ids=segment_ids)
        else:
            _refuse_under_sep(self.dropout_p > 0 and self.training,
                              segment_ids is not None)
            attend = ring_attention if self.use_ring \
                else sep_gathered_attention
            out = attend(q, k, v, sep, causal=True)
        # the heads' width (under tensor parallelism a rank's nh/mp heads)
        return self.out_proj(out.reshape(b, s, -1))

    def forward_prefill(self, x, cache, layer_idx, plan):
        """Prompt pass: causal self-attention over the whole (right-padded)
        prompt, then this layer's K/V into the cache: positions [0, s) of
        the dense cache, or the paged pools at ``plan`` (the call's flat
        write index; padding goes to the trash page), quantized there
        when the pools are int8/int4."""
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = PF.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=False)
        if cache.kind == "dense":
            dense_write_prefill(cache.layer(layer_idx), k, v)
        else:
            nh, hd = self.num_heads, self.head_dim
            write_layer(cache, layer_idx, plan,
                        k.movedim(2, 0).reshape(nh, b * s, hd),
                        v.movedim(2, 0).reshape(nh, b * s, hd))
        return self.out_proj(out.reshape(b, s, h))

    def forward_decode(self, x, cache, layer_idx, plan):
        """One token per slot. Dense cache: `masked_multihead_attention`
        appends it at the shared position (``cache.pos``, a device int32
        scalar, read on the device) and attends the cache. Paged:
        write it into this layer's pools (inactive slots to the trash
        page; quantized with its scale in int8/int4 pools), then ragged
        paged attention. ``plan`` is the step's `decode_plan` (None for
        the dense cache)."""
        b, _, h = x.shape
        if cache.kind == "dense":
            out, _ = IF.masked_multihead_attention(
                self.qkv(x).reshape(b, 3 * h), cache.layer(layer_idx),
                sequence_lengths=cache.pos)
            return self.out_proj(out.reshape(b, 1, h))
        qkv = self.qkv(x).reshape(b, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]          # [b, nh, hd]
        write, lens = plan
        write_layer(cache, layer_idx, write, k.movedim(1, 0),
                    v.movedim(1, 0))
        ks, vs = layer_scales(cache, layer_idx)
        out = paged_attention(q.contiguous(), cache.k_layers[layer_idx],
                              cache.v_layers[layer_idx], cache.page_tables,
                              lens, k_scales=ks, v_scales=vs)
        return self.out_proj(out.reshape(b, 1, h))

    def forward_prefill_chunk(self, x, cache, layer_idx, start, plan):
        """One window per slot: write its K/V at positions [start,
        start+c) (past the slot's new length: trash page; dense: dropped),
        then attend the window's queries over the slot's cached context,
        causal within the window. ``plan`` is the call's `prefill_plan`
        (paged), or the rows' new lengths (dense): there the attention is
        the reference's XLA one, fp32 scores over the whole cache with
        key j visible to query i when ``j <= start + i``, in plain
        PyTorch."""
        b, c, h = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(b, c, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache.kind == "dense":
            cache_l = cache.layer(layer_idx)
            dense_write_chunk(cache_l, start, plan, k, v)
            s = torch.einsum("bcnd,bnld->bncl", q.float(),
                             cache_l[0].float()) / (hd ** 0.5)
            jpos = torch.arange(cache_l.shape[3], device=x.device)
            ipos = start.long()[:, None] + torch.arange(c, device=x.device)
            visible = jpos[None, None, :] <= ipos[:, :, None]
            s = s.masked_fill(~visible[:, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bncl,bnld->bncd", p, cache_l[1].float())
            return self.out_proj(out.movedim(1, 2).to(q.dtype)
                                 .reshape(b, c, h))
        write, rows = plan
        write_layer(cache, layer_idx, write,
                    k.movedim(2, 0).reshape(nh, b * c, hd),
                    v.movedim(2, 0).reshape(nh, b * c, hd))
        ks, vs = layer_scales(cache, layer_idx)
        out = paged_attention_chunk(
            q.contiguous(), cache.k_layers[layer_idx],
            cache.v_layers[layer_idx], rows, start, k_scales=ks,
            v_scales=vs)
        return self.out_proj(out.reshape(b, c, h))


def _refuse_under_sep(dropout, segments):
    """Attention dropout and segment ids under a sep degree above 1: the
    reference falls back to dense attention over the whole sequence,
    which no rank holds here."""
    for what, on in (("attention dropout", dropout),
                     ("segment ids", segments)):
        if on:
            raise NotImplementedError(
                f"{what} under a sep degree above 1 is not ported yet: "
                f"ROADMAP A9b.5b")


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **factory)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **factory)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class MoEBlock(nn.Module):
    """The MoE variant of `GPTMLP` (reference gpt.py:394): an `MoELayer`
    over ``num_experts`` `ExpertFFN`s of the MLP's geometry. ``forward``
    gives the output and leaves the layer's aux loss in ``l_aux``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.moe = MoELayer(
            h, [ExpertFFN(h, config.intermediate_size, device=device,
                          dtype=dtype) for _ in range(config.num_experts)],
            gate=config.moe_gate,
            capacity_factor=config.moe_capacity_factor)

    @property
    def l_aux(self):
        return self.moe.l_aux

    def forward(self, x):
        return self.moe(x)


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block. With experts (an `MoEBlock` for
    ``mlp``) ``forward`` returns ``(x, aux)``."""

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps=eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln_2 = LayerNorm(config.hidden_size, eps=eps, **factory)
        self.moe = config.num_experts > 0
        self.mlp = (MoEBlock(config, **factory) if self.moe
                    else GPTMLP(config, **factory))
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.use_recompute = config.use_recompute
        self.recompute_policy = config.recompute_policy

    def _inner(self, x, segment_ids):
        x = x + self.dropout(self.attn(self.ln_1(x), segment_ids))
        if not self.moe:
            return x + self.dropout(self.mlp(self.ln_2(x)))
        y, aux = self.mlp.moe.forward_aux(self.ln_2(x))
        return x + self.dropout(y), aux

    def forward(self, x, segment_ids=None):
        if self.use_recompute and self.training:
            # keep the block's input (and with "dots" its Linear
            # products); the backward replays the rest of the forward
            # (and its attention kernel) first
            return recompute(self._inner, x, segment_ids,
                             policy=self.recompute_policy)
        return self._inner(x, segment_ids)

    def forward_prefill(self, x, cache, layer_idx, plan):
        x = x + self.attn.forward_prefill(self.ln_1(x), cache, layer_idx,
                                          plan)
        return x + self.mlp(self.ln_2(x))

    def forward_decode(self, x, cache, layer_idx, plan):
        x = x + self.attn.forward_decode(self.ln_1(x), cache, layer_idx,
                                         plan)
        return x + self.mlp(self.ln_2(x))

    def forward_prefill_chunk(self, x, cache, layer_idx, start, plan):
        x = x + self.attn.forward_prefill_chunk(self.ln_1(x), cache,
                                                layer_idx, start, plan)
        return x + self.mlp(self.ln_2(x))


class GPTStackedBlocks(nn.Module):
    """The decoder stack as one ``[num_layers, ...]`` parameter per
    parameter of a `GPTBlock`, under the reference's flat names
    (``blocks__`` + the block's name with ``.`` -> ``__``; a Linear
    weight is ``[num_layers, out, in]``).

    The template block holds no memory: it lives on the ``meta`` device
    and is not a registered submodule, as in the reference. Layer ``i``
    runs it through `torch.func.functional_call` over the stacked
    parameters' slices ``[i]``; with ``use_recompute`` each layer is one
    checkpoint (`recompute`, under the config's policy)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        template = GPTBlock(config, device="meta", dtype=dtype)
        template.use_recompute = False     # the stack checkpoints a layer
        object.__setattr__(self, "_template", template)
        self._stacked_names = []           # (flat name, template name)
        for pname, p in template.named_parameters():
            flat = "blocks__" + pname.replace(".", "__")
            self.register_parameter(flat, nn.Parameter(torch.empty(
                (config.num_layers,) + tuple(p.shape), device=device,
                dtype=dtype)))
            self._stacked_names.append((flat, pname))

    def stacked(self):
        """The stacked parameters, in the template's order."""
        return [getattr(self, flat) for flat, _ in self._stacked_names]

    def layer(self, x, segment_ids, *leaves):
        """One layer over ``leaves`` (one tensor per stacked parameter,
        in the template's order), in the template's current mode; with
        experts ``(x, aux)``."""
        return functional_call(
            self._template,
            {pname: t for (_, pname), t in zip(self._stacked_names, leaves)},
            (x, segment_ids))

    def forward(self, x, segment_ids=None):
        """The stack's output; with experts ``(x, [aux of each
        layer])``."""
        cfg = self.config
        self._template.train(self.training)
        stacked = self.stacked()
        auxs = []
        for i in range(cfg.num_layers):
            leaves = [s[i] for s in stacked]
            if cfg.use_recompute and self.training:
                x = recompute(self.layer, x, segment_ids, *leaves,
                              policy=cfg.recompute_policy)
            else:
                x = self.layer(x, segment_ids, *leaves)
            if self._template.moe:
                x, aux = x
                auxs.append(aux)
        return (x, auxs) if self._template.moe else x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                **factory)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **factory)
        self.drop = nn.Dropout(config.hidden_dropout_prob)
        if config.scan_layers:
            self.blocks = GPTStackedBlocks(config, **factory)
        else:
            self.blocks = nn.ModuleList([GPTBlock(config, **factory)
                                         for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon, **factory)
        self.last_moe_aux = None

    def _embed(self, input_ids, position_ids):
        # a padded chunk tail or a decode slot saturated at the engine
        # window can point past the position table: clamp (those outputs
        # are discarded; the reference reads a NaN fill there instead)
        pos = position_ids.long().clamp(
            0, self.config.max_position_embeddings - 1)
        return self.wte(input_ids.long()) + self.wpe(pos)

    def forward(self, input_ids, position_ids=None, segment_ids=None):
        """Final hiddens [b, s, h]. ``segment_ids`` ([b, s] int) marks
        packed-sequence documents: tokens attend only within their own.
        Positions default to ``arange(s)`` whatever the segments, as in
        the reference; under a sep degree above 1 to the rank's block's
        global positions ``r * s + arange(s)``."""
        b, s = input_ids.shape
        sep = sep_group()
        if sep is not None and self.config.scan_layers:
            raise NotImplementedError(
                "a scan_layers GPT under a sep degree above 1 is not ported "
                "yet: ROADMAP A9b.5b")
        if sep is not None and self.config.num_experts:
            raise NotImplementedError(A9B3B.format(
                "an MoE GPT under a sep degree above 1"))
        if position_ids is None:
            start = 0 if sep is None else sep.rank * s
            position_ids = torch.arange(start, start + s,
                                        device=input_ids.device)[None]
        x = self.drop(self._embed(input_ids, position_ids))
        moe = self.config.num_experts > 0
        auxs = []
        if self.config.scan_layers:
            x = self.blocks(x, segment_ids)
            if moe:
                x, auxs = x
        else:
            for block in self.blocks:
                x = block(x, segment_ids)
                if moe:
                    x, aux = x
                    auxs.append(aux)
        self.last_moe_aux = sum(auxs[1:], auxs[0]) / len(auxs) if moe \
            else None
        return self.ln_f(x)

    def moe_aux(self):
        """The layers' mean MoE load-balance aux loss of the last
        ``forward`` (None for a dense model): what `GPTForCausalLM.loss`
        weighs by ``moe_aux_weight``."""
        return self.last_moe_aux

    def _check_decodable(self):
        if self.config.scan_layers:
            raise NotImplementedError(
                "generate()/decode over scan_layers=True models is not "
                "plumbed (the stacked stack has no per-layer cache slot), "
                "as in the reference; build the model with "
                "scan_layers=False for serving")

    def prefill(self, input_ids, cache, seq_lens=None, slot_ids=None):
        """Prompt pass writing every layer's K/V into ``cache``.

        input_ids: [b, s] (right-padded to the engine's length bucket);
        seq_lens / slot_ids: [b] int32 true prompt lengths and slots, for
        the paged cache (the dense cache ignores both: its batch is
        aligned). Returns the [b, s, hidden] hiddens; the caller gathers
        the last valid position and owns the cache's lengths."""
        self._check_decodable()
        b, s = input_ids.shape
        x = self._embed(input_ids,
                        torch.arange(s, device=input_ids.device)[None])
        plan = None
        if cache.kind == "paged":
            # one flat write index for every layer; padding to trash
            plan = prefill_write_index(
                slot_rows(cache.page_tables, slot_ids), None, seq_lens, s,
                cache.page_size)
        for l, block in enumerate(self.blocks):
            x = block.forward_prefill(x, cache, l, plan)
        return self.ln_f(x)

    def decode_step(self, tokens, cache, position_ids):
        """One cached decode step: tokens [b, 1] -> hiddens [b, 1, h].
        The caller owns advancing cache.seq_lens (cache.pos)."""
        self._check_decodable()
        x = self._embed(tokens, position_ids)
        plan = decode_plan(cache) if cache.kind == "paged" else None
        for l, block in enumerate(self.blocks):
            x = block.forward_decode(x, cache, l, plan)
        return self.ln_f(x)

    def prefill_chunk(self, input_ids, cache, slot_ids, start,
                      seq_lens_new):
        """One window of each slot's tokens at positions [start,
        start+c), attending over the context cached so far: the serving
        tier's chunked prompt prefill and the speculative verify (c =
        k+1), over paged and dense caches (the dense cache ignores
        ``slot_ids``: row i is its row i).

        input_ids: [b, c] window tokens right-padded to the bucket;
        slot_ids/start/seq_lens_new: [b] int32. Returns the window
        hiddens [b, c, hidden]. The caller owns advancing
        cache.seq_lens (cache.pos) to seq_lens_new."""
        self._check_decodable()
        c = input_ids.shape[1]
        pos = start.long()[:, None] + torch.arange(
            c, device=input_ids.device)[None]
        x = self._embed(input_ids, pos)
        plan = (seq_lens_new if cache.kind == "dense" else
                prefill_plan(cache, slot_ids, start, seq_lens_new, c))
        for l, block in enumerate(self.blocks):
            x = block.forward_prefill_chunk(x, cache, l, start, plan)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT + LM head (tied to ``wte`` unless ``tie_word_embeddings`` is
    off); ``forward`` returns logits, `loss` the training loss.

    The weights are drawn on ``device`` from ``torch.Generator`` seeded
    with ``seed``, as the reference initialises them: normal(0,
    ``initializer_range``) for matrices, the residual projections
    (out_proj, fc2, the experts' fc2 stacks) scaled by 1/sqrt(2 *
    num_layers), zero biases (an expert stack's too) and
    unit LayerNorm scales (a stacked parameter of a scan model by the
    rank of its layer's slice)."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self.lm_head = None if config.tie_word_embeddings else nn.Linear(
            config.hidden_size, config.vocab_size, bias=False, device=dev,
            dtype=dtype)
        # one residual block a head, logits through the shared LM head;
        # zero-initialised, so an untrained head is the base head
        self.draft_heads = nn.ModuleList([
            nn.Linear(config.hidden_size, config.hidden_size, device=dev,
                      dtype=dtype)
            for _ in range(config.num_draft_heads)]) \
            if config.num_draft_heads else None
        self._init_weights(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen):
        std = self.config.initializer_range
        resid = 1.0 / math.sqrt(2.0 * self.config.num_layers)
        for name, p in self.named_parameters():
            if name.startswith("draft_heads.") or name.endswith("bias"):
                # an expert bias stack [E, out] stays zero too
                p.zero_()
            elif p.ndim - ("blocks__" in name) >= 2:
                p.normal_(0.0, std, generator=gen)
                # the residual projections, the experts' fc2 stacks too
                if name.endswith(("out_proj.weight", "fc2.weight",
                                  "out_proj__weight", "fc2__weight")):
                    p.mul_(resid)
            else:
                p.fill_(1.0)

    def forward(self, input_ids, position_ids=None, segment_ids=None):
        return self.head(self.gpt(input_ids, position_ids,
                                  segment_ids=segment_ids))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=20, seq_lens=None,
                 use_cache="dense", do_sample=False, top_k=0, top_p=1.0,
                 temperature=1.0, seed=None, eos_token_id=None,
                 compiled=True, return_logits=False, **engine_kwargs):
        """Autoregressive generation: one causal prefill of the padded
        prompt (the splash kernel) writes the cache, then one-token
        decode steps.

        use_cache: "dense" (aligned batch) or "paged" (ragged ``seq_lens``
        for right-padded ``input_ids``; ``kv_quant="int8"|"int4"`` among
        ``engine_kwargs`` quantizes its pools). do_sample draws with
        temperature / top-k / top-p from a generator seeded with
        ``seed``; otherwise greedy. Returns an int32 CPU tensor [batch,
        max_new_tokens] (and the logits with ``return_logits``).

        Engines are kept on the model per (cache kind, batch, capacity,
        sampling, parameter layout, engine options) signature, the four
        most recent, so repeated calls reuse one cache."""
        from ..jit.decode_step import GenerationEngine

        ids = (input_ids.cpu().numpy() if isinstance(input_ids, torch.Tensor)
               else np.asarray(input_ids))
        b, s = ids.shape
        # capacity rounded up to a shared granularity, so nearby (prompt,
        # max_new) shapes share one engine; capped at the position table
        need = s + int(max_new_tokens)
        cap = self.config.max_position_embeddings
        if need > cap:
            raise ValueError(
                f"prompt {s} + {max_new_tokens} new tokens exceeds "
                f"max_position_embeddings={cap}")
        max_len = min(cap, -(-need // 64) * 64)
        # the parameter layout keeps a stale engine from surviving a
        # change of dtype, shape or device (or a `quantize_for_decode`
        # swap, which renames the Linears' parameters)
        struct = hash(tuple((n, str(p.dtype), tuple(p.shape), str(p.device))
                            for n, p in self.named_parameters()))
        key = (use_cache, b, max_len, bool(do_sample), int(top_k),
               float(top_p), float(temperature), bool(compiled), struct,
               tuple(sorted(engine_kwargs.items())))
        engines = self.__dict__.setdefault("_generation_engines", {})
        engine = engines.pop(key, None)
        if engine is None:
            engine = GenerationEngine(
                self, kind=use_cache, batch=b, max_len=max_len,
                do_sample=do_sample, top_k=top_k, top_p=top_p,
                temperature=temperature, compiled=compiled,
                **engine_kwargs)
        engines[key] = engine           # most recent last
        while len(engines) > 4:
            engines.pop(next(iter(engines)))
        return engine.generate(ids, max_new_tokens, seq_lens=seq_lens,
                               eos_token_id=eos_token_id, seed=seed,
                               return_logits=return_logits)

    def head(self, hidden):
        """LM head: hiddens [..., hidden] -> logits [..., vocab]: the
        ``wte`` product when tied, else ``lm_head`` itself (a
        `nn.quant.WeightOnlyLinear` after `quantize_for_decode`)."""
        if self.lm_head is None:
            return F.linear(hidden, self.gpt.wte.weight)
        return self.lm_head(hidden)

    def draft_hidden(self, hidden, j, head=None):
        """Draft head j's residual block over hiddens [..., hidden]:
        ``h + silu(W_j h)`` (``head``: a callable in place of the head's
        Linear). `head` of the result gives the head's logits."""
        head = self.draft_heads[j] if head is None else head
        return hidden + F.silu(head(hidden))

    def draft_logits(self, hidden):
        """All k draft heads' logits off one final hidden state, through
        one shared LM-head product: [..., hidden] -> [..., k, vocab]
        (head j predicts the token j+2 positions ahead)."""
        return self.head(torch.stack(
            [self.draft_hidden(hidden, j)
             for j in range(len(self.draft_heads))], dim=-2))

    def head_weight(self):
        """The LM head's ``[vocab, hidden]`` weight: ``wte`` when tied."""
        return self.gpt.wte.weight if self.lm_head is None \
            else self.lm_head.weight

    def loss(self, input_ids, labels, loss_mask=None, position_ids=None,
             segment_ids=None):
        """Training loss through the fused LM head: the final hiddens go
        straight into the vocab-tiled cross entropy, so the [tokens,
        vocab] logits never exist. Numerically
        ``GPTPretrainingCriterion()(self(ids), labels, loss_mask)``."""
        if self.draft_heads is not None and sep_group() is not None:
            raise NotImplementedError(
                "draft heads under a sep degree above 1 are not ported "
                "yet: ROADMAP A9b.5b")
        hidden = self.gpt(input_ids, position_ids, segment_ids=segment_ids)
        # both heads are [vocab, hidden] here (the reference's untied head
        # is an [hidden, vocab] Paddle Linear with transpose_y=False)
        w = self.head_weight()
        loss = fused_lm_loss(hidden, w, True, labels, loss_mask)
        aux = self.gpt.moe_aux()
        if aux is not None:
            loss = loss + self.config.moe_aux_weight * aux
        if self.draft_heads is not None:
            loss = loss + self.config.draft_head_loss_weight \
                * draft_head_loss(self, hidden, w, True, labels, loss_mask)
        return loss


def draft_head_loss(model, hidden, weight, transpose_y, labels,
                    loss_mask=None, heads=None):
    """Auxiliary cross entropy of the self-speculative draft heads: head j
    at position i predicts ``labels[i + j + 1]`` (the base head predicts
    ``labels[i]``), through the same fused LM-head loss; the mean over
    heads. ``hidden``: the final (``ln_f``) hiddens; ``heads``: callables
    in place of the heads' Linears (the fused-scan step's cast
    parameters)."""
    k = len(model.draft_heads)
    total = None
    for j in range(k):
        hj = model.draft_hidden(hidden[:, :-(j + 1)], j,
                                None if heads is None else heads[j])
        mj = None if loss_mask is None else loss_mask[:, j + 1:]
        lj = fused_lm_loss(hj, weight, transpose_y, labels[:, j + 1:], mj)
        total = lj if total is None else total + lj
    return total / k


def fused_lm_loss(hidden, weight, transpose_y, labels, loss_mask=None):
    """Fused LM-head loss: fused cross entropy, then the criterion's
    masked-mean reduction (mean over non-ignored labels without a mask;
    ``sum(loss * mask) / max(sum(mask), 1)`` with one). Under a sep
    degree above 1 the rank's rows are its block of the sequence: the
    sum and the count are summed over the sep group (forward; the
    backward of the sum is the identity, each rank's grad its block's
    part), so every rank's loss is the mean over the whole sequence."""
    sep = sep_group()
    if sep is not None:
        losses = PF.fused_linear_cross_entropy(hidden, weight, labels,
                                               transpose_y=transpose_y,
                                               reduction="none")
        m = (labels != -100) if loss_mask is None else loss_mask
        return token_mean(losses, m.to(losses.dtype), sep)
    if loss_mask is None:
        return PF.fused_linear_cross_entropy(hidden, weight, labels,
                                             transpose_y=transpose_y)
    losses = PF.fused_linear_cross_entropy(hidden, weight, labels,
                                           transpose_y=transpose_y,
                                           reduction="none")
    m = loss_mask.to(losses.dtype)
    return (losses * m).sum() / m.sum().clamp(min=1.0)


def token_mean(losses, m, sep=None):
    """``sum(losses * m) / max(sum(m), 1)``; over a ``sep`` group (the
    rank's tokens are its block of the sequence) the sum and the count
    are summed over it first (forward; the backward of the sum is the
    identity, each rank's grad its block's part), so every rank holds
    the global mean."""
    tot = torch.stack([(losses * m).sum(), m.sum()])
    if sep is not None:
        tot = mp_allreduce(tot, sep)
    return tot[0] / tot[1].clamp(min=1.0)


class GPTPretrainingCriterion(nn.Module):
    """Shifted-token cross entropy over materialised logits: mean over
    non-masked positions (and, without a mask, over labels that are not
    -100), equal to `GPTForCausalLM.loss`."""

    def forward(self, logits, labels, loss_mask=None):
        vocab = logits.shape[-1]
        flat_labels = labels.reshape(-1)
        loss = PF.cross_entropy(logits.reshape(-1, vocab), flat_labels,
                                reduction="none")
        if loss_mask is None:
            m = (flat_labels != -100).to(loss.dtype)
        else:
            m = loss_mask.reshape(-1).to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp(min=1.0)


def match_sharding(name, rules):
    """The spec of the first of ``rules`` (``(pattern, spec)`` pairs, as
    `models.llama_sharding_rules` gives them) whose pattern is found in
    the parameter name ``name``; ``()`` when none is (the port's copy of
    paddle_tpu/models/gpt.py:980)."""
    for pat, spec in rules:
        if re.search(pat, name):
            return spec
    return ()
