"""GPT for serving: the model of paddle_tpu/models/gpt.py in PyTorch.

Parameter names are those of the reference's ``named_parameters()``
(``gpt.wte.weight``, ``gpt.blocks.0.attn.qkv.weight``, ...,
``gpt.ln_f.bias``), so `convert.state_dict_from_jax` carries a reference
checkpoint across by name. The Linear layers are ``torch.nn.Linear``
(weight ``[out, in]``; the reference's is ``[in, out]``, and the
converter transposes).

The serving paths run over a `PagedKVCache`: ``decode_step`` (one token
per slot, the paged decode kernel) and ``prefill_chunk`` (one bounded
window per slot, the paged chunk kernel). ``forward`` is the plain
causal forward for CPU tensors, the parity reference; on the card the
full-sequence attention belongs to the flash/splash kernels, which are
not ported yet, so it raises there.

Not here yet (the training slice): MoE, scan_layers, ring attention,
recompute, draft heads, segment ids and the loss.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.device import resolve_device
from ..inference.kv_cache import decode_plan, prefill_plan, write_rows
from ..ops.kernels.paged_attention import (paged_attention,
                                           paged_attention_chunk)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTModel"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0          # 0 -> 4 * hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size


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


def _causal_attention(q, k, v):
    """Plain causal softmax attention over [b, s, nh, hd] in fp32."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                       v.float())
    return out.to(q.dtype)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = nn.Linear(h, 3 * h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)

    def forward(self, x):
        if x.device.type != "cpu":
            raise NotImplementedError(
                "full-sequence attention on the card needs the flash/"
                "splash kernels, which are not ported yet")
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        out = _causal_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.out_proj(out.reshape(b, s, h))

    def forward_decode(self, x, cache, layer_idx, plan):
        """One token per slot: write it into this layer's pools (inactive
        slots to the trash page), then ragged paged attention. ``plan``
        is the step's `decode_plan`."""
        b, _, h = x.shape
        qkv = self.qkv(x).reshape(b, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]          # [b, nh, hd]
        write, lens = plan
        kp, vp = cache.k_layers[layer_idx], cache.v_layers[layer_idx]
        write_rows(kp, write, k.movedim(1, 0))
        write_rows(vp, write, v.movedim(1, 0))
        out = paged_attention(q.contiguous(), kp, vp, cache.page_tables,
                              lens)
        return self.out_proj(out.reshape(b, 1, h))

    def forward_prefill_chunk(self, x, cache, layer_idx, start, plan):
        """One window per slot: write its K/V at positions [start,
        start+c) (past the slot's new length: trash page), then attend
        the window's queries over the slot's cached context, causal
        within the window. ``plan`` is the call's `prefill_plan`."""
        b, c, h = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(b, c, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        write, rows = plan
        kp, vp = cache.k_layers[layer_idx], cache.v_layers[layer_idx]
        write_rows(kp, write, k.movedim(2, 0).reshape(nh, b * c, hd))
        write_rows(vp, write, v.movedim(2, 0).reshape(nh, b * c, hd))
        out = paged_attention_chunk(q.contiguous(), kp, vp, rows, start)
        return self.out_proj(out.reshape(b, c, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **factory)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **factory)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(config.hidden_size, eps=eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln_2 = nn.LayerNorm(config.hidden_size, eps=eps, **factory)
        self.mlp = GPTMLP(config, **factory)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward_decode(self, x, cache, layer_idx, plan):
        x = x + self.attn.forward_decode(self.ln_1(x), cache, layer_idx,
                                         plan)
        return x + self.mlp(self.ln_2(x))

    def forward_prefill_chunk(self, x, cache, layer_idx, start, plan):
        x = x + self.attn.forward_prefill_chunk(self.ln_1(x), cache,
                                                layer_idx, start, plan)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                **factory)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **factory)
        self.blocks = nn.ModuleList([GPTBlock(config, **factory)
                                     for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon, **factory)

    def _embed(self, input_ids, position_ids):
        # a padded chunk tail or a decode slot saturated at the engine
        # window can point past the position table: clamp (those outputs
        # are discarded; the reference reads a NaN fill there instead)
        pos = position_ids.long().clamp(
            0, self.config.max_position_embeddings - 1)
        return self.wte(input_ids.long()) + self.wpe(pos)

    def forward(self, input_ids, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self._embed(input_ids, position_ids)
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)

    def decode_step(self, tokens, cache, position_ids):
        """One cached decode step: tokens [b, 1] -> hiddens [b, 1, h].
        The caller owns advancing cache.seq_lens."""
        x = self._embed(tokens, position_ids)
        plan = decode_plan(cache)
        for l, block in enumerate(self.blocks):
            x = block.forward_decode(x, cache, l, plan)
        return self.ln_f(x)

    def prefill_chunk(self, input_ids, cache, slot_ids, start,
                      seq_lens_new):
        """One window of each slot's tokens at positions [start,
        start+c), attending over the context cached so far.

        input_ids: [b, c] window tokens right-padded to the bucket;
        slot_ids/start/seq_lens_new: [b] int32. Returns the window
        hiddens [b, c, hidden]. The caller owns advancing
        cache.seq_lens to seq_lens_new."""
        c = input_ids.shape[1]
        pos = start.long()[:, None] + torch.arange(
            c, device=input_ids.device)[None]
        x = self._embed(input_ids, pos)
        plan = prefill_plan(cache, slot_ids, start, seq_lens_new, c)
        for l, block in enumerate(self.blocks):
            x = block.forward_prefill_chunk(x, cache, l, start, plan)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT + tied LM head; ``forward`` returns logits.

    The weights are drawn on ``device`` from ``torch.Generator`` seeded
    with ``seed``, as the reference initialises them: normal(0,
    ``initializer_range``) for matrices, the residual projections
    (out_proj, fc2) scaled by 1/sqrt(2 * num_layers), zero biases and
    unit LayerNorm scales."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self._init_weights(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen):
        std = self.config.initializer_range
        resid = 1.0 / math.sqrt(2.0 * self.config.num_layers)
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, std, generator=gen)
                if name.endswith(("out_proj.weight", "fc2.weight")):
                    p.mul_(resid)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def forward(self, input_ids, position_ids=None):
        return self.head(self.gpt(input_ids, position_ids))

    def head(self, hidden):
        """Tied LM head: hiddens [..., hidden] -> logits [..., vocab]."""
        return F.linear(hidden, self.gpt.wte.weight)
