"""LLaMA: the model family of paddle_tpu/models/llama.py in PyTorch, for
training.

Parameter names and creation order are the reference's
(``llama.embed_tokens.weight``, then each ``llama.layers.<i>``'s
``input_layernorm``, ``self_attn.{q,k,v,o}_proj``,
``post_attention_layernorm`` and ``mlp.{gate,up,down}_proj``, then
``llama.norm.weight`` and the untied ``lm_head.weight``), so
``named_parameters()`` is the order the reference numbers them in and
`convert` carries a checkpoint and its optimizer state across. The
Linear layers are `nn.Linear` (``torch.nn.Linear``: weight ``[out,
in]``, the transpose of the reference's, which `convert` swaps).

The numerics are the reference's:

* RMSNorm (`nn.functional.rms_norm`): statistics in fp32, the weight
  upcast, the output in the input's dtype. `amp.decorate` casts its
  weight with the rest, as the reference's does.
* RoPE, rotate-half: fp32 tables; q and k upcast to fp32 for the
  rotation and cast back.
* Attention is dense, as in the reference (an XLA einsum there, not a
  Pallas kernel; no kernel of the port's runs): grouped scores without a
  materialised repeat of K/V (query head ``h`` reads KV head ``h //
  groups``), divided by ``sqrt(head_dim)``, kept in the input's dtype
  unless ``FLAGS_attention_fp32_scores`` is set, masked causally with
  ``-inf``, softmax in fp32, the probabilities cast to V's dtype for the
  second product.
  - The reference scales the fp32 product and rounds once to bf16; the
    port's bf16 product is rounded to bf16 by the matmul and then
    scaled. Where ``sqrt(head_dim)`` is a power of two (head_dim 4, 16,
    64, 256: TinyLlama's 64) the division is exact and both round the
    same; at head_dim 128 (LLaMA-7B) the scores may differ by one bf16
    rounding, which the tests hold to the bf16 bars. With the flag set
    (or in fp32) q and k are upcast before the product, whose fp32
    result is the reference's.
* SwiGLU: ``down(silu(gate(x)) * up(x))``.
* Initialisation: every parameter of rank >= 2 of the body (the
  embedding included) normal(0, ``initializer_range``), ``o_proj`` and
  ``down_proj`` scaled by ``1 / sqrt(2 * num_layers)``, norm weights
  ones; the untied ``lm_head`` keeps `nn.Linear`'s XavierUniform. Drawn
  on ``device`` from a ``torch.Generator`` seeded with ``seed``.

``loss`` feeds the final hiddens to the fused LM-head cross entropy
(`gpt.fused_lm_loss`, kernels #11/#12 on the card), so the ``[tokens,
vocab]`` logits never exist. The untied head's weight is ``[vocab,
hidden]`` here and goes in with ``transpose_y=True`` (the reference's
``[hidden, vocab]`` with ``transpose_y=False``): no copy a step.

Not ported yet: ``use_ring_attention`` and ``llama_sharding_rules``
(ROADMAP A9b).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..distributed.fleet.recompute import POLICIES, recompute
from ..framework.device import resolve_device
from ..nn import functional as PF
from ..nn.initializer import Constant
from ..nn.layer import Embedding, Layer, LayerList, Linear
from ..utils import flags as _flags
from .gpt import GPTPretrainingCriterion, fused_lm_loss

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "apply_rotary_pos_emb",
           "llama_config", "llama_sharding_rules"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 0            # 0 -> llama's 8/3 * hidden rule
    num_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 0          # 0 -> MHA (= num heads); <n -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    hidden_dropout_prob: float = 0.0
    use_recompute: bool = False
    recompute_policy: str = None
    use_ring_attention: bool = False

    def __post_init__(self):
        if not self.intermediate_size:
            # llama rounds 8/3*h up to a multiple of 256
            target = int(8 * self.hidden_size / 3)
            self.intermediate_size = 256 * ((target + 255) // 256)
        if not self.num_key_value_heads:
            self.num_key_value_heads = self.num_attention_heads
        if self.recompute_policy not in POLICIES:
            raise ValueError(
                f"unknown recompute policy {self.recompute_policy!r}; use "
                f"'dots' or 'nothing'/'full'")
        if self.use_ring_attention:
            raise NotImplementedError(
                "LlamaConfig(use_ring_attention=True) is not ported yet: "
                "ROADMAP A9b (ring attention)")


LLAMA_CONFIGS = {
    "llama-7b": dict(hidden_size=4096, num_layers=32,
                     num_attention_heads=32, intermediate_size=11008),
    "llama-13b": dict(hidden_size=5120, num_layers=40,
                      num_attention_heads=40, intermediate_size=13824),
    "llama2-70b": dict(hidden_size=8192, num_layers=80,
                       num_attention_heads=64, num_key_value_heads=8,
                       intermediate_size=28672),
    "tinyllama-1.1b": dict(hidden_size=2048, num_layers=22,
                           num_attention_heads=32, num_key_value_heads=4,
                           intermediate_size=5632),
}


def llama_config(name: str, **overrides) -> LlamaConfig:
    kw = dict(LLAMA_CONFIGS[name])
    kw.update(overrides)
    return LlamaConfig(**kw)


class LlamaRMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-5, **factory):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=Constant(1.0), **factory)
        self.epsilon = epsilon

    def forward(self, x):
        return PF.rms_norm(x, weight=self.weight, epsilon=self.epsilon)


def _rope_tables(seq, dim, theta, device=None):
    """fp32 ``cos``, ``sin`` of ``[seq, dim / 2]``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pos_emb(x, cos, sin):
    """x: ``[b, s, h, d]``; rotate-half convention (llama)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(Layer):
    """GQA attention with RoPE, dense as in the reference."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kv = self.num_kv_heads * self.head_dim
        self.q_proj = Linear(h, self.num_heads * self.head_dim,
                             bias_attr=False, **factory)
        self.k_proj = Linear(h, kv, bias_attr=False, **factory)
        self.v_proj = Linear(h, kv, bias_attr=False, **factory)
        self.o_proj = Linear(self.num_heads * self.head_dim, h,
                             bias_attr=False, **factory)
        self.rope_theta = config.rope_theta

    def forward(self, x):
        b, s, _ = x.shape
        nh, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        g = nh // kvh
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, kvh, hd)
        v = self.v_proj(x).reshape(b, s, kvh, hd)
        cos, sin = _rope_tables(s, hd, self.rope_theta, x.device)
        q = apply_rotary_pos_emb(q.float(), cos, sin).to(x.dtype)
        k = apply_rotary_pos_emb(k.float(), cos, sin).to(x.dtype)
        # grouped scores [b, kvh, g * s, s]: query head kvh * g + j reads
        # kv head kvh; no repeat of K/V
        qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(
            b, kvh, g * s, hd)
        kt = k.permute(0, 2, 3, 1)                     # [b, kvh, hd, s]
        low = x.dtype in (torch.bfloat16, torch.float16)
        if low and not _flags.get_flag("FLAGS_attention_fp32_scores"):
            scores = torch.matmul(qg, kt) / math.sqrt(hd)
        else:
            scores = torch.matmul(qg.float(), kt.float()) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.view(b, kvh, g, s, s).masked_fill(~causal,
                                                          float("-inf"))
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.matmul(probs.view(b, kvh, g * s, s),
                           v.permute(0, 2, 1, 3))      # [b, kvh, g*s, hd]
        out = out.view(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4).reshape(
            b, s, nh * hd)
        return self.o_proj(out.to(x.dtype))


class LlamaMLP(Layer):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, m, bias_attr=False, **factory)
        self.up_proj = Linear(h, m, bias_attr=False, **factory)
        self.down_proj = Linear(m, h, bias_attr=False, **factory)

    def forward(self, x):
        return self.down_proj(PF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, eps,
                                            **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, eps, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self._use_recompute = config.use_recompute
        self._recompute_policy = config.recompute_policy

    def _inner(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x):
        if self._use_recompute and self.training:
            return recompute(self._inner, x, policy=self._recompute_policy)
        return self._inner(x)


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **factory)
        self.layers = LayerList([LlamaDecoderLayer(config, **factory)
                                 for _ in range(config.num_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 **factory)
        self._init_weights(config, factory.get("generator"))

    @torch.no_grad()
    def _init_weights(self, config, generator):
        std = config.initializer_range
        resid = 1.0 / math.sqrt(2.0 * config.num_layers)
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, std, generator=generator)
                if re.search(r"(o_proj|down_proj)\.weight$", name):
                    p.mul_(resid)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """LLaMA + LM head (tied to ``embed_tokens`` with
    ``tie_word_embeddings``); ``forward`` returns logits, `loss` the
    training loss. Built on ``device`` (default: the CUDA card) in
    ``dtype``, its weights drawn from a generator seeded with ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        self.llama = LlamaModel(config, **factory)
        self.lm_head = (None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False,
            **factory))

    def head_weight(self):
        """The LM head's ``[vocab, hidden]`` weight: the embedding when
        tied."""
        return (self.llama.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)

    def forward(self, input_ids):
        return F.linear(self.llama(input_ids), self.head_weight())

    def loss(self, input_ids, labels, loss_mask=None):
        """Training loss through the fused LM head; numerically
        ``LlamaPretrainingCriterion()(self(ids), labels, loss_mask)``."""
        return fused_lm_loss(self.llama(input_ids), self.head_weight(), True,
                             labels, loss_mask)


# the GPT criterion is architecture-agnostic CE over shifted tokens
LlamaPretrainingCriterion = GPTPretrainingCriterion


def llama_sharding_rules(tp_axis="mp", fsdp_axis=None):
    raise NotImplementedError(
        "llama_sharding_rules (tensor and ZeRO placement) is not ported "
        "yet: ROADMAP A9b")
