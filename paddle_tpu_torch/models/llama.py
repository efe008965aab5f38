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

Tensor parallelism. `llama_sharding_rules` is the reference's Megatron
placement (:297-310). Under a model-parallel group of more than one
rank (``mp_group=``, else the fleet's, resolved at construction) the
model places its blocks by those rules: a rule whose tp axis is on the
reference's out dim (``[in, out]``) makes the Linear a
`ColumnParallelLinear` (no gather: q, k, v, gate, up, the untied
head), one on the in dim a `RowParallelLinear` (input parallel: o,
down), ``embed_tokens`` a `VocabParallelEmbedding`; the norms stay
whole. Attention runs ``num_heads / mp`` query heads over
``num_key_value_heads / mp`` KV heads (rank r's local query head j reads
its local KV head ``j // groups``: the global rule ``h // groups``, as
a rank's heads are a contiguous block of whole heads), and one
Megatron f (`c_identity`) feeds each column group (q, k, v; gate, up),
so a layer all-reduces twice forward and twice backward. `loss` runs
the vocab-parallel fused CE (`sharded_fused_cross_entropy`, #11/#12)
over the rank's rows ``[r * V/mp, (r+1) * V/mp)`` of the ``[V, H]``
head, tied or untied; `forward` gives the whole logits (the column
product, then `c_concat`), as the reference's GSPMD gives them. The
port is stricter than the reference: where the heads, the KV heads,
``intermediate_size`` or the vocab do not divide by the degree, the
reference leaves that dim whole (GSPMD replicates it) and the port
raises a ``ValueError`` naming the dim.

Weights are drawn a piece at a time from a generator of its own, seeded
from ``(seed, piece)`` (the embedding is piece 0, layer i piece i + 1,
the untied head piece L + 1): each rank of a model-parallel group
draws a piece's global tensors and keeps its block, and a pipeline
stage builds only its own pieces (`LlamaForCausalLMPipe`), so no rank
ever holds the whole model and every layout draws the world of one's
tensors for a seed.

`LlamaForCausalLMPipe` is the model as `LayerDesc` s for `PipelineLayer`
(the embedding, the decoder layers, the final norm, the head, and
`LlamaPretrainingCriterion` as the loss), split by decoder layers;
under mp its head gives the rank's vocab columns and its loss is the
vocab-parallel CE over them (`ParallelCrossEntropy`'s).

Sequence parallelism (the sep axis, reference :128-168). Under a fleet
whose sep degree is above 1 (`distributed.fleet.meta_parallel.
SegmentParallel`, or `PipelineParallel` for `LlamaForCausalLMPipe`) a
rank's input is its block of the sequence: the RoPE tables are the
block's global positions' rows, K and V are repeated to the rank's query
heads (GQA, reference :164-166) and attention runs over the sep group,
`ring_attention` with ``use_ring_attention``, else the rank's queries
over the gathered K/V (`sep_gathered_attention`). Under mp as well a
rank's heads are its ``num_heads / mp`` query and ``num_kv_heads / mp``
KV heads, so the ring carries the rank's heads of its block, and
``o_proj`` stays row-parallel. ``loss`` (and the pipe's criterion, which
sees the last stage's block) sums the tokens' losses and counts over the
sep group before the division (`gpt.fused_lm_loss`; under mp after the
vocab-parallel CE), so every rank holds the global mean.
``use_ring_attention`` at a world of one runs the dense path, as the
reference's does.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..distributed.fleet.layers.mpu import (ColumnParallelLinear,
                                            RowParallelLinear,
                                            VocabParallelEmbedding,
                                            vocab_parallel_cross_entropy)
from ..distributed.fleet.layers.mpu.mp_ops import (c_concat, c_identity,
                                                   mp_group)
from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer
from ..distributed.fleet.meta_parallel.ring_attention import (
    ring_attention, sep_gathered_attention, sep_group)
from ..distributed.fleet.recompute import POLICIES, recompute
from ..framework.device import resolve_device
from ..nn import functional as PF
from ..nn.initializer import Constant, Normal
from ..nn.layer import Embedding, Layer, LayerList, Linear
from ..nn.layer.layers import ParamAttr
from ..ops.kernels.fused_cross_entropy import sharded_fused_cross_entropy
from ..utils import flags as _flags
from .gpt import (GPTPretrainingCriterion, fused_lm_loss, match_sharding,
                  token_mean)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaEmbeddingPipe", "LlamaForCausalLM", "LlamaForCausalLMPipe",
           "LlamaLMHeadPipe", "LlamaModel", "LlamaPretrainingCriterion",
           "LlamaRMSNorm", "apply_rotary_pos_emb", "llama_config",
           "llama_sharding_rules"]


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


def llama_sharding_rules(tp_axis="mp", fsdp_axis=None):
    """Megatron placement of LLaMA's weights (reference :297-310), as
    ``(pattern, spec)`` pairs over the reference's layouts (a Linear
    weight ``[in, out]``): q / k / v / gate / up column-parallel (out on
    ``tp_axis``), o / down row-parallel (in on it), the embedding split
    by vocab, the head column-parallel, the norms whole; ``fsdp_axis``
    shards the other dim. `match_sharding` reads a name's spec."""
    return [
        (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$",
         (fsdp_axis, tp_axis)),
        (r"(o_proj|down_proj)\.weight$", (tp_axis, fsdp_axis)),
        (r"embed_tokens\.weight$", (tp_axis, fsdp_axis)),
        (r"lm_head\.weight$", (fsdp_axis, tp_axis)),
        (r"(layernorm|norm)\.weight$", (None,)),
    ]


def _tp_dim(name):
    """The dim of the reference's layout that `llama_sharding_rules`
    splits over the model-parallel axis for parameter ``name`` (None:
    whole)."""
    spec = match_sharding(name, llama_sharding_rules())
    return spec.index("mp") if "mp" in spec else None


def _mp(group=None):
    """The model-parallel group the pieces are placed over: ``group``,
    else the fleet's; None below two ranks."""
    group = mp_group(group)
    return group if group is not None and group.nranks > 1 else None


def _divides(what, size, group):
    if group is not None and size % group.nranks:
        raise ValueError(
            f"{what} {size} does not split over the {group.nranks} "
            f"model-parallel ranks (the reference would leave it whole)")


def _piece_generator(device, seed, piece):
    """The generator of a model piece (0 the embedding, i + 1 decoder
    layer i, L + 1 the untied head) for ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + int(piece))


def _linear(name, n_in, n_out, std, group, **factory):
    """The Linear ``name`` (``q_proj``, ...), bias-free, its weight drawn
    normal(0, ``std``) in the reference's ``[in, out]``: plain, or under
    ``group`` column / row parallel as `llama_sharding_rules` places
    it."""
    attr = ParamAttr(initializer=Normal(0.0, std))
    if group is None:
        return Linear(n_in, n_out, weight_attr=attr, bias_attr=False,
                      **factory)
    if _tp_dim(f"{name}.weight") == 1:
        return ColumnParallelLinear(n_in, n_out, weight_attr=attr,
                                    has_bias=False, gather_output=False,
                                    mp_group=group, **factory)
    return RowParallelLinear(n_in, n_out, weight_attr=attr, has_bias=False,
                             input_is_parallel=True, mp_group=group,
                             **factory)


def _columns(x, group, *lins):
    """``x`` through each column Linear of ``lins``; under mp one
    Megatron f for all of them, then the rank's output features."""
    if group is None:
        return [lin(x) for lin in lins]
    x = c_identity(x, group)
    return [F.linear(x, lin.weight) for lin in lins]


class LlamaRMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-5, **factory):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=Constant(1.0), **factory)
        self.epsilon = epsilon

    def forward(self, x):
        return PF.rms_norm(x, weight=self.weight, epsilon=self.epsilon)


def _rope_tables(seq, dim, theta, device=None, start=0):
    """fp32 ``cos``, ``sin`` of ``[seq, dim / 2]``: the rows of positions
    ``[start, start + seq)``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(start, start + seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pos_emb(x, cos, sin):
    """x: ``[b, s, h, d]``; rotate-half convention (llama)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(Layer):
    """GQA attention with RoPE, dense as in the reference; under mp the
    rank's heads (module docstring)."""

    def __init__(self, config: LlamaConfig, mp_group=None, **factory):
        super().__init__()
        h = config.hidden_size
        group = self._mp = _mp(mp_group)
        n = 1 if group is None else group.nranks
        _divides("num_attention_heads", config.num_attention_heads, group)
        _divides("num_key_value_heads", config.num_key_value_heads, group)
        self.head_dim = h // config.num_attention_heads
        self.num_heads = config.num_attention_heads // n
        self.num_kv_heads = config.num_key_value_heads // n
        q = config.num_attention_heads * self.head_dim
        kv = config.num_key_value_heads * self.head_dim
        std = config.initializer_range
        resid = std / math.sqrt(2.0 * config.num_layers)
        self.q_proj = _linear("q_proj", h, q, std, group, **factory)
        self.k_proj = _linear("k_proj", h, kv, std, group, **factory)
        self.v_proj = _linear("v_proj", h, kv, std, group, **factory)
        self.o_proj = _linear("o_proj", q, h, resid, group, **factory)
        self.rope_theta = config.rope_theta
        self.use_ring = config.use_ring_attention

    def forward(self, x):
        b, s, _ = x.shape
        nh, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        g = nh // kvh
        sep = sep_group()
        q, k, v = _columns(x, self._mp, self.q_proj, self.k_proj,
                           self.v_proj)
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, kvh, hd)
        v = v.reshape(b, s, kvh, hd)
        cos, sin = _rope_tables(s, hd, self.rope_theta, x.device,
                                start=0 if sep is None else sep.rank * s)
        q = apply_rotary_pos_emb(q.float(), cos, sin).to(x.dtype)
        k = apply_rotary_pos_emb(k.float(), cos, sin).to(x.dtype)
        if sep is not None:
            # every (rank's) query head its K/V head's copy (reference
            # :164-166)
            attend = ring_attention if self.use_ring \
                else sep_gathered_attention
            out = attend(q, k.repeat_interleave(g, dim=2),
                         v.repeat_interleave(g, dim=2), sep, causal=True)
            return self.o_proj(out.reshape(b, s, nh * hd))
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
    """SwiGLU: down(silu(gate(x)) * up(x)); under mp the rank's block of
    the intermediate features."""

    def __init__(self, config: LlamaConfig, mp_group=None, **factory):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        group = self._mp = _mp(mp_group)
        _divides("intermediate_size", m, group)
        std = config.initializer_range
        resid = std / math.sqrt(2.0 * config.num_layers)
        self.gate_proj = _linear("gate_proj", h, m, std, group, **factory)
        self.up_proj = _linear("up_proj", h, m, std, group, **factory)
        self.down_proj = _linear("down_proj", m, h, resid, group, **factory)

    def forward(self, x):
        gate, up = _columns(x, self._mp, self.gate_proj, self.up_proj)
        return self.down_proj(PF.silu(gate) * up)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, mp_group=None, **factory):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, eps,
                                            **factory)
        self.self_attn = LlamaAttention(config, mp_group, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, eps, **factory)
        self.mlp = LlamaMLP(config, mp_group, **factory)
        self._use_recompute = config.use_recompute
        self._recompute_policy = config.recompute_policy

    def _inner(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x):
        if self._use_recompute and self.training:
            return recompute(self._inner, x, policy=self._recompute_policy)
        return self._inner(x)


def _embedding(config, group, **factory):
    """``embed_tokens``: normal(0, initializer_range), vocab-parallel
    under ``group``."""
    attr = ParamAttr(initializer=Normal(0.0, config.initializer_range))
    if group is None:
        return Embedding(config.vocab_size, config.hidden_size,
                         weight_attr=attr, **factory)
    _divides("vocab_size", config.vocab_size, group)
    return VocabParallelEmbedding(config.vocab_size, config.hidden_size,
                                  weight_attr=attr, mp_group=group,
                                  **factory)


def _lm_head(config, group, **factory):
    """The untied head (XavierUniform, as `nn.Linear`'s default), column
    parallel under ``group``: the rank's vocab rows of ``[V, H]``."""
    if group is None:
        return Linear(config.hidden_size, config.vocab_size,
                      bias_attr=False, **factory)
    _divides("vocab_size", config.vocab_size, group)
    return ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                has_bias=False, gather_output=False,
                                mp_group=group, **factory)


def _pieces(factory, seed):
    """``piece -> factory``: with ``seed``, each piece's own generator
    (`_piece_generator`); else ``factory`` as given (one generator, if
    any, drawn in order)."""
    if seed is None:
        return lambda piece: factory
    dev = factory.get("device")
    return lambda piece: {**factory,
                          "generator": _piece_generator(dev, seed, piece)}


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, mp_group=None, seed=None,
                 **factory):
        super().__init__()
        self.config = config
        group = self._mp = _mp(mp_group)
        piece = _pieces(factory, seed)
        self.embed_tokens = _embedding(config, group, **piece(0))
        self.layers = LayerList([
            LlamaDecoderLayer(config, group, **piece(i + 1))
            for i in range(config.num_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 **factory)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """LLaMA + LM head (tied to ``embed_tokens`` with
    ``tie_word_embeddings``); ``forward`` returns logits, `loss` the
    training loss. Built on ``device`` (default: the CUDA card) in
    ``dtype``, its pieces drawn from generators seeded from ``seed``;
    under a model-parallel group above one rank (``mp_group``, else the
    fleet's) the rank's Megatron blocks (module docstring)."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 seed=0, mp_group=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        group = self.mp_group = _mp(mp_group)
        self.llama = LlamaModel(config, group, seed, **factory)
        self.lm_head = (None if config.tie_word_embeddings else _lm_head(
            config, group, **_pieces(factory, seed)(config.num_layers + 1)))

    def head_weight(self):
        """The LM head's ``[vocab, hidden]`` weight (under mp the rank's
        rows of it): the embedding when tied."""
        return (self.llama.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)

    def forward(self, input_ids):
        h = self.llama(input_ids)
        g = self.mp_group
        if g is None:
            return F.linear(h, self.head_weight())
        return c_concat(F.linear(c_identity(h, g), self.head_weight()), g)

    def loss(self, input_ids, labels, loss_mask=None):
        """Training loss through the fused LM head; numerically
        ``LlamaPretrainingCriterion()(self(ids), labels, loss_mask)``.
        Under mp the vocab-parallel fused CE over the rank's rows, the
        hiddens' grad summed over the group; under sep as well the sum
        and the count summed over the sep group (`gpt.token_mean`)."""
        h = self.llama(input_ids)
        g = self.mp_group
        if g is None:
            return fused_lm_loss(h, self.head_weight(), True, labels,
                                 loss_mask)
        w = self.head_weight()
        lbl = labels.reshape(-1)
        losses = sharded_fused_cross_entropy(
            c_identity(h.reshape(-1, h.shape[-1]), g), w, lbl,
            g.rank * w.shape[0], g)
        m = (lbl != -100) if loss_mask is None else loss_mask.reshape(-1)
        return token_mean(losses, m.to(losses.dtype), sep_group())


LlamaPretrainingCriterion = GPTPretrainingCriterion


class _PipeCriterion(GPTPretrainingCriterion):
    """`LlamaForCausalLMPipe`'s loss over the last stage's logits:
    `LlamaPretrainingCriterion`'s masked mean; under mp (``group``) the
    vocab-parallel CE over the rank's vocab columns
    (`ParallelCrossEntropy`'s); under a sep degree above 1, where the
    stage sees the rank's block of the sequence, the sum and the count
    summed over the sep group before the division (`gpt.token_mean`)."""

    def __init__(self, group=None):
        super().__init__()
        self._group = group

    def forward(self, logits, labels, loss_mask=None):
        flat = labels.reshape(-1)
        if self._group is None:
            loss = PF.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    flat, reduction="none")
        else:
            loss = vocab_parallel_cross_entropy(logits, labels,
                                                self._group).reshape(-1)
        m = (flat != -100) if loss_mask is None else loss_mask.reshape(-1)
        return token_mean(loss, m.to(loss.dtype), sep_group())


class LlamaEmbeddingPipe(Layer):
    """The pipeline's first piece: ``embed_tokens`` (vocab-parallel under
    mp)."""

    def __init__(self, config: LlamaConfig, mp_group=None, **factory):
        super().__init__()
        self.embed_tokens = _embedding(config, _mp(mp_group), **factory)

    def forward(self, input_ids):
        return self.embed_tokens(input_ids)


class LlamaLMHeadPipe(Layer):
    """The pipeline's last piece: the untied ``lm_head``; under mp the
    rank's vocab columns of the logits."""

    def __init__(self, config: LlamaConfig, mp_group=None, **factory):
        super().__init__()
        self.lm_head = _lm_head(config, _mp(mp_group), **factory)

    def forward(self, h):
        return self.lm_head(h)


class LlamaForCausalLMPipe(PipelineLayer):
    """`LlamaForCausalLM` (untied) as a `PipelineLayer` of `LayerDesc` s:
    `LlamaEmbeddingPipe`, ``num_layers`` `LlamaDecoderLayer`,
    `LlamaRMSNorm`, `LlamaLMHeadPipe`, and `LlamaPretrainingCriterion`
    (under mp its vocab-parallel form over the head's columns, under sep
    summed over the sep group: `_PipeCriterion`); split
    evenly by decoder layers (``seg_method="layer:LlamaDecoderLayer"``,
    the reference's rule). A rank builds only its stage, each
    piece drawn as `LlamaForCausalLM` draws it for ``seed``, under a
    model-parallel group above one rank (``mp_group``, else the
    fleet's) its Megatron blocks."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, seed=0, num_stages=None,
                 stage_id=None, mp_group=None):
        if config.tie_word_embeddings:
            raise ValueError(
                "LlamaForCausalLMPipe builds the untied head; a tied one "
                "needs a SharedLayerDesc of the embedding")
        dev = resolve_device(device)
        piece = _pieces(dict(device=dev, dtype=dtype), seed)
        group = _mp(mp_group)
        L = config.num_layers
        descs = ([LayerDesc(LlamaEmbeddingPipe, config, group, **piece(0))]
                 + [LayerDesc(LlamaDecoderLayer, config, group,
                              **piece(i + 1)) for i in range(L)]
                 + [LayerDesc(LlamaRMSNorm, config.hidden_size,
                              config.rms_norm_eps, device=dev, dtype=dtype),
                    LayerDesc(LlamaLMHeadPipe, config, group,
                              **piece(L + 1))])
        super().__init__(descs, num_stages=num_stages, stage_id=stage_id,
                         loss_fn=_PipeCriterion(group),
                         seg_method="layer:LlamaDecoderLayer")
        self.config = config
