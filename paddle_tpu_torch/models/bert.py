"""BERT: the model family of paddle_tpu/models/bert.py in PyTorch, the
BASELINE fine-tune target (BERT-base, AMP O2).

Parameter names and creation order are the reference's
(``bert.embeddings.{word,position,token_type}_embeddings.weight``,
``bert.embeddings.layer_norm``, each ``bert.encoder.<i>``'s
``attention.qkv`` (one fused ``[3h]`` Linear: q, k, v in that order),
``attention.out``, ``attn_norm``, ``fc1``, ``fc2`` and ``out_norm``,
then ``bert.pooler.dense`` and the head), so ``named_parameters()`` is
the order the reference numbers them in and `convert` carries a
checkpoint and its optimizer state across (the Linear weights are
``torch.nn.Linear``'s ``[out, in]``, which `convert` transposes).

The numerics are the reference's:

* post-LN encoder layers: ``attn_norm(x + dropout(attention(x)))``, then
  ``out_norm(x + dropout(fc2(gelu(fc1(x)))))`` (exact GELU);
* attention is `nn.functional.scaled_dot_product_attention` with the
  additive padding mask and ``attention_dropout_prob``: its dense path
  (aten ops, as the reference runs XLA), bf16 scores in bf16 under O2,
  an fp32 softmax;
* `BertModel` turns a ``[b, s]`` 1/0 mask into the additive fp32
  ``(1 - m)[:, None, None, :] * -1e9``; a ``[b, 1 or h, sq, sk]`` mask
  passes as it is;
* the pooler is ``tanh(dense(hidden[:, 0]))``; the MLM head's logits
  are its transform against the word embeddings (``[vocab, hidden]``,
  tied, no bias).

``BertModel``, ``BertForSequenceClassification`` and
``BertForPretraining`` take ``device`` (default: the CUDA card),
``dtype`` and ``seed``: every body parameter of rank >= 2 is drawn
normal(0, ``initializer_range``) on ``device`` from a generator seeded
with ``seed`` (the reference's ``_init_weights``; the LayerNorms ones
and zeros, the biases zeros), the heads' Linears then take
`nn.Linear`'s XavierUniform from the same generator. A second generator
seeded with ``seed`` draws every dropout mask of the model (its
``nn.Dropout`` layers and the attention's), so a seeded model replays
its masks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..framework.device import resolve_device
from ..nn import functional as PF
from ..nn.layer import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear

__all__ = ["BERT_CONFIGS", "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_config"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0          # 0 -> 4 * hidden
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size


BERT_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_layers=12,
                      num_attention_heads=12),
    "bert-large": dict(hidden_size=1024, num_layers=24,
                       num_attention_heads=16),
}


def bert_config(name: str, **overrides) -> BertConfig:
    kw = dict(BERT_CONFIGS[name])
    kw.update(overrides)
    return BertConfig(**kw)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, drop, **factory):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, **factory)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, h, **factory)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **factory)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    **factory)
        self.dropout = Dropout(config.hidden_dropout_prob, generator=drop)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.int64, device=dev)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    def __init__(self, config: BertConfig, drop, **factory):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = Linear(h, 3 * h, **factory)
        self.out = Linear(h, h, **factory)
        self.dropout_p = config.attention_dropout_prob
        self._drop = drop

    def forward(self, x, attention_mask=None):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        out = PF.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            attn_mask=attention_mask, dropout_p=self.dropout_p,
            is_causal=False, training=self.training, generator=self._drop)
        return self.out(out.reshape(b, s, h))


class BertLayer(Layer):
    def __init__(self, config: BertConfig, drop, **factory):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, drop, **factory)
        self.attn_norm = LayerNorm(h, epsilon=eps, **factory)
        self.fc1 = Linear(h, config.intermediate_size, **factory)
        self.fc2 = Linear(config.intermediate_size, h, **factory)
        self.out_norm = LayerNorm(h, epsilon=eps, **factory)
        self.dropout = Dropout(config.hidden_dropout_prob, generator=drop)

    def forward(self, x, attention_mask=None):
        # post-LN (original BERT)
        x = self.attn_norm(x + self.dropout(
            self.attention(x, attention_mask)))
        return self.out_norm(x + self.dropout(
            self.fc2(PF.gelu(self.fc1(x)))))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, **factory):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            **factory)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    """The encoder: ``forward`` returns ``(hidden [b, s, h], pooled [b,
    h])``. Built on ``device`` in ``dtype``, its weights drawn from a
    generator seeded with ``seed`` (see the module docstring)."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self._factory = dict(
            device=dev, dtype=dtype,
            generator=torch.Generator(device=dev).manual_seed(seed))
        self.dropout_generator = torch.Generator(device=dev).manual_seed(seed)
        drop = self.dropout_generator
        self.embeddings = BertEmbeddings(config, drop, **self._factory)
        self.encoder = LayerList([BertLayer(config, drop, **self._factory)
                                  for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, **self._factory)
        self._init_weights(config)

    @torch.no_grad()
    def _init_weights(self, config):
        for p in self.parameters():
            if p.ndim >= 2:
                p.normal_(0.0, config.initializer_range,
                          generator=self._factory["generator"])

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [b, s] 1/0 padding mask -> additive [b, 1, 1, s]
            attention_mask = ((1.0 - attention_mask.float())[:, None, None, :]
                              * -1e9)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(Layer):
    """The fine-tune head: ``forward`` returns ``[b, num_classes]``
    logits."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        self.bert = BertModel(config, device, dtype, seed)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=self.bert.dropout_generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **self.bert._factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(Layer):
    """MLM + NSP heads: ``forward`` returns ``(mlm_logits [b, s, vocab],
    nsp_logits [b, 2])``."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.bert = BertModel(config, device, dtype, seed)
        factory = self.bert._factory
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    **factory)
        self.mlm_norm = LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps, **factory)
        self.nsp = Linear(config.hidden_size, 2, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        hidden, pooled = self.bert(input_ids, token_type_ids,
                                   attention_mask=attention_mask)
        h = self.mlm_norm(PF.gelu(self.mlm_transform(hidden)))
        mlm_logits = F.linear(h, self.bert.embeddings.word_embeddings.weight)
        return mlm_logits, self.nsp(pooled)
