"""Megatron tensor-parallel layers: the port of paddle_tpu/distributed/
fleet/layers/mpu/mp_layers.py (`VocabParallelEmbedding` :47,
`ColumnParallelLinear` :334, `RowParallelLinear` :541,
`ParallelCrossEntropy` :742).

The reference holds each weight at its global shape with a sharding over
the mp mesh axis and GSPMD writes the collectives. Here each rank of the
model-parallel group holds its block only, and the collectives are
Megatron's operators (`mp_ops`): rank r's output is the reference's
global output, and rank r's gradient is the reference's block r. The
Linear layers store their weight as ``torch.nn.Linear`` does, ``[out,
in]`` (the reference's ``[in, out]`` transposed, as everywhere in the
port): `ColumnParallelLinear` holds rows ``[r * out/mp, (r+1) * out/mp)``
of it, `RowParallelLinear` columns ``[r * in/mp, (r+1) * in/mp)``; the
embedding holds rows ``[r * V/mp, (r+1) * V/mp)``. Each block is cut
from the global tensor the initializer draws (every rank draws it the
same way), so a model built on one rank and on mp ranks from one seed
agree; ``is_distributed`` and ``split_axis`` (the split dim of the
port's tensor) mark a block, which `convert.mp_state_dict_from_jax` and
the broadcasts read.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .....nn.initializer import Constant, XavierUniform
from .....nn.layer.layers import Layer, create_parameter
from .mp_ops import c_concat, c_identity, c_split, combine_lse, mp_allreduce
from .mp_ops import mp_group as _resolve

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding",
           "vocab_parallel_cross_entropy"]


def _degree_rank(group):
    return (1, 0) if group is None else (group.nranks, group.rank)


def _block_param(full, dim, group):
    """Rank's block of ``full`` along ``dim`` as a parameter marked
    distributed (the whole of it at degree 1)."""
    n, r = _degree_rank(group)
    if full is None:
        return None
    if full.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {full.shape[dim]} does not "
                         f"split over {n} model-parallel ranks")
    w = full.shape[dim] // n
    p = torch.nn.Parameter(full.detach().narrow(dim, r * w, w).clone(),
                           requires_grad=full.requires_grad)
    for k in ("optimize_attr", "regularizer", "need_clip"):
        setattr(p, k, getattr(full, k, None))
    p.is_distributed = n > 1
    p.split_axis = dim
    return p


class VocabParallelEmbedding(Layer):
    """Rows ``[r * V/mp, (r+1) * V/mp)`` of the ``[V, H]`` table; a token
    outside them reads zeros, and the sum over the group gives every
    rank the whole lookup."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self._group = _resolve(mp_group)
        n, r = _degree_rank(self._group)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        full = create_parameter([num_embeddings, embedding_dim], weight_attr,
                                dtype, default_initializer=XavierUniform(),
                                device=device, generator=generator)
        self.weight = _block_param(full, 0, self._group)
        self.vocab_start = r * (num_embeddings // n)

    def forward(self, x):
        vloc = self.weight.shape[0]
        rel = x.long() - self.vocab_start
        inside = (rel >= 0) & (rel < vloc)
        out = F.embedding(torch.where(inside, rel, torch.zeros_like(rel)),
                          self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return mp_allreduce(out, self._group)


class ColumnParallelLinear(torch.nn.Linear):
    """Output features ``[r * out/mp, (r+1) * out/mp)`` (weight rows and
    bias); the input's grad is summed over the group (`c_identity`), and
    with ``gather_output`` the ranks' outputs are concatenated."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        torch.nn.Module.__init__(self)
        self._group = _resolve(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.is_mp = _degree_rank(self._group)[0] > 1
        w = create_parameter([in_features, out_features], weight_attr, dtype,
                             default_initializer=XavierUniform(),
                             device=device, generator=generator,
                             transpose=True)
        self.weight = _block_param(w, 0, self._group)
        b = create_parameter([out_features], None, dtype, is_bias=True,
                             default_initializer=Constant(0.0),
                             device=device) if has_bias else None
        self.bias = _block_param(b, 0, self._group)

    def forward(self, x):
        out = F.linear(c_identity(x, self._group), self.weight, self.bias)
        return c_concat(out, self._group) if self.gather_output else out


class RowParallelLinear(torch.nn.Linear):
    """Input features ``[r * in/mp, (r+1) * in/mp)`` (weight columns); the
    partial products are summed over the group (`mp_allreduce`) and the
    bias, whole on every rank, is added after the sum. Without
    ``input_is_parallel`` the rank takes its block of the input first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None, generator=None):
        torch.nn.Module.__init__(self)
        self._group = _resolve(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        w = create_parameter([in_features, out_features], weight_attr, dtype,
                             default_initializer=XavierUniform(),
                             device=device, generator=generator,
                             transpose=True)
        self.weight = _block_param(w, 1, self._group)
        self.bias = create_parameter([out_features], None, dtype,
                                     is_bias=True,
                                     default_initializer=Constant(0.0),
                                     device=device) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = c_split(x, self._group)
        out = mp_allreduce(F.linear(x, self.weight), self._group)
        return out if self.bias is None else out + self.bias


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy over logits split along the vocab: each rank's
    log-sum-exp and label logit combined over the group (`combine_lse`);
    the backward is local (softmax minus the one-hot, on the rank's
    columns)."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        vloc = x.shape[-1]
        rel = label.long() - group.rank * vloc
        inside = (rel >= 0) & (rel < vloc)
        safe = torch.where(inside, rel, torch.zeros_like(rel))
        pred = torch.take_along_dim(x, safe.unsqueeze(-1), -1).squeeze(-1)
        zero = torch.zeros((), device=x.device)
        lse, picked = combine_lse(torch.logsumexp(x, -1),
                                  torch.where(inside, pred, zero), group)
        keep = label != ignore_index
        ctx.save_for_backward(x, lse, safe, inside, keep)
        ctx.dtype = logits.dtype
        return torch.where(keep, lse - picked, zero)

    @staticmethod
    def backward(ctx, g):
        x, lse, safe, inside, keep = ctx.saved_tensors
        d = torch.exp(x - lse.unsqueeze(-1))
        d.scatter_add_(-1, safe.unsqueeze(-1),
                       -inside.to(d.dtype).unsqueeze(-1))
        g = torch.where(keep, g.float(), torch.zeros((), device=g.device))
        return (d * g.unsqueeze(-1)).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, label, group=None,
                                 ignore_index=-100):
    """Per-token CE of logits whose last dim is split over ``group``
    (rank r holds vocab ids ``[r * V/mp, (r+1) * V/mp)``); ``label``
    holds global ids, shaped as the logits without their last dim (or
    with a trailing 1). fp32 losses of the label's shape, the same on
    every rank, 0 at ``ignore_index``."""
    group = _resolve(group)
    squeeze = label.dim() == logits.dim()
    lbl = label.squeeze(-1) if squeeze else label
    if _degree_rank(group)[0] == 1:
        loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               lbl.reshape(-1).long(), reduction="none",
                               ignore_index=ignore_index).reshape(lbl.shape)
    else:
        loss = _VocabParallelCE.apply(logits, lbl, group, int(ignore_index))
    return loss.unsqueeze(-1) if squeeze else loss


class ParallelCrossEntropy(Layer):
    """Reference mp_layers.py:742: `vocab_parallel_cross_entropy` over
    the fleet's model-parallel group (or ``mp_group``), resolved at each
    call; with no group of more than one rank, the plain cross entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._mp_group = mp_group
        self._ignore_index = ignore_index

    def forward(self, input, label):
        return vocab_parallel_cross_entropy(input, label, self._mp_group,
                                            self._ignore_index)
