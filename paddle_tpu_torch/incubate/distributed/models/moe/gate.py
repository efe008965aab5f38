"""The MoE gates: the port of paddle_tpu/incubate/distributed/models/moe/
gate.py (naive / switch (top-1) / gshard (top-2)).

Every function takes the router's ``[T, E]`` logits (fp32, tokens in
the flattened ``[b * s]`` order) and a capacity C, the slots an expert
has. A token's slot in its expert is the count of earlier tokens that
chose the same expert; top-2's second choices queue behind all first
choices; a token whose slot is C or more is dropped (its weight is 0).
Ties go to the first index, as ``argmax`` gives them on both sides.

* `route` is the main path's form: for each token and choice the expert,
  the slot, whether it is kept and the combine weight, plus the
  load-balance aux loss; `moe_layer.MoELayer` scatters and gathers rows
  by it, without a ``[T, E, C]`` tensor and without a host read.
* `top1_gating` / `top2_gating` are the reference's dense form, the
  ``[T, E, C]`` combine weights and dispatch mask: the plain version
  the tests hold `route` against.
"""
from __future__ import annotations

import torch

__all__ = ["NaiveGate", "route", "top1_gating", "top2_gating"]


def _one_hot(x, n):
    """fp32 one-hot of ``x`` over ``n`` classes; an index of ``n`` or more
    gives a zero row, as ``jax.nn.one_hot``."""
    return (x[:, None] == torch.arange(n, device=x.device)).float()


def _running_count(onehot):
    """The inclusive running count down the tokens of a ``[T, E]`` 0/1
    tensor, scanned along a contiguous ``[E, T]`` (CUDA's scan down the
    outer dim of ``[T, E]`` runs one thread a column: at T 8192, E 8 it
    took 1.3 ms a call on an H100 80GB HBM3 at 700 W, chip_smoke.py phase
    31(b) under profile_training --moe). Exact: the counts are
    integers."""
    return onehot.t().contiguous().cumsum(1).t()


def _positions_in_expert(expert_idx, num_experts, mask=None):
    """Each token's slot in its expert (the running count of earlier
    tokens that chose it) as int32 ``[T]``, and the fp32 one-hot
    ``[T, E]``; ``mask`` ([T] 0/1) leaves tokens out of the count."""
    onehot = _one_hot(expert_idx, num_experts)
    if mask is not None:
        onehot = onehot * mask[:, None]
    pos = _running_count(onehot) - onehot
    return (pos * onehot).sum(1).to(torch.int32), onehot


def _aux_load_balance(probs, sel_onehot):
    """GShard's aux loss: ``E * sum(mean prob * share routed)`` over the
    experts (Switch Transformer eq. 4)."""
    e = probs.shape[-1]
    return e * (probs.mean(0) * sel_onehot.mean(0)).sum()


def _choices(logits, top_k):
    """(probs, [expert of each choice], [its gate weight]): top-1 keeps
    the raw max probability, top-2 renormalizes the two by
    ``max(g1 + g2, 1e-9)``."""
    probs = torch.softmax(logits, dim=-1)
    idx1 = probs.argmax(-1)
    g1 = probs.gather(1, idx1[:, None])[:, 0]
    if top_k == 1:
        return probs, [idx1], [g1]
    probs2 = probs * (1.0 - _one_hot(idx1, probs.shape[-1]))
    idx2 = probs2.argmax(-1)
    g2 = probs2.gather(1, idx2[:, None])[:, 0]
    denom = (g1 + g2).clamp(min=1e-9)
    return probs, [idx1, idx2], [g1 / denom, g2 / denom]


def _second_positions(idx2, onehot1, num_experts):
    """Top-2's second choices' slots: behind every first choice of their
    expert, then in token order."""
    onehot2 = _one_hot(idx2, num_experts)
    pos2 = _running_count(onehot2) - onehot2 + onehot1.sum(0)[None]
    return (pos2 * onehot2).sum(1).to(torch.int32)


def route(logits, capacity, top_k):
    """The routing of ``logits`` [T, E] at ``capacity`` slots an expert:
    ``(experts, slots, keep, weights, aux)``, the first four ``[T,
    top_k]`` (int64, int64, bool, fp32 with dropped choices at 0), aux an
    fp32 scalar. Fixed shapes and no host read."""
    e = logits.shape[-1]
    probs, idxs, gates = _choices(logits, top_k)
    pos1, onehot1 = _positions_in_expert(idxs[0], e)
    slots = [pos1]
    if top_k == 2:
        slots.append(_second_positions(idxs[1], onehot1, e))
    experts = torch.stack(idxs, 1)
    slots = torch.stack(slots, 1).long()
    keep = slots < capacity
    weights = torch.stack(gates, 1) * keep
    return experts, slots, keep, weights, _aux_load_balance(probs, onehot1)


def _dense(onehot, pos, keep, capacity):
    """``[T, E, C]`` fp32: 1 at (token, its expert, its slot) if kept."""
    d = onehot[:, :, None] * _one_hot(pos.long(), capacity)[:, None, :]
    return d * keep.float()[:, None, None]


def top1_gating(logits, capacity):
    """Switch gating in the reference's dense form: ``(combine [T, E, C]
    fp32, dispatch [T, E, C] bool, aux)``."""
    probs, idxs, gates = _choices(logits, 1)
    pos, onehot = _positions_in_expert(idxs[0], logits.shape[-1])
    dispatch = _dense(onehot, pos, pos < capacity, capacity)
    aux = _aux_load_balance(probs, onehot)
    return dispatch * gates[0][:, None, None], dispatch.bool(), aux


def top2_gating(logits, capacity):
    """GShard top-2 gating in the reference's dense form, normalized
    weights: ``(combine, dispatch, aux)`` as `top1_gating`'s."""
    e = logits.shape[-1]
    probs, idxs, (g1, g2) = _choices(logits, 2)
    pos1, onehot1 = _positions_in_expert(idxs[0], e)
    pos2 = _second_positions(idxs[1], onehot1, e)
    d1 = _dense(onehot1, pos1, pos1 < capacity, capacity)
    d2 = _dense(_one_hot(idxs[1], e), pos2, pos2 < capacity, capacity)
    combine = d1 * g1[:, None, None] + d2 * g2[:, None, None]
    return combine, (d1 + d2) > 0, _aux_load_balance(probs, onehot1)


class NaiveGate:
    """The router's gating rule by name (reference naive_gate.py):
    "switch" is top-1, "gshard" and "naive" top-2. Calling it gives the
    dense form; `route` the index form."""

    def __init__(self, kind="gshard"):
        if kind not in ("gshard", "switch", "naive"):
            raise ValueError(f"unknown gate {kind!r}")
        self.kind = kind
        self.top_k = 1 if kind == "switch" else 2

    def __call__(self, logits, capacity):
        if self.top_k == 1:
            return top1_gating(logits, capacity)
        return top2_gating(logits, capacity)

    def route(self, logits, capacity):
        return route(logits, capacity, self.top_k)
