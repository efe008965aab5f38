"""Token sampling for the serving and generation paths.

Counterpart of paddle_tpu/nn/functional/sampling.py: the truncation
(temperature, top-k, top-p) is transcribed exactly, with its threshold
tie rules. The random draw cannot match the reference's bits (JAX's
threefry vs a torch generator), so it keeps the reference's contract
instead. Serving (`sample_logits_per_slot`): row i draws from a
``torch.Generator`` on the logits' device seeded by a pure function of
``(seeds[i], positions[i])``, so a request's tokens never depend on
which other sequences share the batch. Generation (`sample_logits`):
the whole batch draws from one generator the caller seeds, so a seeded
``generate()`` repeats itself.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_logits", "sample_logits_per_slot", "slot_seed"]

_MASK64 = (1 << 64) - 1


def _truncate_logits(lf, temperature, top_k, top_p):
    """Temperature + top-k + top-p truncation over fp32 logits [..., v].

    Tie-break rule: truncation is threshold-based, not count-based.
    top-k keeps every logit >= the k-th largest value, so ties at the
    boundary all survive; ``top_k >= vocab`` keeps everything. top-p
    keeps every token whose exclusive prefix mass (the mass of the
    tokens before it in the descending sort) is < p, so the boundary
    token that crosses p is kept, and tokens tied with the smallest kept
    logit survive too (the cut compares against that value). The top
    token's exclusive mass is 0 < p, so the set is never empty."""
    lf = lf / float(temperature)
    if top_k and top_k > 0:
        kk = min(int(top_k), lf.shape[-1])
        kth = torch.topk(lf, kk, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, float("-inf"), lf)
    if top_p < 1.0:
        sort = torch.sort(lf, dim=-1, descending=True).values
        probs = torch.softmax(sort, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        keep = before < float(top_p)
        thresh = torch.where(keep, sort, float("inf")).amin(
            dim=-1, keepdim=True)
        lf = torch.where(lf < thresh, float("-inf"), lf)
    return lf


def sample_logits(logits, generator=None, temperature=1.0, top_k=0,
                  top_p=1.0):
    """One token a row of ``logits`` [..., vocab] (int32 ids of shape
    ``logits.shape[:-1]``). ``generator=None`` or temperature <= 0 is
    greedy argmax; otherwise a draw from the truncated distribution with
    ``generator`` (a ``torch.Generator`` on the logits' device)."""
    lf = logits.float()
    if generator is None or temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    probs = torch.softmax(_truncate_logits(lf, temperature, top_k, top_p),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return ids.reshape(probs.shape[:-1]).to(torch.int32)


def slot_seed(seed: int, position: int) -> int:
    """Generator seed of one (request seed, context position) pair:
    splitmix64 of the two 32-bit halves, so nearby pairs give unrelated
    streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _ints(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).tolist()
    return np.asarray(x).reshape(-1).tolist()


def sample_logits_per_slot(logits, seeds, positions, temperature=1.0,
                           top_k=0, top_p=1.0, greedy=False):
    """One token per row of ``logits`` [b, vocab] (int32 [b]).

    ``positions[i]`` is the number of context tokens behind row i's
    logits (the prompt length at prefill, the post-increment seq_len at
    decode), so a preempted request's re-prefill samples its next token
    from the same stream the decode step would have used. greedy=True
    (or temperature <= 0) is plain argmax."""
    lf = logits.float()
    if greedy or temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    probs = torch.softmax(_truncate_logits(lf, temperature, top_k, top_p),
                          dim=-1)
    out = torch.empty(lf.shape[0], dtype=torch.int64, device=lf.device)
    for i, (s, p) in enumerate(zip(_ints(seeds), _ints(positions))):
        gen = torch.Generator(device=lf.device).manual_seed(slot_seed(s, p))
        out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
    return out.to(torch.int32)
