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

Speculative decoding (`truncated_probs`, `spec_accept_greedy`,
`spec_accept_sampled`, `spec_draft_seeds`): the reference folds tags 1,
2 and 3 into a dispatch's per-slot key for the acceptance uniforms, the
residual draw and the draft proposals. Here each of those streams is a
generator seeded by `spec_seed` (seed, the pre-dispatch context length,
the tag, the draft index): a pure function of the four, and the tags
give unrelated streams. Seeds and positions are host arrays: reading a
device tensor there would sync the host inside a step.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_logits", "sample_logits_per_slot", "slot_seed",
           "spec_seed", "truncated_probs", "spec_accept_greedy",
           "spec_accept_sampled", "spec_draft_seeds", "draw_rows"]

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


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def slot_seed(seed: int, position: int) -> int:
    """Generator seed of one (request seed, context position) pair:
    splitmix64 of the two 32-bit halves, so nearby pairs give unrelated
    streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    return _splitmix64(z) & ((1 << 63) - 1)


def spec_seed(seed: int, position: int, tag: int, j: int = 0) -> int:
    """Generator seed of one speculative-decoding stream: the slot's
    (seed, pre-dispatch context length) pair, then the stream's tag (1:
    the acceptance uniforms, 2: the residual draw, 3: the draft's
    proposals) and the draft index ``j``, each mixed in by another
    splitmix64 round."""
    z = _splitmix64(slot_seed(seed, position) ^ (int(tag) << 32))
    return _splitmix64(z ^ (int(j) & 0xFFFFFFFF)) & ((1 << 63) - 1)


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
    return draw_rows(probs, [slot_seed(s, p) for s, p in
                             zip(_ints(seeds), _ints(positions))])


def truncated_probs(logits, temperature=1.0, top_k=0, top_p=1.0):
    """fp32 probabilities after the same temperature / top-k / top-p
    truncation `sample_logits` applies before its draw: the acceptance
    test compares target and draft probabilities under identical
    truncation, so an accepted or corrected token is distributed as a
    plain truncated sample from the target."""
    return torch.softmax(_truncate_logits(logits.float(), temperature,
                                          top_k, top_p), dim=-1)


def spec_draft_seeds(seeds, positions, j):
    """Generator seeds of the j-th draft proposal of one dispatch, one a
    slot: `spec_seed` at tag 3 (the counterpart of the reference's
    ``spec_draft_keys``)."""
    return [spec_seed(s, p, 3, j)
            for s, p in zip(_ints(seeds), _ints(positions))]


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def draw_rows(probs, gen_seeds):
    """One token a row of ``probs`` [b, vocab] (int32 [b]), row i drawn
    with a generator seeded ``gen_seeds[i]``."""
    out = torch.empty(probs.shape[0], dtype=torch.int64,
                      device=probs.device)
    for i, s in enumerate(gen_seeds):
        out[i] = torch.multinomial(probs[i], 1,
                                   generator=_gen(probs.device, s))[0]
    return out.to(torch.int32)


def spec_accept_greedy(tgt_logits, proposed):
    """Greedy accept / rollback: ``proposed`` [b, k] draft tokens against
    the target's argmax over ``tgt_logits`` [b, k+1, vocab] (row j scored
    the context extended by ``proposed[:, :j]``).

    Returns (accepted [b] int32, next_token [b] int32): the longest
    matching prefix a (0..k) and the target's argmax at a, the
    correction on a mismatch and the bonus token on a full accept. Every
    emitted token is a target argmax over the context plain decoding
    would have had."""
    tgt = torch.argmax(tgt_logits.float(), dim=-1).to(torch.int32)
    match = (proposed.to(torch.int32) == tgt[:, :-1]).to(torch.int32)
    a = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    nxt = torch.gather(tgt, 1, a.long()[:, None])[:, 0]
    return a, nxt


def spec_accept_sampled(tgt_probs, drf_probs, proposed, seeds, positions):
    """Lossless rejection-sampling acceptance.

    tgt_probs: [b, k+1, vocab] target `truncated_probs` at the verify
    positions; drf_probs: [b, k, vocab] the draft's, under the same
    truncation; proposed: [b, k] the draft tokens drawn from them;
    seeds / positions: host arrays, each slot's seed and pre-dispatch
    context length.

    Token j is accepted iff ``u_j * q(d_j) <= p(d_j)`` and ``p(d_j) > 0``
    (u_j uniform on the slot's tag-1 stream: a proposal outside the
    target's truncated support is always rejected); at the first
    rejection a the replacement is drawn from ``normalize(max(p_a - q_a,
    0))`` (tag-2 stream), and a full accept draws the bonus token from
    p_k. An all-zero residual falls back to the target row itself.
    Every emitted token is then distributed as the target's. Returns
    (accepted [b] int32, next_token [b] int32)."""
    b, k1, _ = tgt_probs.shape
    k = k1 - 1
    dev = tgt_probs.device
    pairs = list(zip(_ints(seeds), _ints(positions)))
    u = torch.stack([torch.rand(k, generator=_gen(dev, spec_seed(s, p, 1)),
                                device=dev) for s, p in pairs])
    prop = proposed.long()[..., None]
    p_sel = torch.gather(tgt_probs[:, :k], 2, prop)[..., 0]
    q_sel = torch.gather(drf_probs, 2, prop)[..., 0]
    acc = (u * q_sel <= p_sel) & (p_sel > 0)
    a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    p_row = torch.gather(tgt_probs, 1, a.long()[:, None, None].expand(
        -1, 1, tgt_probs.shape[-1]))[:, 0]
    q_row = torch.gather(drf_probs, 1, a.clamp(max=k - 1).long()
                         [:, None, None].expand(-1, 1, drf_probs.shape[-1]))
    q_row = torch.where((a < k)[:, None], q_row[:, 0], 0.0)
    res = torch.clamp(p_row - q_row, min=0.0)
    norm = res.sum(dim=-1, keepdim=True)
    res = torch.where(norm > 0, res / norm.clamp(min=1e-38), p_row)
    nxt = draw_rows(res, [spec_seed(s, p, 2) for s, p in pairs])
    return a.to(torch.int32), nxt
