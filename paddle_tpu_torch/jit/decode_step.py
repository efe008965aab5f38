"""The serving engine's two steps: chunked prefill and the decode burst.

Counterparts of ``ChunkPrefillStep`` and ``ServeDecodeStep`` in
paddle_tpu/jit/decode_step.py, with the same argument order and return
values, run eagerly. The reference compiles each step once and threads
the cache state through it as pytrees with donated pool buffers; here a
step binds the state onto the engine's cache, runs the model (which
updates the pools in place) and hands the state back. The parameters
live in the model, so the reference's leading ``params`` argument is
gone.

``meta`` is the host bookkeeping (``page_tables``, ``seq_lens``,
``active``) as numpy arrays or the device tensors the previous step
returned; a step copies it onto the cache's device, and returns the
updated ``seq_lens`` as a device tensor.
"""
from __future__ import annotations

import torch

from ..nn.functional.sampling import sample_logits_per_slot

__all__ = ["ChunkPrefillStep", "ServeDecodeStep"]

_META_DTYPES = {"page_tables": torch.int32, "seq_lens": torch.int32,
                "active": torch.bool}


class _Step:
    def __init__(self, engine):
        self.engine = engine
        self.calls = 0

    def _enter(self, buffers, meta):
        cache = self.engine.cache
        dev = cache.device
        state = dict(buffers)
        for name, dtype in _META_DTYPES.items():
            state[name] = torch.as_tensor(meta[name], dtype=dtype,
                                          device=dev)
        cache.load_state(state)
        self.calls += 1
        return cache

    def _exit_state(self):
        state = self.engine.cache.state()
        buffers = {k: state[k] for k in ("k_layers", "v_layers")}
        meta = {k: state[k] for k in _META_DTYPES}
        return buffers, meta

    def _sample(self, logits, seeds, positions):
        eng = self.engine
        return sample_logits_per_slot(
            logits, seeds, positions, temperature=eng.temperature,
            top_k=eng.top_k, top_p=eng.top_p, greedy=not eng.do_sample)


class ChunkPrefillStep(_Step):
    """One bounded chunk of up to ``prefill_batch`` prompts: write each
    chunk's K/V at positions [start, start+c) of its slot, attending
    over the context cached so far, and sample the prefill-complete
    token with the request's own RNG stream. The sampled token only
    means something when this was the prompt's final chunk; the host
    discards it otherwise.

    Rows whose slot id is ``max_slots`` are the engine's padding rows.
    The reference handles that out-of-range id silently: its page-table
    gather clamps it to the last row and its seq_lens scatter drops it.
    Torch raises on both, so both are spelled out here (the gather in
    ``kv_cache.slot_rows``, the drop below)."""

    @torch.no_grad()
    def __call__(self, buffers, meta, ids, slot_ids, start, lens_new,
                 seeds):
        eng = self.engine
        cache = self._enter(buffers, meta)
        dev = cache.device
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        sid = torch.as_tensor(slot_ids, dtype=torch.int32, device=dev)
        st = torch.as_tensor(start, dtype=torch.int32, device=dev)
        ln = torch.as_tensor(lens_new, dtype=torch.int32, device=dev)
        hidden = eng.model.gpt.prefill_chunk(ids, cache, sid, st, ln)
        # last valid chunk position per row (a padding row's -1 clamps
        # to 0; its logits are discarded)
        last = (ln - st - 1).clamp(min=0).long()
        h = hidden.shape[-1]
        last = torch.gather(hidden, 1,
                            last[:, None, None].expand(-1, 1, h))[:, 0]
        logits = eng.model.head(last)
        # seq_lens[slot_ids] = lens_new, dropping padding rows: they land
        # on an extra entry that is cut off again
        n = cache.max_slots
        sl = torch.cat([cache.seq_lens, cache.seq_lens.new_zeros(1)])
        sl[sid.clamp(max=n).long()] = ln
        cache.seq_lens = sl[:n]
        # the sample position is the context length after this chunk, as
        # at decode: a preempted request's re-prefill resumes its stream
        ids_next = self._sample(logits, seeds, lens_new)
        return (ids_next, logits) + self._exit_state()


class ServeDecodeStep(_Step):
    """``decode_burst`` one-token decode steps over the full slot batch.
    Sampling uses per-slot RNG streams keyed on (seed, context length),
    so a request's tokens never depend on its batch neighbours. Inactive
    slots (free, or still chunk-prefilling) write to the trash page,
    attend nothing and keep their seq_lens; their samples are discarded
    by the host. A slot whose request finishes mid-burst saturates its
    seq_len at the engine window and writes on the trash page."""

    @torch.no_grad()
    def __call__(self, buffers, meta, tokens, seeds):
        eng = self.engine
        cache = self._enter(buffers, meta)
        cur = torch.as_tensor(tokens, dtype=torch.int32, device=cache.device)
        b = cur.shape[0]
        toks = []
        for _ in range(eng.decode_burst):
            hidden = eng.model.gpt.decode_step(
                cur.reshape(b, 1), cache, cache.seq_lens[:, None])
            logits = eng.model.head(hidden)[:, 0]            # [b, vocab]
            sl = cache.seq_lens
            new_sl = torch.where(cache.active,
                                 torch.clamp(sl + 1, max=eng.max_len), sl)
            cache.seq_lens = new_sl
            cur = self._sample(logits, seeds, new_sl)
            toks.append(cur)
        return (torch.stack(toks), logits) + self._exit_state()
