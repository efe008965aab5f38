"""The decode stack's steps: generation (prompt prefill, one-token
decode) and serving (chunked prefill, the decode burst), and the
generation engine that drives the first two.

Counterparts of ``PrefillStep``, ``DecodeStep``, ``ChunkPrefillStep``,
``ServeDecodeStep`` and ``GenerationEngine`` in
paddle_tpu/jit/decode_step.py, with the same argument order and return
values. The reference compiles each step once and threads the cache
state through it as pytrees with donated pool buffers; here a step binds
the state onto the engine's cache, runs the model (which updates the
pools in place) and hands the state back. The parameters live in the
model, so the reference's leading ``params`` argument is gone, and the
generation steps take a ``torch.Generator`` (or None for greedy) where
the reference threads a PRNG key.

Where the reference compiles, the steps replay CUDA graphs
(`graphs.StepGraphs`) when the engine is ``compiled`` and its cache
lives on a CUDA device: the serving decode burst unrolled in one graph,
one graph per chunk-prefill bucket, one per prompt bucket of the
generation prefill, and one for the generation decode step, over a dense
or a paged cache. Their inputs are copied into static device tensors
first. Greedy sampling
(``argmax``) is part of the graph; under ``do_sample`` a graph ends at
the logits and the draw runs eagerly after it, one graph a decode step,
since a row's generator is seeded on the host from its (seed, position).
On CPU tensors, or with ``compiled=False``, the steps run eagerly. Each
step's ``trace_count`` counts captures when compiled and calls when
eager, as the reference's traces, and `cache_size` the graphs it holds.

``buffers`` are the cache's pools (``layers`` of a dense cache;
``k_layers`` / ``v_layers`` of a paged one, with ``k_scales`` /
``v_scales`` when it is quantized). ``meta`` is the rest: a dense
cache's ``pos`` (a device int32 scalar, which the steps set and advance
on the device), or the paged host bookkeeping
(``page_tables``, ``seq_lens``, ``active``) as numpy arrays or the
device tensors the previous step returned, which a step copies onto the
cache's device; it returns the updated ``seq_lens`` as a device tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..inference.kv_cache import DenseKVCache, PagedKVCache
from ..nn.functional.sampling import sample_logits, sample_logits_per_slot
from .graphs import StaticInputs, StepGraphs

__all__ = ["GenerationEngine", "PrefillStep", "DecodeStep",
           "ChunkPrefillStep", "ServeDecodeStep", "DEFAULT_PREFILL_BUCKETS",
           "split_state"]

DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

_META_DTYPES = {"page_tables": torch.int32, "seq_lens": torch.int32,
                "active": torch.bool, "pos": torch.int32}
# per cache kind, the state keys that are pool buffers (the rest is
# metadata); presence-filtered, so the scale pools ride with the payload
# exactly when the cache is quantized
_BUFFER_KEYS = {"dense": ("layers",),
                "paged": ("k_layers", "v_layers", "k_scales", "v_scales")}


def split_state(kind, state):
    """(buffers, meta) of a cache ``state()``."""
    keys = [k for k in _BUFFER_KEYS[kind] if k in state]
    return ({k: state[k] for k in keys},
            {k: v for k, v in state.items() if k not in keys})


class _Step:
    def __init__(self, engine):
        self.engine = engine
        self.calls = 0
        self.trace_count = 0   # captures when compiled, calls when eager
        self._graphs = StepGraphs()
        self._static = None

    def cache_size(self):
        """The CUDA graphs this step holds (0 when it runs eagerly)."""
        return len(self._graphs)

    def _compiled(self):
        """Whether this call replays a graph: a ``compiled`` engine over a
        CUDA cache."""
        eng = self.engine
        return getattr(eng, "compiled", False) and \
            eng.cache.device.type == "cuda"

    def _enter(self, buffers, meta):
        cache = self.engine.cache
        state = {**buffers, **meta}
        for name, dtype in _META_DTYPES.items():
            if name in meta:
                state[name] = torch.as_tensor(meta[name], dtype=dtype,
                                              device=cache.device)
        cache.load_state(state)
        self.calls += 1
        self.trace_count += 1
        return cache

    def _exit_state(self):
        cache = self.engine.cache
        return split_state(cache.kind, cache.state())

    # -- the graph path ----------------------------------------------------
    def _bind(self, buffers, meta):
        """Bind the pools and the static copies of ``meta`` onto the
        cache; returns the static inputs."""
        cache = self.engine.cache
        if self._static is None:
            self._static = StaticInputs(cache.device)
        st = self._static
        cache.load_state({**buffers, **meta, **{
            name: st.load(name, meta[name], dtype)
            for name, dtype in _META_DTYPES.items() if name in meta}})
        self.calls += 1
        return st

    def _replay(self, key, body, load, idle):
        """Replay ``key``'s graph of ``body`` (the step over the static
        inputs, which may rebind a paged ``cache.seq_lens``; the graph
        writes the result into the static ``seq_lens``). ``load()`` fills
        the static inputs from this call's arguments; ``idle()`` prepares
        the warm-up run before a capture so that it leaves nothing behind
        that the real step does not overwrite (a paged step's writes go
        to the trash page and no length moves), and may return a callable
        that undoes the rest after the capture (a dense decode's advanced
        position)."""
        cache = self.engine.cache
        load()
        graph = self._graphs.lookup(key, cache)
        if graph is None:
            fn = body
            if cache.kind == "paged":
                sl = cache.seq_lens

                def fn():
                    out = body()
                    sl.copy_(cache.seq_lens)
                    cache.seq_lens = sl
                    return out

            undo = idle()
            graph = self._graphs.capture(key, fn, cache.device)
            if undo is not None:
                undo()
            self.trace_count += 1
            load()
        return graph.replay()

    def _exit_graph(self, meta):
        """The state after a replay: the static ``seq_lens`` (written by
        the graph), and the caller's page tables and active flags (which
        no step changes), so the host bookkeeping reads them without a
        copy back."""
        buffers, out = self._exit_state()
        out.update({k: meta[k] for k in ("page_tables", "active")
                    if k in meta})
        return buffers, out


# ---------------------------------------------------------------------------
# generation steps: one RNG stream for the batch
# ---------------------------------------------------------------------------

class _GenerationStep(_Step):
    def _sample(self, logits, generator):
        eng = self.engine
        if not eng.do_sample:
            generator = None
        return sample_logits(logits, generator, temperature=eng.temperature,
                             top_k=eng.top_k, top_p=eng.top_p)


class PrefillStep(_GenerationStep):
    """Bucketed prompt pass: write every layer's K/V, sample token 0.

    ids: [b, bucket] prompts right-padded to the bucket; lens: [b] true
    prompt lengths (one shared length for the dense cache); slot_ids:
    [b] the rows' slots (paged). On the card of a ``compiled`` engine,
    one graph a prompt bucket: the ids, lengths and slot ids (and a paged
    cache's page tables) are its static inputs. The pass reads no cached
    K/V, so the capture's warm-up run is the real step, which the replay
    repeats."""

    def _logits(self, cache, ids, ln, sid):
        eng = self.engine
        hidden = eng.model.gpt.prefill(ids, cache, seq_lens=ln, slot_ids=sid)
        # the last valid position of each row
        h = hidden.shape[-1]
        last = (ln.long() - 1).clamp(min=0)
        last = torch.gather(hidden, 1, last[:, None, None]
                            .expand(-1, 1, h))[:, 0]
        logits = eng.model.head(last)
        if cache.kind == "dense":
            cache.pos.copy_(ln[0])
        else:
            sl = cache.seq_lens.clone()
            sl[sid.long()] = ln
            cache.seq_lens = sl
        return logits

    @torch.no_grad()
    def __call__(self, buffers, meta, ids, lens, slot_ids, generator=None):
        eng = self.engine
        ids = np.asarray(ids)
        b, bucket = ids.shape
        lens = np.broadcast_to(np.asarray(lens, np.int32).reshape(-1),
                               (b,)).copy()
        slot_ids = np.asarray(slot_ids, np.int32)
        if not self._compiled():
            cache = self._enter(buffers, meta)
            dev = cache.device
            logits = self._logits(
                cache, torch.as_tensor(ids, dtype=torch.int64, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.as_tensor(slot_ids, device=dev))
            ids_next = self._sample(logits, generator)
            return (ids_next, logits) + self._exit_state()
        st = self._bind(buffers, meta)
        cache = eng.cache
        greedy = not eng.do_sample

        def load():
            st.load(f"ids{bucket}", ids, torch.int64)
            st.load("lens", lens, torch.int32)
            st.load("slot_ids", slot_ids, torch.int32)

        def body():
            logits = self._logits(cache, st[f"ids{bucket}"], st["lens"],
                                  st["slot_ids"])
            return (self._sample(logits, None) if greedy else None), logits

        ids_next, logits = self._replay(("prefill", bucket, greedy), body,
                                        load, lambda: None)
        logits = logits.clone()
        ids_next = (ids_next.clone() if greedy
                    else self._sample(logits, generator))
        return (ids_next, logits) + self._exit_graph(meta)


class DecodeStep(_GenerationStep):
    """One-token cached decode step over the whole batch: the dense
    cache advances its shared position (on the device, in place), the
    paged cache the seq_lens of its active slots. Over a CUDA cache of a
    ``compiled`` engine it replays a graph (greedy: the ``argmax`` too);
    the tokens and logits it returns are copies, which the next call
    leaves alone."""

    def _logits(self, cache, cur):
        eng = self.engine
        b = cur.shape[0]
        if cache.kind == "dense":
            pos_ids = cache.pos.reshape(1, 1).expand(b, 1)
        else:
            pos_ids = cache.seq_lens[:, None]
        hidden = eng.model.gpt.decode_step(cur.reshape(b, 1), cache, pos_ids)
        logits = eng.model.head(hidden)[:, 0]               # [b, vocab]
        if cache.kind == "dense":
            cache.pos.add_(1)
        else:
            sl = cache.seq_lens
            cache.seq_lens = torch.where(cache.active, sl + 1, sl)
        return logits

    @torch.no_grad()
    def __call__(self, buffers, meta, tokens, generator=None):
        eng = self.engine
        if not self._compiled():
            cache = self._enter(buffers, meta)
            cur = torch.as_tensor(tokens, device=cache.device).long()
            logits = self._logits(cache, cur)
            ids_next = self._sample(logits, generator)
            return (ids_next, logits) + self._exit_state()
        st = self._bind(buffers, meta)
        cache = eng.cache
        greedy = not eng.do_sample
        paged = cache.kind == "paged"

        def load():
            st.load("tokens", tokens, torch.int64)
            if paged:
                st.load("active", meta["active"], torch.bool)

        def idle():
            if paged:
                st["tokens"].zero_()
                st["active"].zero_()
                return None
            # the warm-up writes the column that the step writes anyway;
            # only the position it advances is put back
            pos = cache.pos.clone()
            return lambda: cache.pos.copy_(pos)

        def body():
            logits = self._logits(cache, st["tokens"])
            return (self._sample(logits, None) if greedy else None), logits

        ids_next, logits = self._replay(("decode", greedy), body, load,
                                        idle)
        logits = logits.clone()
        ids_next = (ids_next.clone() if greedy
                    else self._sample(logits, generator))
        return (ids_next, logits) + self._exit_graph(meta)


# ---------------------------------------------------------------------------
# serving steps: per-slot RNG streams
# ---------------------------------------------------------------------------

class _ServingStep(_Step):
    def _sample(self, logits, seeds, positions, greedy=None):
        eng = self.engine
        return sample_logits_per_slot(
            logits, seeds, positions, temperature=eng.temperature,
            top_k=eng.top_k, top_p=eng.top_p,
            greedy=not eng.do_sample if greedy is None else greedy)


class ChunkPrefillStep(_ServingStep):
    """One bounded chunk of up to ``prefill_batch`` prompts: write each
    chunk's K/V at positions [start, start+c) of its slot, attending
    over the context cached so far, and sample the prefill-complete
    token with the request's own RNG stream. The sampled token only
    means something when this was the prompt's final chunk; the host
    discards it otherwise. Compiled on the card, one graph a chunk
    bucket (the ids' width); its outputs hold until the next call.

    Rows whose slot id is ``max_slots`` are the engine's padding rows.
    The reference handles that out-of-range id silently: its page-table
    gather clamps it to the last row and its seq_lens scatter drops it.
    Torch raises on both, so both are spelled out here (the gather in
    ``kv_cache.slot_rows``, the drop below)."""

    def _logits(self, cache, ids, sid, st, ln):
        eng = self.engine
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
        return logits

    @torch.no_grad()
    def __call__(self, buffers, meta, ids, slot_ids, start, lens_new,
                 seeds):
        eng = self.engine
        if not self._compiled():
            cache = self._enter(buffers, meta)
            dev = cache.device
            logits = self._logits(
                cache, torch.as_tensor(ids, dtype=torch.int64, device=dev),
                torch.as_tensor(slot_ids, dtype=torch.int32, device=dev),
                torch.as_tensor(start, dtype=torch.int32, device=dev),
                torch.as_tensor(lens_new, dtype=torch.int32, device=dev))
            # the sample position is the context length after this chunk,
            # as at decode: a preempted request's re-prefill resumes its
            # stream
            ids_next = self._sample(logits, seeds, lens_new)
            return (ids_next, logits) + self._exit_state()
        st = self._bind(buffers, meta)
        cache = eng.cache
        bucket = np.shape(ids)[1]
        greedy = not eng.do_sample
        names = ("slot_ids", "start", "lens_new")

        def load():
            st.load(f"ids{bucket}", ids, torch.int64)
            for name, value in zip(names, (slot_ids, start, lens_new)):
                st.load(name, value, torch.int32)

        def idle():
            # every row padding: writes to the trash page, no length moves
            st[f"ids{bucket}"].zero_()
            st["slot_ids"].fill_(cache.max_slots)
            st["start"].zero_()
            st["lens_new"].zero_()

        def body():
            logits = self._logits(cache, st[f"ids{bucket}"],
                                  *(st[n] for n in names))
            return (self._sample(logits, None, None, greedy=True)
                    if greedy else None), logits

        ids_next, logits = self._replay(("chunk", bucket, greedy), body,
                                        load, idle)
        if not greedy:
            ids_next = self._sample(logits, seeds, lens_new)
        return (ids_next, logits) + self._exit_graph(meta)


class ServeDecodeStep(_ServingStep):
    """``decode_burst`` one-token decode steps over the full slot batch.
    Sampling uses per-slot RNG streams keyed on (seed, context length),
    so a request's tokens never depend on its batch neighbours. Inactive
    slots (free, or still chunk-prefilling) write to the trash page,
    attend nothing and keep their seq_lens; their samples are discarded
    by the host. A slot whose request finishes mid-burst saturates its
    seq_len at the engine window and writes on the trash page. Compiled
    on the card, a greedy burst is one graph and a sampled burst one
    graph a step with the draw between; the outputs hold until the next
    call."""

    def _logits(self, cache, cur):
        eng = self.engine
        b = cur.shape[0]
        hidden = eng.model.gpt.decode_step(
            cur.reshape(b, 1), cache, cache.seq_lens[:, None])
        logits = eng.model.head(hidden)[:, 0]                # [b, vocab]
        sl = cache.seq_lens
        cache.seq_lens = torch.where(
            cache.active, torch.clamp(sl + 1, max=eng.max_len), sl)
        return logits

    @torch.no_grad()
    def __call__(self, buffers, meta, tokens, seeds):
        eng = self.engine
        k = eng.decode_burst
        if not self._compiled():
            cache = self._enter(buffers, meta)
            cur = torch.as_tensor(tokens, dtype=torch.int32,
                                  device=cache.device)
            toks = []
            for _ in range(k):
                logits = self._logits(cache, cur)
                cur = self._sample(logits, seeds, cache.seq_lens)
                toks.append(cur)
            return (torch.stack(toks), logits) + self._exit_state()
        st = self._bind(buffers, meta)
        cache = eng.cache

        def load():
            st.load("tokens", tokens, torch.int32)
            st.load("active", meta["active"], torch.bool)

        def idle():
            st["tokens"].zero_()
            st["active"].zero_()

        if not eng.do_sample:
            def burst():
                cur, toks = st["tokens"], []
                for _ in range(k):
                    logits = self._logits(cache, cur)
                    cur = self._sample(logits, None, None)
                    toks.append(cur)
                return torch.stack(toks), logits

            out, logits = self._replay(("burst", k), burst, load, idle)
            return (out, logits) + self._exit_graph(meta)
        toks = []
        for i in range(k):
            logits = self._replay(
                ("step",), lambda: self._logits(cache, st["tokens"]),
                load if i == 0 else (lambda: None), idle)
            cur = self._sample(logits, seeds, cache.seq_lens)
            st["tokens"].copy_(cur)
            toks.append(cur)
        return (torch.stack(toks), logits) + self._exit_graph(meta)


# ---------------------------------------------------------------------------
# the generation engine
# ---------------------------------------------------------------------------

class GenerationEngine:
    """Prefill + decode over one (model, cache) pair.

    ``kind`` picks the cache: "dense" (aligned batch, one shared write
    position) or "paged" (ragged prompt lengths, page pools, optionally
    ``kv_quant="int8"|"int4"``). `generate()` runs prompt -> tokens end
    to end. With ``compiled`` (the default) a cache on a CUDA device,
    dense or paged, runs its prompt pass (one graph a prompt bucket) and
    its decode steps (one graph) as CUDA graph replays. ``donate`` is
    accepted and does nothing: the steps update
    the cache in place. Speculative decoding (``draft_model``) is not
    ported yet."""

    def __init__(self, model, kind="dense", batch=1, max_len=128,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 compiled=True, cache_dtype=None, page_size=16,
                 prefill_buckets=DEFAULT_PREFILL_BUCKETS, donate=True,
                 draft_model=None, spec_k=4, kv_quant=None):
        del donate, spec_k
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len={max_len} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        if kind not in ("dense", "paged"):
            raise ValueError(f"unknown cache kind {kind!r}")
        if kv_quant is not None and kind != "paged":
            raise ValueError(
                "kv_quant needs the paged cache (use_cache='paged')")
        if draft_model is not None:
            raise NotImplementedError(
                "GenerationEngine(draft_model=...) is not ported yet: "
                "ROADMAP queue A6 (speculative decoding)")
        self.model = model
        self.device = next(model.parameters()).device
        self.compiled = bool(compiled)
        self.kind = kind
        self.batch = batch
        self.max_len = max_len
        self.do_sample = bool(do_sample)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        # the buckets must cover max_len: a prompt between the largest
        # power-of-two bucket and max_len is within capacity
        buckets = tuple(sorted(bkt for bkt in prefill_buckets
                               if bkt <= max_len))
        if not buckets or buckets[-1] < max_len:
            buckets = buckets + (max_len,)
        self.prefill_buckets = buckets
        self._cache_dtype = cache_dtype or torch.float32
        self._page_size = page_size
        self.kv_quant = kv_quant
        self.cache = self._make_cache()
        self.prefill_step = PrefillStep(self)
        self.decode_step = DecodeStep(self)

    def _make_cache(self):
        """A fresh cache of this engine's geometry; also the recovery
        path when a failed generate leaves the pools half written."""
        cfg = self.model.config
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        if self.kind == "dense":
            return DenseKVCache(cfg.num_layers, self.batch, self.max_len,
                                nh, hd, dtype=self._cache_dtype,
                                device=self.device)
        pages_per_seq = -(-self.max_len // self._page_size)
        return PagedKVCache(
            cfg.num_layers, nh, hd,
            num_pages=1 + self.batch * pages_per_seq,
            page_size=self._page_size, max_slots=self.batch,
            pages_per_seq=pages_per_seq, dtype=self._cache_dtype,
            quant=self.kv_quant, device=self.device)

    def _bucket(self, s):
        for bkt in self.prefill_buckets:
            if bkt >= s:
                return bkt
        raise ValueError(
            f"prompt length {s} exceeds the largest prefill bucket "
            f"{self.prefill_buckets[-1]} (max_len {self.max_len})")

    def generate(self, input_ids, max_new_tokens, seq_lens=None,
                 eos_token_id=None, seed=None, return_logits=False):
        """input_ids: [batch, prompt] ints (right-padded when ``seq_lens``
        gives ragged true lengths: paged cache only). Returns an int32
        CPU tensor [batch, max_new_tokens], and with ``return_logits``
        also the fp32 CPU logits [batch, max_new_tokens, vocab] behind
        each token. Sampling draws from one ``torch.Generator`` seeded
        with ``seed`` (None: a seed from torch's global generator)."""
        ids = np.asarray(input_ids)
        b, s = ids.shape
        max_new_tokens = int(max_new_tokens)
        if b != self.batch:
            raise ValueError(f"engine batch {self.batch}, got {b}")
        if s + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {s} + {max_new_tokens} new tokens exceeds the "
                f"engine max_len {self.max_len}")
        cache = self.cache
        lens = (np.full((b,), s, np.int32) if seq_lens is None
                else np.asarray(seq_lens, np.int32).reshape(b))
        slots = list(range(b))
        if self.kind == "dense":
            if len(set(lens.tolist())) > 1:
                raise ValueError(
                    "the dense cache needs an aligned batch (one shared "
                    "prompt length); use use_cache='paged' for ragged "
                    "prompts")
            cache.pos.zero_()
        else:
            # fresh slots for this batch, lowest first: row i is slot i
            for slot in list(cache._slot_pages):
                cache.free(slot)
            slots = [cache.allocate(int(n)) for n in lens]
        bucket = self._bucket(s)
        if bucket > s:
            ids = np.concatenate(
                [ids, np.zeros((b, bucket - s), ids.dtype)], axis=1)
        gen = None
        if self.do_sample:
            if seed is None:
                seed = int(torch.randint(0, 2 ** 62, ()).item())
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        buffers, meta = split_state(self.kind, cache.state())
        try:
            tok, logits, buffers, meta = self.prefill_step(
                buffers, meta, ids, lens, np.asarray(slots, np.int32), gen)
            toks, logit_steps = [tok], [logits]
            cur = lens.copy()
            for _ in range(max_new_tokens - 1):
                if self.kind == "paged":
                    # grow the page tables on demand (host bookkeeping)
                    for j, slot in enumerate(slots):
                        cache.reserve(slot, int(cur[j]) + 1)
                    meta["page_tables"] = cache.page_tables
                tok, logits, buffers, meta = self.decode_step(
                    buffers, meta, tok, gen)
                toks.append(tok)
                if return_logits:
                    logit_steps.append(logits)
                cur += 1
            cache.load_state({**buffers, **meta})
            out = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
        except BaseException:
            # a failed step may leave the pools half written
            self.cache = self._make_cache()
            raise
        if self.kind == "paged":
            for slot in slots:
                cache.free(slot)
        if eos_token_id is not None:
            done = np.zeros((b,), bool)
            for t in range(out.shape[1]):
                out[done, t] = eos_token_id
                done |= out[:, t] == eos_token_id
        out_t = torch.from_numpy(out)
        if return_logits:
            return out_t, torch.stack(logit_steps, dim=1).float().cpu()
        return out_t
