"""The decode stack's steps: generation (prompt prefill, one-token
decode) and serving (chunked prefill, the decode burst), speculative
decoding for both, and the generation engine that drives them.

Counterparts of ``PrefillStep``, ``DecodeStep``, ``ChunkPrefillStep``,
``ServeDecodeStep``, ``SpecDecodeStep``, ``ServeSpecDecodeStep``,
``SelfDraftProposer`` and ``GenerationEngine`` in
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
generation prefill, one for the generation decode step, over a dense
or a paged cache, and one for a greedy speculative dispatch. Their
inputs are copied into static device tensors first. Greedy sampling
(``argmax``) is part of the graph; under ``do_sample`` a graph ends at
the logits and the draw runs eagerly after it, one graph a decode step,
since a row's generator is seeded on the host from its (seed, position).
On CPU tensors, or with ``compiled=False``, the steps run eagerly. Each
step's ``trace_count`` counts captures when compiled and calls when
eager, as the reference's traces, and `cache_size` the graphs it holds.

With a draft model (speculative decoding) the prompt passes also fill
the draft's cache, whose pools live on the engine (``draft_cache``)
and whose page tables are the target's: they are not threaded through
the steps.

``buffers`` are the cache's pools (``layers`` of a dense cache;
``k_layers`` / ``v_layers`` of a paged one, with ``k_scales`` /
``v_scales`` when it is quantized). ``meta`` is the rest: a dense
cache's ``pos`` (a device int32 scalar, which the steps set and advance
on the device; a ``[b]`` vector for the speculative step, whose rows
advance by their own counts), or the paged host bookkeeping
(``page_tables``, ``seq_lens``, ``active``) as numpy arrays or the
device tensors the previous step returned, which a step copies onto the
cache's device; it returns the updated ``seq_lens`` as a device tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..inference.kv_cache import DenseKVCache, PagedKVCache
from ..nn.functional.sampling import (draw_rows, sample_logits,
                                     sample_logits_per_slot,
                                     spec_accept_greedy,
                                     spec_accept_sampled, spec_draft_seeds,
                                     truncated_probs)
from .graphs import StaticInputs, StepGraphs

__all__ = ["GenerationEngine", "PrefillStep", "DecodeStep",
           "ChunkPrefillStep", "ServeDecodeStep", "SpecDecodeStep",
           "ServeSpecDecodeStep", "SelfDraftProposer",
           "DEFAULT_PREFILL_BUCKETS", "split_state"]

DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

_META_DTYPES = {"page_tables": torch.int32, "seq_lens": torch.int32,
                "active": torch.bool, "pos": torch.int32}
# per cache kind, the state keys that are pool buffers (the rest is
# metadata); presence-filtered, so the scale pools ride with the payload
# exactly when the cache is quantized
_BUFFER_KEYS = {"dense": ("layers",),
                "paged": ("k_layers", "v_layers", "k_scales", "v_scales")}


class SelfDraftProposer:
    """The target's own draft heads (``GPTConfig.num_draft_heads``) as
    the proposer: k tokens from one target decode step, so speculative
    decoding needs no second checkpoint and no draft cache. The engines
    take ``draft_model="self"`` for it. It has the draft's face
    (``gpt``, ``config``) and owns no parameters and no cache."""

    is_self_draft = True

    def __init__(self, model):
        if getattr(model, "draft_heads", None) is None:
            raise ValueError(
                "draft_model='self' needs a target built with "
                "GPTConfig.num_draft_heads > 0")
        self.model = model

    @property
    def gpt(self):
        return self.model.gpt

    @property
    def config(self):
        return self.model.config

    def parameters(self):
        return []


def _draft_of(model, draft_model):
    """The engines' ``draft_model`` argument as a draft: "self" becomes a
    `SelfDraftProposer` of ``model``; any other string is refused."""
    if isinstance(draft_model, str):
        if draft_model != "self":
            raise ValueError(f"unknown draft_model {draft_model!r} (the only "
                             "string form is 'self')")
        return SelfDraftProposer(model)
    return draft_model


def check_draft(model, draft_model, spec_k, device):
    """The reference's checks of a (target, draft, spec_k) triple, and the
    port's own: a draft model lives on the target's device."""
    cfg = model.config
    if getattr(draft_model, "is_self_draft", False):
        if spec_k > cfg.num_draft_heads:
            raise ValueError(f"spec_k={spec_k} exceeds the target's "
                             f"num_draft_heads={cfg.num_draft_heads}")
    else:
        draft_model.gpt._check_decodable()
        if draft_model.config.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model vocab_size {draft_model.config.vocab_size} != "
                f"target {cfg.vocab_size} (proposals must be target ids)")
        where = next(draft_model.parameters()).device
        if where != device:
            raise ValueError(f"the draft model lives on {where}, the "
                             f"engine on {device}")
    if spec_k < 1:
        raise ValueError("spec_k must be >= 1")


def draft_cache_like(engine, dense_len=None):
    """The draft's cache over the target's geometry: a paged cache of the
    target's pages, slots and pages a slot (the page tables are the
    target's), or a dense cache ``dense_len`` long; never quantized (a
    noisy draft costs accept rate, a noisy target output quality)."""
    dcfg = engine.draft_model.config
    nh = dcfg.num_attention_heads
    hd = dcfg.hidden_size // nh
    c = engine.cache
    if c.kind == "dense":
        return DenseKVCache(dcfg.num_layers, c.batch, dense_len, nh, hd,
                            dtype=engine._cache_dtype, device=engine.device)
    return PagedKVCache(dcfg.num_layers, nh, hd, num_pages=c.num_pages,
                        page_size=c.page_size, max_slots=c.max_slots,
                        pages_per_seq=c.pages_per_seq,
                        dtype=engine._cache_dtype, device=engine.device)


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
        dcache = getattr(eng, "draft_cache", None)
        if dcache is not None:
            # the draft's cache over the same prompt and slots, so the
            # first speculative dispatch drafts from a whole context
            if cache.kind == "paged":
                dcache.page_tables = cache.page_tables
            eng.draft_model.gpt.prefill(ids, dcache, seq_lens=ln,
                                        slot_ids=sid)
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
        dcache = getattr(eng, "draft_cache", None)
        if dcache is not None:
            # the same chunk into the draft's pools (same slots and
            # positions, the target's page tables)
            dcache.page_tables = cache.page_tables
            eng.draft_model.gpt.prefill_chunk(ids, dcache, sid, st, ln)
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
# speculative decoding: draft k, verify once
# ---------------------------------------------------------------------------

class SpecDecodeStep(_Step):
    """One speculative dispatch over the whole batch: the draft proposes
    k tokens a slot, the target scores all k+1 positions in one
    multi-token pass (`GPTModel.prefill_chunk`: the paged chunk kernels,
    or the dense cache's attention), and acceptance is bookkeeping on the
    device, so one dispatch and one host read give 1 to k+1 tokens a
    slot.

    With a slot's context length sl0 and its incoming token t0 (sampled
    by the last dispatch, not cached yet):

    1. draft: k+1 one-token decodes over the draft's cache (the target's
       page tables, the draft's pools); iteration j writes the j-th
       context token's K/V at sl0+j and proposes d_{j+1}; the last only
       writes d_k's K/V, so a full accept leaves no hole at sl0+k. Rows
       past the window are turned off (paged: their writes go to the
       trash page). A self-draft (`SelfDraftProposer`) runs one target
       decode on t0 instead and takes the k proposals from the draft
       heads off h(t0).
    2. verify: the target's ``prefill_chunk`` over [t0, d_1..d_k] up to
       each slot's ``caps`` (rows at or past it: trash page or dropped).
    3. accept: `spec_accept_greedy` (the longest argmax-matching prefix:
       the tokens of plain greedy decoding) or `spec_accept_sampled`
       (rejection sampling with the residual correction). The new
       lengths are ``min(sl0 + 1 + a, caps)`` on active slots; what lies
       past them is masked by every later read and overwritten by the
       next dispatch.

    tokens: [b] t0; seeds: [b] host ints (sampling); caps: [b] host ints,
    each slot's length bound (the context plus the tokens it may still
    take); positions: [b] host ints, the pre-dispatch lengths (required
    when sampling: they key the streams). Returns (tokens [b, k+1],
    counts [b], logits [b, k+1, vocab], buffers, meta): ``tokens[:,
    :counts]`` are the emitted tokens and logits row t the target's row
    behind the t-th of them. Over a dense cache ``meta["pos"]`` is a [b]
    vector.

    Over the serving engine's slot batch every slot is a row: inactive
    ones (free, or still chunk-prefilling) propose onto the trash page
    and keep their lengths (their caps are their current lengths), and
    the scheduler sees only each slot's yield.

    Compiled on the card, a greedy dispatch is one CUDA graph (the draft,
    the verify, the accept and the length updates); a sampled dispatch
    replays one graph a draft iteration (the same graph, its index a
    static input) and one for the verify, with the draws between them,
    seeded on the host. The paged warm-up of a capture runs with every
    slot inactive and every cap 0 (all writes to the trash page); a
    dense warm-up writes only the columns the real dispatch writes, and
    its positions are put back after the capture."""

    # the draft's and the target's geometry
    def _state(self, cache, b):
        eng = self.engine
        if cache.kind == "paged":
            return (cache.seq_lens, cache.active,
                    cache.pages_per_seq * cache.page_size)
        dcache = eng.draft_cache
        act = torch.ones(b, dtype=torch.bool, device=cache.device)
        return cache.pos, act, (dcache.max_len if dcache is not None
                                else cache.max_len)

    def _draft_hidden(self, cache, cur, dsl, act, limit):
        """One decode of the draft model at positions ``dsl`` [b]."""
        eng = self.engine
        dcache = eng.draft_cache
        ok = act & (dsl < limit)
        if cache.kind == "paged":
            dcache.page_tables = cache.page_tables
            dcache.seq_lens = dsl
            dcache.active = ok
        else:
            dcache.pos = dsl
        mpe = eng.draft_model.config.max_position_embeddings
        return eng.draft_model.gpt.decode_step(
            cur[:, None], dcache, torch.clamp(dsl, max=mpe - 1)[:, None])

    def _self_draft_logits(self, cache, cur, sl0, act, caps, limit):
        """The draft heads' logits [b, k, vocab] off one target decode on
        ``cur`` at ``sl0`` (rows at or past their cap write nothing
        real)."""
        eng = self.engine
        if cache.kind == "paged":
            cache.active = act & (sl0 < torch.clamp(caps, max=limit))
        mpe = eng.model.config.max_position_embeddings
        hidden = eng.model.gpt.decode_step(
            cur[:, None], cache, torch.clamp(sl0, max=mpe - 1)[:, None])
        if cache.kind == "paged":
            cache.active = act
        return eng.model.draft_logits(hidden)[:, 0, :eng.spec_k]

    def _verify(self, cache, ver, sl0, caps):
        eng = self.engine
        b = ver.shape[0]
        slots = torch.arange(b, dtype=torch.int32, device=ver.device)
        return eng.model.head(eng.model.gpt.prefill_chunk(
            ver, cache, slots, sl0, caps))

    @staticmethod
    def _finish(cache, sl0, act, caps, proposed, a, nxt):
        """(tokens, counts) of the accepted prefix and the correction or
        bonus token; the new lengths into the cache's position buffer."""
        new_sl = torch.where(act, torch.minimum(sl0 + 1 + a, caps), sl0)
        counts = new_sl - sl0
        toks = torch.cat([proposed, torch.zeros_like(proposed[:, :1])], 1)
        toks.scatter_(1, a.long()[:, None], nxt[:, None])
        if cache.kind == "paged":
            cache.seq_lens = new_sl
        else:
            cache.pos.copy_(new_sl)
        return toks, counts

    def _greedy(self, cache, t0, caps):
        """The whole greedy dispatch over device tensors."""
        eng = self.engine
        b = t0.shape[0]
        sl0, act, limit = self._state(cache, b)
        caps = torch.clamp(caps, max=eng.max_len)
        if getattr(eng.draft_model, "is_self_draft", False):
            heads = self._self_draft_logits(cache, t0, sl0, act, caps, limit)
            proposed = torch.argmax(heads.float(), dim=-1).to(torch.int32)
        else:
            cur, prop = t0, []
            for j in range(eng.spec_k + 1):
                hidden = self._draft_hidden(cache, cur, sl0 + j, act, limit)
                if j == eng.spec_k:
                    break                # write-only: d_k's K/V
                cur = torch.argmax(eng.draft_model.head(hidden)[:, 0].float(),
                                   dim=-1).to(torch.int32)
                prop.append(cur)
            proposed = torch.stack(prop, dim=1)
        logits = self._verify(cache, torch.cat([t0[:, None], proposed], 1),
                              sl0, caps)
        a, nxt = spec_accept_greedy(logits, proposed)
        toks, counts = self._finish(cache, sl0, act, caps, proposed, a, nxt)
        return toks, counts, logits

    def _run(self, key, body, load, idle):
        if self._compiled():
            return self._replay(key, body, load, idle)
        load()
        return body()

    def _idle(self, cache, st, zero):
        """The capture warm-up's inputs (see the class docstring)."""
        if cache.kind == "paged":
            st["active"].zero_()
            for name in zero:
                st[name].zero_()
            return None
        pos = cache.pos.clone()
        return lambda: cache.pos.copy_(pos)

    @torch.no_grad()
    def __call__(self, buffers, meta, tokens, seeds, caps, positions=None):
        eng = self.engine
        st = self._bind(buffers, meta)
        if not self._compiled():
            self.trace_count += 1
        cache = eng.cache
        paged = cache.kind == "paged"
        kk = eng.spec_k

        def load():
            st.load("tokens", tokens, torch.int32)
            st.load("caps", caps, torch.int32)
            if paged:
                st.load("active", meta["active"], torch.bool)

        if not eng.do_sample:
            toks, counts, logits = self._run(
                ("spec", kk, True),
                lambda: self._greedy(cache, st["tokens"], st["caps"]),
                load, lambda: self._idle(cache, st, ("tokens", "caps")))
            return (toks, counts, logits) + self._exit_graph(meta)
        b = np.shape(tokens)[0]
        self_draft = getattr(eng.draft_model, "is_self_draft", False)

        def probs(logits):
            return truncated_probs(logits, eng.temperature, eng.top_k,
                                   eng.top_p)

        prop, qprobs = [], []
        if self_draft:
            def heads():
                sl0, act, limit = self._state(cache, b)
                return self._self_draft_logits(
                    cache, st["tokens"], sl0, act,
                    torch.clamp(st["caps"], max=eng.max_len), limit)

            logits = self._run(("spec_self",), heads, load,
                               lambda: self._idle(cache, st, ("tokens",)))
            for j in range(kk):
                qprobs.append(probs(logits[:, j]))
                prop.append(draw_rows(qprobs[-1], spec_draft_seeds(
                    seeds, positions, j)))
        else:
            def draft():
                sl0, act, limit = self._state(cache, b)
                hidden = self._draft_hidden(cache, st["cur"],
                                            sl0 + st["j"], act, limit)
                return eng.draft_model.head(hidden)[:, 0]

            def load_first():
                load()
                st.load("cur", tokens, torch.int32)
                st.load("j", np.zeros(1, np.int32), torch.int32)

            for j in range(kk + 1):
                if j:
                    st["j"].fill_(j)
                    st["cur"].copy_(prop[-1])
                logits = self._run(
                    ("spec_draft",), draft,
                    load_first if j == 0 else (lambda: None),
                    lambda: self._idle(cache, st, ("cur",)))
                if j == kk:
                    break                 # write-only: d_k's K/V
                qprobs.append(probs(logits))
                prop.append(draw_rows(qprobs[-1], spec_draft_seeds(
                    seeds, positions, j)))
        proposed = torch.stack(prop, dim=1)
        ver = torch.cat([st["tokens"][:, None], proposed], 1)

        def verify():
            sl0, _, _ = self._state(cache, b)
            return self._verify(cache, st["ver"], sl0,
                                torch.clamp(st["caps"], max=eng.max_len))

        def load_verify():
            load()
            st.load("ver", ver, torch.int32)

        logits = self._run(("spec_verify", kk), verify, load_verify,
                           lambda: self._idle(cache, st, ("caps",)))
        a, nxt = spec_accept_sampled(probs(logits), torch.stack(qprobs, 1),
                                     proposed, seeds, positions)
        sl0, act, _ = self._state(cache, b)
        toks, counts = self._finish(cache, sl0, act,
                                    torch.clamp(st["caps"], max=eng.max_len),
                                    proposed, a, nxt)
        if paged:
            # the lengths back into the buffer the step's graphs read
            st["seq_lens"].copy_(cache.seq_lens)
            cache.seq_lens = st["seq_lens"]
        return (toks, counts, logits) + self._exit_graph(meta)


# the serving engine's spec step, the reference's name for it
ServeSpecDecodeStep = SpecDecodeStep


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
    the cache in place.

    ``draft_model`` (a GPT of the target's vocab, or "self": the target's
    draft heads) makes the decode loop speculative: `SpecDecodeStep`
    dispatches of ``spec_k`` proposals each, greedy tokens those of plain
    decoding. A separate draft gets a cache of the target's geometry
    (`draft_cache_like`; dense: ``spec_k + 1`` rows longer, the draft
    runs that far ahead at the window's end), which the prompt pass
    fills too."""

    def __init__(self, model, kind="dense", batch=1, max_len=128,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 compiled=True, cache_dtype=None, page_size=16,
                 prefill_buckets=DEFAULT_PREFILL_BUCKETS, donate=True,
                 draft_model=None, spec_k=4, kv_quant=None):
        del donate
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
        draft_model = _draft_of(model, draft_model)
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
        self.draft_model = draft_model
        self.spec_k = int(spec_k)
        self.cache = self._make_cache()
        self.draft_cache = self.spec_step = None
        self.spec_stats = {}
        if draft_model is not None:
            check_draft(model, draft_model, self.spec_k, self.device)
            self.draft_cache = self._make_draft_cache()
            self.spec_step = SpecDecodeStep(self)
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

    def _make_draft_cache(self):
        """The draft's fresh cache (None for a self-draft)."""
        if getattr(self.draft_model, "is_self_draft", False):
            return None
        return draft_cache_like(self, self.max_len + self.spec_k + 1)

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
            if self.spec_step is not None:
                out, logit_rows, buffers, meta = self._spec_loop(
                    tok, logits, buffers, meta, lens, slots, max_new_tokens,
                    seed, return_logits)
            else:
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
                out = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
                logit_rows = torch.stack(logit_steps, dim=1) \
                    if return_logits else None
            cache.load_state({**buffers, **meta})
        except BaseException:
            # a failed step may leave the pools half written: both caches
            # start again
            self.cache = self._make_cache()
            self.draft_cache = self._make_draft_cache() \
                if self.draft_model is not None else None
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
            return out_t, logit_rows.float().cpu()
        return out_t

    def _spec_loop(self, tok, logits, buffers, meta, lens, slots, mnt, seed,
                   return_logits):
        """The host side of speculative generation: `SpecDecodeStep`
        dispatches until every row has ``mnt`` tokens, each row taking its
        own yield (1 to spec_k + 1; a row that is done takes 0 through its
        cap). One host read a dispatch (tokens and counts together; the
        logits too with ``return_logits``). Returns (tokens [b, mnt],
        logits [b, mnt, vocab] or None, buffers, meta). The call's
        dispatches, usable proposals (each row's lookahead - 1), accepted
        proposals and emitted tokens are left in `spec_stats`."""
        b = len(slots)
        stats = self.spec_stats = dict.fromkeys(
            ("dispatches", "proposed", "accepted", "emitted"), 0)
        first = tok.cpu().numpy().astype(np.int32).reshape(b)
        outs = [[int(t)] for t in first]
        rows = [[logits[i]] for i in range(b)] if return_logits else None
        # the acceptance streams' seeds, from the generation's seed
        seeds = (np.random.default_rng(seed).integers(
                     0, 2 ** 31 - 1, b).astype(np.uint32)
                 if self.do_sample else np.zeros(b, np.uint32))
        cur = first.copy()
        # cached length = prompt + emitted - 1: the latest token is the
        # next dispatch's verify row 0
        sl = lens.astype(np.int64)
        if self.kind == "dense":
            # one position a row from the first dispatch on (on the device)
            meta["pos"] = meta["pos"].reshape(-1).expand(b).clone()
        while min(len(o) for o in outs) < mnt:
            rem = np.array([mnt - len(o) for o in outs], np.int64)
            caps = sl + np.maximum(np.minimum(self.spec_k + 1, rem), 0)
            if self.kind == "paged":
                for j, slot in enumerate(slots):
                    self.cache.reserve(slot, int(caps[j]))
                meta["page_tables"] = self.cache.page_tables
            toks, counts, lg, buffers, meta = self.spec_step(
                buffers, meta, cur, seeds, caps.astype(np.int32),
                positions=sl)
            host = torch.cat([toks, counts[:, None]], 1).cpu().numpy()
            stats["dispatches"] += 1
            for i in range(b):
                c = int(host[i, -1])
                if caps[i] > sl[i]:
                    stats["proposed"] += int(caps[i] - sl[i]) - 1
                    stats["accepted"] += max(c - 1, 0)
                stats["emitted"] += c
                outs[i].extend(int(t) for t in host[i, :c])
                if return_logits:
                    rows[i].extend(lg[i, :c].clone())
                if c:
                    cur[i] = host[i, c - 1]
                sl[i] += c
        if self.kind == "dense":
            # every row ends at the same length: the shared position again
            meta["pos"] = meta["pos"][0]
        out = np.stack([np.asarray(o, np.int32) for o in outs])
        logit_rows = (torch.stack([torch.stack(r) for r in rows])
                      if return_logits else None)
        return out, logit_rows, buffers, meta
