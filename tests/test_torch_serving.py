"""ServingEngine of the PyTorch port against the JAX reference.

Both engines serve the same greedy requests over models holding the
same numpy weights; the port runs on the CPU, where its attention takes
the kernels' plain versions. Tokens must be identical with mid-flight
admission, with ``decode_burst`` 1 and 3, under a page pool tight
enough to force preemptions, and with padding rows in the chunk-prefill
batch; every page and slot must come back.
"""
import copy

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=96)


@pytest.fixture(scope="module")
def models():
    """(reference model, port model) holding the same numpy weights."""
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    rng = np.random.default_rng(0)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = (0.1 * a if name.endswith("bias")
             else 1.0 + 0.1 * a if p.ndim == 1 else 0.3 * a)
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named))
    return jm, tm


def _prompts(n, seed=0, lens=(5, 11, 19, 8, 14, 26)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _serve(engine, requests, stagger=True):
    handles = []
    for prompt, max_new in requests:
        handles.append(engine.submit(prompt, max_new))
        if stagger:
            engine.step()                 # admissions interleave
    engine.run(max_steps=5000)
    return handles


def _both(models, requests, stagger=True, **kw):
    jm, tm = models
    je = JEngine(jm, **kw)
    te = ServingEngine(tm, device="cpu", **kw)
    return (je, _serve(je, requests, stagger),
            te, _serve(te, requests, stagger))


def _assert_no_leaks(engine):
    leaks = engine.leak_check()
    assert leaks["free_pages"] == leaks["total_pages"]
    assert leaks["free_slots"] == leaks["total_slots"]
    assert leaks["resident_slot_pages"] == 0


@pytest.mark.parametrize("burst", [1, 3])
def test_greedy_tokens_match_reference(models, burst):
    """Five requests with mid-flight admission; the last one fills the
    window exactly (48 tokens, a multiple of the page size), so a burst
    saturates its slot at the window edge."""
    prompts = _prompts(5, seed=4)
    requests = [(p, 5 + i % 3) for i, p in enumerate(prompts)]
    requests[-1] = (prompts[-1], 48 - len(prompts[-1]))
    je, jh, te, th = _both(models, requests, max_slots=3, max_len=48,
                           page_size=8, chunk_size=8, decode_burst=burst)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    assert all(h.done for h in th)
    assert [len(h.output_tokens) for h in th] == [n for _, n in requests]
    _assert_no_leaks(te)


@pytest.mark.parametrize("burst", [1, 2])
def test_preemption_tokens_match_reference(models, burst):
    """A pool of 8 usable pages for 4 slots forces preemptions; the
    port preempts the same requests as the reference and yields the
    same tokens."""
    requests = [(p, 10) for p in _prompts(4, seed=5)]
    je, jh, te, th = _both(models, requests, stagger=False, max_slots=4,
                           max_len=48, page_size=8, chunk_size=8,
                           num_pages=9, decode_burst=burst)
    assert te.metrics.preemptions >= 1
    assert te.metrics.preemptions == je.metrics.preemptions
    assert [h.preemptions for h in th] == [h.preemptions for h in jh]
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    _assert_no_leaks(te)
    snap = te.metrics_snapshot()
    assert snap["admitted"] == snap["finished"] + snap["resumed"]
    assert snap["generated_tokens"] == sum(len(h.output_tokens)
                                           for h in th)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("burst", [1, 3])
def test_kv_quant_tokens_match_reference(models, quant, burst):
    """``kv_quant`` pools: staggered admission, the last request filling
    the window exactly; identical greedy tokens and pool statistics."""
    prompts = _prompts(5, seed=4)
    requests = [(p, 5 + i % 3) for i, p in enumerate(prompts)]
    requests[-1] = (prompts[-1], 48 - len(prompts[-1]))
    je, jh, te, th = _both(models, requests, max_slots=3, max_len=48,
                           page_size=8, chunk_size=8, decode_burst=burst,
                           kv_quant=quant)
    assert te.cache.quant == quant and te.cache.quantized
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    assert [len(h.output_tokens) for h in th] == [n for _, n in requests]
    js, ts = je.cache.pool_stats(), te.cache.pool_stats()
    for key in ("bytes_per_token", "effective_slots_vs_bf16", "pool_bytes"):
        assert js[key] == ts[key], key
    _assert_no_leaks(te)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_kv_quant_preemption_tokens_match_reference(models, quant):
    """A tight pool forces preemptions over quantized pools: the same
    requests are preempted and re-prefilled, with the same tokens."""
    requests = [(p, 10) for p in _prompts(4, seed=5)]
    je, jh, te, th = _both(models, requests, stagger=False, max_slots=4,
                           max_len=48, page_size=8, chunk_size=8,
                           num_pages=9, decode_burst=2, kv_quant=quant)
    assert te.metrics.preemptions >= 1
    assert te.metrics.preemptions == je.metrics.preemptions
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    _assert_no_leaks(te)


def test_padding_rows_in_the_prefill_batch(models):
    """prefill_batch 4 with at most two prompts resident: the padding
    rows carry slot id max_slots, clamped on the page-table gather and
    dropped on the seq_lens scatter, exactly as in the reference."""
    requests = [(p, 4) for p in _prompts(2, seed=7, lens=(19, 6))]
    je, jh, te, th = _both(models, requests, stagger=False, max_slots=2,
                           max_len=48, page_size=8, chunk_size=8,
                           prefill_batch=4)
    assert te.prefill_batch == 2          # capped at max_slots
    je, jh, te, th = _both(models, requests, stagger=False, max_slots=4,
                           max_len=48, page_size=8, chunk_size=8,
                           prefill_batch=4)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    np.testing.assert_array_equal(np.asarray(te.cache.seq_lens),
                                  np.asarray(je.cache.seq_lens))
    _assert_no_leaks(te)


def test_sampled_preemption_resumes_the_same_stream(models):
    """With sampling on, a request preempted and re-prefilled draws the
    same tokens as without preemption: its stream is keyed on (seed,
    context length) alone."""
    _, tm = models

    def serve(num_pages):
        eng = ServingEngine(tm, device="cpu", max_slots=4, max_len=48,
                            page_size=8, chunk_size=8, num_pages=num_pages,
                            do_sample=True, top_k=20, top_p=0.9)
        hs = [eng.submit(p, 10, seed=100 + i)
              for i, p in enumerate(_prompts(4, seed=5))]
        eng.run(max_steps=5000)
        return eng, hs

    full_eng, full = serve(None)
    tight_eng, tight = serve(9)
    assert full_eng.metrics.preemptions == 0
    assert tight_eng.metrics.preemptions >= 1
    assert [h.output_tokens for h in full] == \
        [h.output_tokens for h in tight]


def test_stream_callback_and_eos(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_slots=2, max_len=48,
                        page_size=8, chunk_size=8)
    prompt = _prompts(1, seed=9)[0]
    called = []
    ref = eng.submit(prompt, 6, on_token=lambda h, t: called.append(t))
    eng.run()
    assert called == ref.output_tokens
    eos = ref.output_tokens[2]
    h = eng.submit(prompt, 6, eos_token_id=eos)
    streamed = list(eng.stream(h))
    assert streamed == h.output_tokens
    assert streamed == ref.output_tokens[:ref.output_tokens.index(eos) + 1]
    assert h.finish_reason.value == "eos"
    _assert_no_leaks(eng)


def test_metrics_registry_reads_the_counters(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_slots=2, max_len=48,
                        page_size=8, chunk_size=8)
    hs = [eng.submit(p, 4) for p in _prompts(3, seed=10)]
    snap = eng.run()
    reg = eng.metrics.registry
    assert reg.get("serving.finished").value == snap["finished"] == 3
    assert reg.get("serving.generated_tokens").value == 12
    assert reg.get("serving.ttft_s").count == 3
    assert snap["ttft_p99_s"] >= snap["ttft_p50_s"] > 0
    assert reg.get("serving.itl_s").count == sum(
        len(h.output_tokens) - 1 for h in hs)


def test_failed_step_requeues_and_resumes(models, monkeypatch):
    """A step that raises leaves every resident request queued on a
    fresh cache; serving on yields the tokens of an undisturbed run."""
    _, tm = models
    kw = dict(max_slots=3, max_len=48, page_size=8, chunk_size=8)
    prompts = _prompts(3, seed=11)
    ref = ServingEngine(tm, device="cpu", **kw)
    want = [h.output_tokens for h in _serve(ref, [(p, 6) for p in prompts],
                                            stagger=False)]
    eng = ServingEngine(tm, device="cpu", **kw)
    hs = [eng.submit(p, 6) for p in prompts]
    for _ in range(4):
        eng.step()
    step = eng.decode_step
    monkeypatch.setattr(eng, "decode_step", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        eng.step()
    assert not eng.scheduler.running and len(eng.scheduler.waiting) == 3
    assert all(h.preemptions == 1 for h in hs)
    monkeypatch.setattr(eng, "decode_step", step)
    eng.run()
    assert [h.output_tokens for h in hs] == want
    _assert_no_leaks(eng)


def test_no_device_and_no_card_raises(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(GPTConfig(**CFG))


def test_model_and_engine_device_must_agree(models):
    _, tm = models
    elsewhere = copy.deepcopy(tm).to("meta")
    with pytest.raises(ValueError, match="lives on"):
        ServingEngine(elsewhere, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(tm, device="meta")


@pytest.mark.parametrize("option,value", [
    ("draft_model", "self"), ("tuner", True),
    ("host_kv_ring", object()), ("prefill_only", True),
    ("debug_port", 0), ("slos", [("ttft", "ttft_s", 0.2)]),
    ("recover_retries", 2),
])
def test_options_of_later_slices_raise(models, option, value):
    _, tm = models
    if option == "draft_model":
        # speculative decoding is ported: "self" needs draft heads (the
        # reference's ValueError), a draft model constructs and serves
        with pytest.raises(ValueError, match="num_draft_heads"):
            ServingEngine(tm, device="cpu", max_len=48, **{option: value})
        e = ServingEngine(tm, device="cpu", max_len=48, draft_model=tm,
                          spec_k=2)
        h = e.submit(_prompts(1)[0], 4)
        e.run()
        assert h.done and len(h.output_tokens) == 4
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServingEngine(tm, device="cpu", **{option: value})


def test_kv_quant_mode_is_validated(models):
    _, tm = models
    with pytest.raises(ValueError, match="quant mode"):
        ServingEngine(tm, device="cpu", max_len=48, kv_quant="fp8")


def test_options_left_off_are_accepted(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_len=48, kv_quant=None,
                        draft_model=None,
                        tuner=False, debug_port=None, slos=(),
                        recover_retries=0, trace=True)
    assert eng.leak_check()["free_slots"] == 8
