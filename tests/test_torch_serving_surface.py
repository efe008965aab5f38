"""The serving engine's surface in the PyTorch port against the JAX
reference: request ids and deadlines, the Prometheus text, metric
resets, warm-up and capture counts, the decode burst, the reference's
constructor keywords, and the synthetic traffic of ``serving.traffic``.

Both engines serve the same greedy requests over models holding the same
numpy weights; the port runs on the CPU, where its steps run eagerly and
count calls as traces, as the reference's eager steps do
(``compiled=False``). The last tests replay the port's CUDA-graph path
with a stand-in graph that re-runs the captured body and checks that
every replay reads the tensors the capture bound, so the path's control
flow (static inputs, the idle warm-up, the seq_lens hand-back) is held
to the eager loop here too; the real graphs run in the card tests. One
test drives `StepGraphs.capture` itself over stand-in CUDA calls: the
cyclic collector is held off while the body is captured.
"""
import contextlib
import gc

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import decode_step as jds
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import traffic as jtraffic
from paddle_tpu_torch import convert
from paddle_tpu_torch.jit import decode_step as tds
from paddle_tpu_torch.jit import graphs
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import traffic as ttraffic

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=96)
KW = dict(max_slots=3, max_len=48, page_size=8, chunk_size=16)


@pytest.fixture(scope="module")
def models():
    """(reference model, port model) holding the same numpy weights."""
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    rng = np.random.default_rng(1)
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


def _engines(models, **kw):
    """(reference engine, port engine) over the same options; the
    reference runs its eager steps unless ``compiled`` is given."""
    jm, tm = models
    kw = {**KW, **kw}
    je = JEngine(jm, **{"compiled": False, **kw})
    te = ServingEngine(tm, device="cpu", **kw)
    return je, te


def _churn(engine, seed=5):
    """Four requests at once, which a tight pool preempts, then a fifth
    admitted mid-flight."""
    handles = [engine.submit(p, 10) for p in _prompts(4, seed=seed)]
    for _ in range(3):
        engine.step()
    handles.append(engine.submit(_prompts(5, seed=seed)[4], 6))
    engine.run(max_steps=5000)
    return handles


def test_submit_rid_sets_the_ids(models):
    je, te = _engines(models)
    hs = {}
    for name, e in (("jax", je), ("torch", te)):
        p = _prompts(3)
        hs[name] = [e.submit(p[0], 3, rid=10), e.submit(p[1], 3),
                    e.submit(p[2], 3, rid=4)]
        e.run()
    assert [h.request.rid for h in hs["torch"]] == \
        [h.request.rid for h in hs["jax"]] == [10, 11, 4]
    # rid keys the default seed and the arrival order
    assert [h.request.seed for h in hs["torch"]] == [10, 11, 4]
    assert [h.output_tokens for h in hs["torch"]] == \
        [h.output_tokens for h in hs["jax"]]


def test_deadlines_retire_the_same_requests(models):
    """Under an injected clock: two of four requests have a 5 s budget,
    and the clock jumps past it after six steps. The running one retires
    with the tokens it had, the queued one from the queue, both with
    ``deadline_exceeded``; the rest finish as without deadlines."""
    jm, tm = models
    out = {}
    counter = registry().counter("serving.deadline_exceeded")
    before = counter.value
    for name in ("jax", "torch"):
        now = [0.0]
        kw = dict(KW, max_slots=2, clock=lambda: now[0])
        e = JEngine(jm, compiled=False, **kw) if name == "jax" \
            else ServingEngine(tm, device="cpu", **kw)
        hs = [e.submit(p, 12, deadline_s=d)
              for p, d in zip(_prompts(4, seed=2), (5.0, None, 5.0, 50.0))]
        for _ in range(6):
            e.step()
        now[0] = 10.0
        e.run()
        out[name] = [(h.finish_reason.value, h.output_tokens) for h in hs]
        leaks = e.leak_check()
        assert leaks["free_pages"] == leaks["total_pages"]
    assert out["torch"] == out["jax"]
    reasons = [r for r, _ in out["torch"]]
    assert reasons == ["deadline_exceeded", "length", "deadline_exceeded",
                       "length"]
    assert 0 < len(out["torch"][0][1]) < 12 and out["torch"][2][1] == []
    assert counter.value - before == 2


def _parse(text):
    types, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        else:
            name, value = line.rsplit(" ", 1)
            values[name] = value
    return types, values


def _timed(name):
    """Samples that are wall times (tok/s, the latency summaries but
    their counts)."""
    return name == "serving_tok_s" or (
        name.startswith(("serving_ttft_s", "serving_itl_s"))
        and not name.endswith("_count"))


def test_metrics_text_matches_the_reference(models):
    """The same metric names and types (the request tracer's ``trace_*``
    come with ROADMAP queue A8), and the same values for every counter,
    gauge and sample count after a run with preemptions."""
    je, te = _engines(models, max_slots=4, num_pages=9, decode_burst=2)
    jh, th = _churn(je), _churn(te)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    assert te.metrics.preemptions >= 1
    jtypes, jvals = _parse(je.metrics_text())
    ttypes, tvals = _parse(te.metrics_text())
    jtypes = {k: v for k, v in jtypes.items() if not k.startswith("trace_")}
    assert ttypes == jtypes
    assert {k for k in tvals} == {k for k in jvals
                                  if not k.startswith("trace_")}
    for k, v in tvals.items():
        if not _timed(k):
            assert v == jvals[k], k
    assert tvals["serving_preemptions"] == jvals["serving_preemptions"] \
        != "0.0"


def test_reset_metrics_starts_from_zero(models):
    je, te = _engines(models)
    for e in (je, te):
        for p in _prompts(2):
            e.submit(p, 4)
        e.run()
        e.reset_metrics()
    jtypes, jvals = _parse(je.metrics_text())
    ttypes, tvals = _parse(te.metrics_text())
    assert tvals["serving_generated_tokens"] == "0.0"
    assert tvals["serving_ttft_s_count"] == "0"
    for k, v in tvals.items():
        if not _timed(k):
            assert v == jvals[k], k
    assert te.metrics_snapshot()["finished"] == 0


def test_warmup_and_compile_counts(models):
    """``warmup()`` serves one request a bucket and resets the metrics;
    ``compile_counts()`` has the reference's keys. On the CPU the port
    counts calls, as the reference's eager steps, through warm-up and a
    run with admissions, preemptions and retirements; the reference's
    compiled decode stays at one trace through the same churn."""
    jm, _ = models
    je, te = _engines(models, max_slots=4, num_pages=9)
    jc = JEngine(jm, **{**KW, "max_slots": 4, "num_pages": 9})
    for e in (je, te, jc):
        e.warmup()
    assert te.compile_counts() == je.compile_counts()
    assert set(te.compile_counts()) == set(jc.compile_counts())
    assert te.compile_counts()["chunk_buckets"] == [8, 16]
    rep = te.warmup_report
    assert set(rep) == set(jc.warmup_report)
    assert rep["programs"] == jc.warmup_report["programs"] == 3
    assert rep["cache_hits"] == rep["cache_misses"] == 0
    assert te.last_warmup_ms > 0
    assert te.metrics_snapshot()["submitted"] == 0
    hs = {e: _churn(e) for e in (je, te, jc)}
    assert [h.output_tokens for h in hs[te]] == \
        [h.output_tokens for h in hs[jc]]
    assert te.metrics.preemptions >= 1
    assert te.compile_counts() == je.compile_counts()
    assert te.compile_counts()["decode_traces"] == te.decode_step.calls
    assert jc.compile_counts()["decode_traces"] == 1
    assert te.compile_counts()["decode_executables"] == 0


def test_set_decode_burst_matches_the_reference(models):
    je, te = _engines(models)
    for e in (je, te):
        e.set_decode_burst(4)
        assert e.decode_burst == 4 and e.scheduler.token_lookahead == 4
    assert te.decode_step.trace_count == 0
    jh, th = _churn(je), _churn(te)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    assert te.decode_step.trace_count == je.decode_step.trace_count > 0


def test_reference_keywords_are_accepted(models):
    """``compiled=False``, ``donate`` and ``spec_k``, the tracer's
    options, ``tuner_kw`` and ``recover_backoff_s`` construct and serve
    as the reference does."""
    kw = dict(compiled=False, donate=True, spec_k=4, trace=False,
              trace_capacity=8, exemplar_capacity=4, exemplar_quantile=90.0,
              exemplar_min_samples=4, tuner_kw={"interval": 3},
              recover_backoff_s=0.1)
    je, te = _engines(models, **kw)
    assert not te.compiled
    jh, th = _churn(je), _churn(te)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    # speculative decoding is ported: the reference's own ValueErrors
    with pytest.raises(ValueError, match="num_draft_heads"):
        ServingEngine(models[1], device="cpu", max_len=48,
                      draft_model="self")
    with pytest.raises(ValueError, match="unknown draft_model"):
        ServingEngine(models[1], device="cpu", max_len=48,
                      draft_model="slef")
    with pytest.raises(NotImplementedError, match="A8"):
        ServingEngine(models[1], device="cpu", recover_retries=1)


def test_poisson_traffic_is_the_references():
    kw = dict(n=12, rate_rps=40.0, vocab_size=64, prompt_lens=(4, 20),
              out_lens=(3, 9), seed=3, sessions=4)
    jt, tt = jtraffic.poisson_traffic(**kw), ttraffic.poisson_traffic(**kw)
    assert len(tt) == len(jt) == 12
    for t, j in zip(tt, jt):
        assert (t.arrival_s, t.max_new_tokens, t.priority, t.seed,
                t.session) == (j.arrival_s, j.max_new_tokens, j.priority,
                               j.seed, j.session)
        np.testing.assert_array_equal(t.prompt, j.prompt)


def test_run_continuous_tokens_match(models):
    """Arrivals all due at once (a very high rate): each request's
    greedy tokens equal the reference's; the record carries the capture
    counts."""
    traffic = ttraffic.poisson_traffic(6, 1e7, 64, prompt_lens=(4, 16),
                                       out_lens=(3, 8), seed=4)
    je, te = _engines(models, max_slots=4)
    jrec, jh = jtraffic.run_continuous(je, jtraffic.poisson_traffic(
        6, 1e7, 64, prompt_lens=(4, 16), out_lens=(3, 8), seed=4))
    trec, th = ttraffic.run_continuous(te, traffic)
    assert [h.output_tokens for h in th] == [h.output_tokens for h in jh]
    assert trec["generated_tokens"] == jrec["generated_tokens"]
    assert trec["compile"] == te.compile_counts()


def test_run_static_tokens_match(models, monkeypatch):
    """The generate-and-wait baseline batches the same requests and
    generates the same tokens as the reference's."""
    jm, tm = models
    kw = dict(n=5, rate_rps=1e7, vocab_size=64, prompt_lens=(4, 12),
              out_lens=(3, 6), seed=6)
    got = {"jax": [], "torch": []}
    for name, mod in (("jax", jds), ("torch", tds)):
        orig = mod.GenerationEngine.generate

        def record(self, *a, _orig=orig, _name=name, **k):
            out = _orig(self, *a, **k)
            got[_name].append(np.asarray(out.numpy()))
            return out

        monkeypatch.setattr(mod.GenerationEngine, "generate", record)
    jrec = jtraffic.run_static(jm, jtraffic.poisson_traffic(**kw), 2, 32,
                               page_size=8)
    trec = ttraffic.run_static(tm, ttraffic.poisson_traffic(**kw), 2, 32,
                               page_size=8)
    assert len(got["torch"]) == len(got["jax"]) == 4   # warm-up + 3
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)
    for key in ("finished", "generated_tokens"):
        assert trec[key] == jrec[key]


# ---------------------------------------------------------------------------
# the CUDA-graph path's control flow, with a stand-in graph on the CPU
# ---------------------------------------------------------------------------

class _StandInGraph:
    """Runs the captured body again at each replay, writing the results
    into the first run's output tensors (a graph's outputs are fixed
    tensors its replays overwrite), after checking that the cache still
    binds the tensors the capture saw."""

    def __init__(self, fn, cache):
        self.fn, self.cache = fn, cache
        self.bound = self._bound()
        self.out = fn()
        self.launches = {}

    def _bound(self):
        c = self.cache
        if c.kind == "dense":
            return [t.data_ptr() for t in (c.pos, c.layers[0],
                                           c.layers[-1])]
        return [t.data_ptr() for t in (c.page_tables, c.seq_lens, c.active,
                                       c.k_layers[0], c.v_layers[-1])]

    def replay(self):
        assert self._bound() == self.bound, "a replay reads other tensors"
        _copy_into(self.out, self.fn())
        return self.out


def _copy_into(dst, src):
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dst is not None:
        dst.copy_(src)


def test_capture_holds_the_cyclic_collector(monkeypatch):
    """`StepGraphs.capture` runs the warm-up with the collector as it
    was and the capture with it off (a graph freed by it inside a
    capture invalidates the capture), and gives it back after, also when
    the capture raises."""
    class _Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def _ctx(*args, **kwargs):
        yield

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", _ctx)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", _ctx)
    seen = []

    def body(fail=False):
        seen.append(gc.isenabled())
        if fail and len(seen) == 4:
            raise RuntimeError("the capture failed")

    assert gc.isenabled()
    graphs.StepGraphs().capture("k", body, "cpu")
    assert seen == [True, False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.StepGraphs().capture("k", lambda: body(True), "cpu")
    assert seen == [True, False, True, False] and gc.isenabled()


def test_graph_of_warms_up_then_captures_with_the_collector_held(
        monkeypatch):
    """`graph_of` runs each call once eagerly, then captures them all
    back to back with the collector off, and gives it back after."""
    class _Stream:
        def wait_stream(self, other):
            pass

    class _Graph:
        pass

    @contextlib.contextmanager
    def _ctx(*args, **kwargs):
        yield

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", _ctx)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _ctx)
    seen = []
    fns = [lambda i=i: seen.append((i, gc.isenabled())) for i in range(2)]
    assert gc.isenabled()
    assert isinstance(graphs.graph_of(fns), _Graph)
    assert seen == [(0, True), (1, True), (0, False), (1, False)]
    assert gc.isenabled()


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graph path on CPU tensors: each step's warm-up call runs the
    body over the idle inputs, then a stand-in graph takes its place."""
    captures = []

    def capture(self, key, fn, device):
        fn()
        self._graphs[key] = g = _StandInGraph(fn, self._owner())
        captures.append(key)
        return g

    monkeypatch.setattr(graphs.StepGraphs, "capture", capture)
    monkeypatch.setattr(tds._Step, "_compiled",
                        lambda self: self.engine.compiled)
    return captures


@pytest.mark.parametrize("opts", [
    dict(decode_burst=1), dict(decode_burst=3),
    dict(decode_burst=2, num_pages=8),
    dict(decode_burst=2, do_sample=True, top_k=20),
    dict(decode_burst=3, kv_quant="int8"),
    dict(decode_burst=1, kv_quant="int4", num_pages=8),
], ids=["burst1", "burst3", "preempt", "sampled", "int8", "int4_preempt"])
def test_graph_path_matches_the_eager_loop(models, stand_in_graphs, opts):
    """Staggered requests through the graph path and the eager loop:
    identical tokens and pools, one decode capture, one a chunk bucket;
    a failed step's fresh cache makes the steps capture anew."""
    _, tm = models
    runs = {}
    for compiled in (True, False):
        e = ServingEngine(tm, device="cpu", compiled=compiled,
                          **{**KW, **opts})
        hs = [e.submit(p, 10, seed=7 + i)
              for i, p in enumerate(_prompts(5, seed=3))]
        e.run(max_steps=5000)
        runs[compiled] = (e, [h.output_tokens for h in hs])
    (ge, gt), (ee, et) = runs[True], runs[False]
    assert gt == et
    for a, b in zip(ge.cache.k_layers + ge.cache.v_layers,
                    ee.cache.k_layers + ee.cache.v_layers):
        assert torch.equal(a[:, 1:], b[:, 1:])
    counts = ge.compile_counts()
    assert counts["decode_traces"] == counts["decode_executables"] == 1
    assert counts["prefill_traces"] == counts["prefill_executables"] == 2
    ge._recover()
    h = ge.submit(_prompts(1, seed=9)[0], 4)
    ge.run()
    assert h.done and ge.compile_counts()["decode_traces"] == 2


@pytest.mark.parametrize("opts", [dict(), dict(kv_quant="int8"),
                                  dict(do_sample=True, seed=5, top_k=10)],
                         ids=["greedy", "int8", "sampled"])
def test_paged_generate_graph_path_matches_eager(models, stand_in_graphs,
                                                 opts):
    """``generate(use_cache="paged")`` through the prompt bucket's graph
    and the decode graph gives the eager steps' tokens and logits, over
    two calls on one engine."""
    _, tm = models
    ids = np.random.default_rng(2).integers(1, 64, (3, 12))
    out = {}
    for compiled in (True, False):
        tm.__dict__.pop("_generation_engines", None)
        kw = dict(use_cache="paged", compiled=compiled, seq_lens=[12, 7, 9],
                  **opts)
        first = tm.generate(ids, 9, return_logits=True, **kw)
        out[compiled] = first + (tm.generate(ids, 5, **kw),)
        eng, = tm._generation_engines.values()
        assert eng.decode_step.cache_size() == int(compiled)
        assert eng.prefill_step.cache_size() == int(compiled)
    tm.__dict__.pop("_generation_engines", None)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    greedy = "do_sample" not in opts
    assert stand_in_graphs == [("prefill", 16, greedy), ("decode", greedy)]


@pytest.mark.parametrize("opts", [dict(), dict(int8_weights=True),
                                  dict(do_sample=True, seed=5, top_k=10)],
                         ids=["greedy", "int8_weights", "sampled"])
def test_dense_generate_graph_path_matches_eager(models, stand_in_graphs,
                                                 opts):
    """``generate(use_cache="dense")`` through one graph a prompt bucket
    and one decode graph (the write position a static device scalar)
    gives the eager steps' tokens and logits, over calls at two prompt
    buckets on one engine; each graph is captured once."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    opts = dict(opts)
    tm = models[1]
    if opts.pop("int8_weights", False):
        tm = quantize_for_decode(GPTForCausalLM(tm.config, device="cpu",
                                                seed=1))
    rng = np.random.default_rng(4)
    short, long = rng.integers(1, 64, (2, 7)), rng.integers(1, 64, (2, 20))
    out = {}
    for compiled in (True, False):
        tm.__dict__.pop("_generation_engines", None)
        kw = dict(use_cache="dense", compiled=compiled, **opts)
        out[compiled] = (tm.generate(short, 9, return_logits=True, **kw) +
                         tm.generate(long, 6, return_logits=True, **kw) +
                         (tm.generate(short, 4, **kw),))
        eng, = tm._generation_engines.values()
        assert eng.decode_step.cache_size() == int(compiled)
        assert eng.prefill_step.cache_size() == 2 * int(compiled)
        if compiled:
            assert eng.decode_step.trace_count == 1
            assert eng.prefill_step.trace_count == 2
    tm.__dict__.pop("_generation_engines", None)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    greedy = "do_sample" not in opts
    assert stand_in_graphs == [("prefill", 16, greedy), ("decode", greedy),
                               ("prefill", 32, greedy)]
