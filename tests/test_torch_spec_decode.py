"""Speculative decoding of the PyTorch port against the JAX package.

Target, drafts and draft heads hold the same numpy weights on both sides
(`convert.state_dict_from_jax`); the port runs on the CPU, where its
attention takes the kernels' plain versions. Bars, the reference's own
(tests/test_spec_decode.py, tests/test_int4_selfspec.py):

* greedy speculative tokens equal plain greedy decoding's, the JAX
  package's and the port's, on the dense, paged, int8 and int4 caches,
  with a weak independent draft, the target as its own draft, the
  strong pair (accept rate 1.0 by construction: exactly ceil((n-1)/
  (k+1)) dispatches) and the target's draft heads (``"self"``);
* the ``return_logits`` rows are the emitted tokens' argmax and within
  2e-4 of the JAX spec engine's rows;
* `spec_accept_greedy` equal to the reference's, `truncated_probs`
  within 1e-6, and a Monte-Carlo check of `spec_accept_sampled`: total
  variation below 0.05 at v=7, k=2, n=4000;
* the serving engine's spec tokens and counters equal the JAX engine's,
  with every page back after rejection churn and preemption;
* the draft heads' loss and gradients through 3 `TrainStep`s: loss
  |diff| < 5e-4, parameters relative < 5e-3.

Tiny models (vocab 97, hidden 32, 2 layers), as the reference's tests.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit.decode_step import GenerationEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.nn.functional import sampling as jsampling
from paddle_tpu.serving import ServingEngine as JServing
from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.inference.spec_decode_selftest import (
    strong_pair, zero_self_target)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import decode_step as tds
from paddle_tpu_torch.jit import graphs
from paddle_tpu_torch.jit.decode_step import (GenerationEngine,
                                              SelfDraftProposer)
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import sampling as tsampling
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine

TGT = dict(vocab_size=97, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=96)
WEAK = dict(TGT, hidden_size=16, num_layers=1, num_attention_heads=2)
CACHES = [("dense", None), ("paged", None), ("paged", "int8"),
          ("paged", "int4")]
K = 3
LOGIT_ATOL = 2e-4


def _pair(cfg, seed, heads=0, zero_tail=False):
    """(reference model, port model) of ``cfg`` holding the same numpy
    weights; ``zero_tail`` zeroes the residual writes of every block but
    block 0 (the strong pair's target)."""
    paddle.seed(0)
    jm = JModel(JConfig(**cfg, num_draft_heads=heads))
    jm.eval()
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = (0.1 * a if name.endswith("bias")
             else 1.0 + 0.1 * a if p.ndim == 1 else 0.3 * a)
        if zero_tail and not name.startswith("gpt.blocks.0.") and (
                ".attn.out_proj." in name or ".mlp.fc2." in name):
            a = np.zeros_like(a)
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**cfg, num_draft_heads=heads), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, tm))
    tm.eval()
    return jm, tm, named


def _strong_draft(named):
    """The strong pair's draft: one layer holding the target's
    embeddings, block 0 and ln_f."""
    cfg = dict(TGT, num_layers=1)
    keep = {k: v for k, v in named.items()
            if not k.startswith("gpt.blocks.") or
            k.startswith("gpt.blocks.0.")}
    paddle.seed(0)
    jd = JModel(JConfig(**cfg))
    jd.eval()
    for name, p in jd.named_parameters():
        p._data = jnp.asarray(keep[name])
    td = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    td.load_state_dict(convert.state_dict_from_jax(keep, td))
    td.eval()
    return jd, td


@pytest.fixture(scope="module")
def models():
    jt, tt, _ = _pair(TGT, 0)
    jw, tw, _ = _pair(WEAK, 7)
    js, ts, snamed = _pair(TGT, 0, zero_tail=True)
    jsd, tsd = _strong_draft(snamed)
    jh, th, _ = _pair(TGT, 0, heads=K)
    return {"target": (jt, tt), "weak": (jw, tw), "strong": (js, ts),
            "strong_draft": (jsd, tsd), "heads": (jh, th)}


def _ids(b=2, s=11, seed=0):
    return np.random.default_rng(seed).integers(1, 97, (b, s))


def _engine(model, cache, quant, **kw):
    extra = {} if quant is None else {"kv_quant": quant}
    return GenerationEngine(model, kind=cache, batch=2, max_len=64,
                            **extra, **kw)


_JAX_PLAIN = {}


def _jax_plain(jm, key, cache, quant, ids, n):
    """The reference's plain greedy tokens (one engine a case)."""
    if key not in _JAX_PLAIN:
        extra = {} if quant is None else {"kv_quant": quant}
        eng = JEngine(jm, kind=cache, batch=2, max_len=64, **extra)
        _JAX_PLAIN[key] = np.asarray(eng.generate(ids, n)._data)
    return _JAX_PLAIN[key]


# ---------------------------------------------------------------------------
# generate(): greedy tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["weak", "target", "strong"])
@pytest.mark.parametrize("cache,quant", CACHES)
def test_greedy_spec_tokens_equal_plain_decoding(models, cache, quant,
                                                 draft):
    """With any draft, greedy speculative tokens are plain greedy
    decoding's: the reference's and the port's."""
    tgt = "strong" if draft == "strong" else "target"
    jm, tm = models[tgt]
    td = {"weak": models["weak"][1], "target": tm,
          "strong": models["strong_draft"][1]}[draft]
    ids = _ids()
    want = _jax_plain(jm, (tgt, cache, quant), cache, quant, ids, 17)
    plain = _engine(tm, cache, quant).generate(ids, 17).numpy()
    eng = _engine(tm, cache, quant, draft_model=td, spec_k=K)
    got = eng.generate(ids, 17).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(got, want)
    if draft != "weak" and quant is None:
        # accept rate 1.0 (a quantized target verifies against what the
        # draft's fp pools do not see, so there it may dip): every
        # dispatch yields k + 1 tokens
        assert eng.spec_step.calls == -(-(17 - 1) // (K + 1))


@pytest.mark.parametrize("cache,quant", CACHES)
def test_self_draft_tokens_equal_plain_decoding(models, cache, quant):
    """``draft_model="self"``: the target's draft heads propose; no draft
    parameters, no draft cache, the plain greedy tokens."""
    jm, tm = models["heads"]
    ids = _ids(seed=1)
    want = _jax_plain(jm, ("heads", cache, quant), cache, quant, ids, 13)
    eng = _engine(tm, cache, quant, draft_model="self", spec_k=K)
    assert isinstance(eng.draft_model, SelfDraftProposer)
    assert eng.draft_model.parameters() == [] and eng.draft_cache is None
    np.testing.assert_array_equal(eng.generate(ids, 13).numpy(), want)
    # the engine repeats itself over ragged prompts (paged)
    if cache == "paged":
        a = eng.generate(ids, 9, seq_lens=[11, 6]).numpy()
        np.testing.assert_array_equal(
            a, eng.generate(ids, 9, seq_lens=[11, 6]).numpy())


@pytest.mark.parametrize("cache,quant", [("dense", None), ("paged", None),
                                         ("paged", "int8")])
def test_logits_rows_match_the_reference_spec_engine(models, cache, quant):
    """Each emitted token's target row: its argmax is the token, and it
    lies within 2e-4 of the JAX spec engine's row."""
    jm, tm = models["target"]
    jw, tw = models["weak"]
    ids = _ids(seed=2)
    extra = {} if quant is None else {"kv_quant": quant}
    jeng = JEngine(jm, kind=cache, batch=2, max_len=64, draft_model=jw,
                   spec_k=K, **extra)
    jt, jl = jeng.generate(ids, 11, return_logits=True)
    tt, tl = _engine(tm, cache, quant, draft_model=tw,
                     spec_k=K).generate(ids, 11, return_logits=True)
    assert tuple(tl.shape) == (2, 11, 97)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt._data))
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), tt.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), rtol=0,
                               atol=LOGIT_ATOL)


def test_engine_state_across_calls_and_failures(models):
    """A failed generate() rebuilds both caches; a dense spec engine's
    position is one shared scalar again after each call, so its plain
    prompt graph and its spec step keep their buffers."""
    _, tm = models["target"]
    _, tw = models["weak"]
    eng = _engine(tm, "paged", None, draft_model=tw, spec_k=K)
    c0, d0 = eng.cache, eng.draft_cache
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(_ids(), 1000)
    assert eng.cache is c0 and eng.draft_cache is d0
    calls = []
    orig = eng.spec_step.__class__.__call__

    def boom(self, *a, **k):
        calls.append(1)
        raise RuntimeError("step failed")

    eng.spec_step.__class__.__call__ = boom
    try:
        with pytest.raises(RuntimeError, match="step failed"):
            eng.generate(_ids(), 9)
    finally:
        eng.spec_step.__class__.__call__ = orig
    assert calls and eng.cache is not c0 and eng.draft_cache is not d0
    assert eng.generate(_ids(), 9).shape == (2, 9)
    dense = _engine(tm, "dense", None, draft_model=tw, spec_k=K)
    first = dense.generate(_ids(), 9).numpy()
    assert dense.cache.pos.dim() == 0
    np.testing.assert_array_equal(dense.generate(_ids(), 9).numpy(), first)


def test_sampled_spec_generate_repeats_itself(models):
    _, tm = models["target"]
    _, tw = models["weak"]
    for cache in ("dense", "paged"):
        eng = _engine(tm, cache, None, draft_model=tw, spec_k=2,
                      do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
        a = eng.generate(_ids(), 12, seed=5).numpy()
        np.testing.assert_array_equal(a, eng.generate(_ids(), 12,
                                                      seed=5).numpy())
        assert a.shape == (2, 12) and ((a >= 0) & (a < 97)).all()


def test_sampled_spec_engine_histogram_matches_plain():
    """The first speculative token (position 1) over many seeds has the
    plain sampled engine's distribution (same prompt stream: token 0 is
    the same)."""
    cfg = dict(TGT, vocab_size=13)
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=0).eval()
    td = GPTForCausalLM(GPTConfig(**dict(WEAK, vocab_size=13)),
                        device="cpu", seed=7).eval()
    ids = _ids(s=6, seed=4) % 13
    kw = dict(do_sample=True, temperature=0.9, top_k=8, top_p=0.9)
    plain = _engine(tm, "paged", None, **kw)
    spec = _engine(tm, "paged", None, draft_model=td, spec_k=2, **kw)
    hp, hs = np.zeros(13), np.zeros(13)
    for s in range(200):
        p = plain.generate(ids, 2, seed=s).numpy()
        q = spec.generate(ids, 2, seed=s).numpy()
        np.testing.assert_array_equal(p[:, 0], q[:, 0])
        hp += np.bincount(p[:, 1], minlength=13)
        hs += np.bincount(q[:, 1], minlength=13)
    tv = 0.5 * np.abs(hp / hp.sum() - hs / hs.sum()).sum()
    assert tv < 0.12, (tv, hp, hs)


# ---------------------------------------------------------------------------
# the sampling functions
# ---------------------------------------------------------------------------

def test_accept_greedy_and_truncated_probs_match_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, K + 1, 11)).astype(np.float32)
    tgt = logits.argmax(-1)
    prop = tgt[:, :K].copy()
    for i, cut in enumerate((0, 1, 2, 3, 1, 0)):
        if cut < K:
            prop[i, cut] = (prop[i, cut] + 1 + i) % 11
    prop = prop.astype(np.int32)
    ja, jn = jsampling.spec_accept_greedy(jnp.asarray(logits),
                                          jnp.asarray(prop))
    ta, tn = tsampling.spec_accept_greedy(torch.from_numpy(logits),
                                          torch.from_numpy(prop))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert ta.tolist() == [0, 1, 2, 3, 1, 0]
    for kw in (dict(), dict(temperature=0.7, top_k=4),
               dict(top_p=0.8), dict(temperature=1.3, top_k=6, top_p=0.5),
               dict(top_k=100)):
        want = np.asarray(jsampling.truncated_probs(jnp.asarray(logits),
                                                    **kw))
        got = tsampling.truncated_probs(torch.from_numpy(logits), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_accept_sampled_is_target_distributed():
    """Monte Carlo: the first emitted token of `spec_accept_sampled`
    (the first proposal if accepted, else the correction) follows the
    target row, for a draft that disagrees with it."""
    v, k, n = 7, 2, 4000
    rng = np.random.default_rng(0)
    p1 = tsampling.truncated_probs(torch.from_numpy(
        rng.standard_normal((1, k + 1, v)).astype(np.float32)))
    q1 = tsampling.truncated_probs(torch.from_numpy(
        rng.standard_normal((1, k, v)).astype(np.float32)))
    p, q = p1.expand(n, -1, -1), q1.expand(n, -1, -1)
    seeds = np.arange(n)
    prop = torch.stack([tsampling.draw_rows(
        q[:, j], tsampling.spec_draft_seeds(seeds, np.zeros(n), j))
        for j in range(k)], 1)
    a, nxt = tsampling.spec_accept_sampled(p, q, prop, seeds, np.zeros(n))
    first = torch.where(a > 0, prop[:, 0], nxt).numpy()
    emp = np.bincount(first, minlength=v) / n
    tv = 0.5 * np.abs(emp - p1[0, 0].numpy()).sum()
    assert tv < 0.05, (tv, emp)
    # the streams: a pure function of (seed, position, tag, j), tags apart
    assert tsampling.spec_seed(3, 9, 1) == tsampling.spec_seed(3, 9, 1)
    assert len({tsampling.spec_seed(3, 9, t, j) for t in (1, 2, 3)
                for j in range(3)} | {tsampling.slot_seed(3, 9)}) == 10


def test_accept_sampled_edges():
    """A proposal outside the target's support is rejected; a full accept
    draws the bonus token from the last target row; an all-zero residual
    falls back to the target row."""
    v = 5
    tgt = torch.zeros(3, 3, v)
    tgt[:, :, 0] = 1.0                          # the target: always 0
    drf = torch.zeros(3, 2, v)
    drf[0, :, 2] = 1.0                          # proposes 2: rejected
    drf[1:, :, 0] = 1.0                         # proposes 0: accepted
    prop = torch.tensor([[2, 2], [0, 0], [0, 0]], dtype=torch.int32)
    tgt[2, 2] = 0.0
    tgt[2, 2, 4] = 1.0                          # bonus row: always 4
    a, nxt = tsampling.spec_accept_sampled(tgt, drf, prop, [1, 2, 3],
                                           [0, 0, 0])
    assert a.tolist() == [0, 2, 2] and nxt.tolist() == [0, 0, 4]
    # residual max(p - q, 0) all zero (p == q): the target row itself
    same = torch.full((1, 2, v), 0.2)
    a, nxt = tsampling.spec_accept_sampled(
        same, same[:, :1], torch.tensor([[1]], dtype=torch.int32), [0],
        [0])
    assert 0 <= int(nxt) < v


# ---------------------------------------------------------------------------
# the cache writer, the dense verify and the draft heads
# ---------------------------------------------------------------------------

def test_dense_write_chunk_and_dense_verify_match_the_reference(models):
    rng = np.random.default_rng(3)
    cl = rng.standard_normal((2, 3, 4, 10, 8)).astype(np.float32)
    k = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    v = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    start = np.array([0, 5, 8], np.int32)
    valid = np.array([2, 9, 12], np.int32)
    want = np.asarray(jkv.dense_write_chunk(
        jnp.asarray(cl), jnp.asarray(start), jnp.asarray(valid),
        jnp.asarray(k), jnp.asarray(v)))
    got = torch.from_numpy(cl.copy())
    tkv.dense_write_chunk(got, torch.from_numpy(start),
                          torch.from_numpy(valid), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    # prefill_chunk over a dense cache (the verify), port vs reference
    jm, tm = models["target"]
    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.inference.kv_cache import DenseKVCache as JDense

    ids = _ids(s=12, seed=5)
    jc = JDense(2, 2, 32, 4, 8)
    tc = tkv.DenseKVCache(2, 2, 32, 4, 8, device="cpu")
    jm.gpt.prefill(paddle.to_tensor(ids[:, :8], dtype="int64"), jc,
                   seq_lens=8)
    st = np.array([8, 8], np.int32)
    ln = np.array([12, 10], np.int32)
    jh = jm.gpt.prefill_chunk(
        paddle.to_tensor(ids[:, 8:], dtype="int64"), jc,
        Tensor._wrap(jnp.arange(2, dtype=jnp.int32)),
        Tensor._wrap(jnp.asarray(st)), Tensor._wrap(jnp.asarray(ln)))
    with torch.no_grad():
        tm.gpt.prefill(torch.from_numpy(ids[:, :8]), tc)
        th = tm.gpt.prefill_chunk(torch.from_numpy(ids[:, 8:]), tc,
                                  torch.arange(2, dtype=torch.int32),
                                  torch.from_numpy(st), torch.from_numpy(ln))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh._data),
                               rtol=0, atol=1e-5)
    for jl, tl in zip(jc.layers, tc.layers):
        jl = np.asarray(getattr(jl, "_data", jl))
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5)


def test_draft_logits_match_and_zero_heads_are_the_base_head(models):
    jm, tm = models["heads"]
    h = np.random.default_rng(6).standard_normal((2, 3, 32)) \
        .astype(np.float32)
    want = np.asarray(jm.draft_logits(paddle.to_tensor(h))._data)
    got = tm.draft_logits(torch.from_numpy(h)).detach().numpy()
    assert got.shape == (2, 3, K, 97)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    fresh = GPTForCausalLM(GPTConfig(**TGT, num_draft_heads=2),
                           device="cpu")
    assert all((p == 0).all() for p in fresh.draft_heads.parameters())
    x = torch.from_numpy(h)
    base = fresh.head(x)
    for j in range(2):
        torch.testing.assert_close(fresh.draft_logits(x)[:, :, j], base)


def test_convert_round_trips_the_heads(models):
    _, tm = models["heads"]
    sd = tm.state_dict()
    for model in (tm, None):
        out = convert.state_dict_to_jax(sd, model)
        w = out["draft_heads.1.weight"]
        np.testing.assert_array_equal(w, sd["draft_heads.1.weight"].numpy().T)
        back = convert.state_dict_from_jax(out, model)
        for name, t in sd.items():
            assert torch.equal(back[name], t), name
    assert "draft_heads.0.weight" in convert.linear_weights(tm)


def _head_batch(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 97, (2, 24)), rng.integers(0, 97, (2, 24))


def test_draft_head_loss_and_training_match_the_reference():
    """`loss` with the heads' weighted auxiliary CE, its gradients, and 3
    AdamW `TrainStep`s against the reference's."""
    jm, tm, _ = _pair(dict(TGT, hidden_dropout_prob=0.0), 3, heads=2)
    jm.train()
    tm.train()
    ids, labels = _head_batch()
    ja = [paddle.to_tensor(a, dtype="int64") for a in (ids, labels)]
    ta = [torch.from_numpy(a) for a in (ids, labels)]
    jl = jm.loss(*ja)
    jl.backward()
    tl = tm.loss(*ta)
    tl.backward()
    assert abs(float(jl) - float(tl.detach())) < 1e-5
    grads = convert.state_dict_from_jax(
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}, tm)
    for name, p in tm.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.detach().numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
        if name.startswith("draft_heads"):
            assert np.abs(g).max() > 0
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters(), grad_clip=JClip(1.0))
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jstep = JTrainStep(jm, lambda m, x, y: m.loss(x, y), jopt)
    tstep = TrainStep(tm, lambda m, x, y: m.loss(x, y), topt)
    jls = [float(jstep(*ja)) for _ in range(3)]
    tls = [float(tstep(*ta)) for _ in range(3)]
    assert max(abs(a - b) for a, b in zip(jls, tls)) < 5e-4, (jls, tls)
    want = {k: v.float().numpy() for k, v in convert.state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()},
        tm).items()}
    for name, p in tm.named_parameters():
        got, ref = p.detach().numpy(), want[name]
        assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12) \
            < 5e-3, name


def test_fused_scan_step_adds_the_draft_head_loss():
    """`FusedScanTrainStep` over a scan model with draft heads: the
    trajectory of the port's `TrainStep` over the same model."""
    from paddle_tpu_torch.jit import FusedScanTrainStep

    cfg = GPTConfig(**TGT, scan_layers=True, num_draft_heads=2)
    ids, labels = (torch.from_numpy(a) for a in _head_batch(2))
    out = []
    for fused in (True, False):
        tm = GPTForCausalLM(cfg, device="cpu", seed=4)
        with torch.no_grad():
            for p in tm.draft_heads.parameters():
                p.normal_(0.0, 0.05, generator=torch.Generator()
                          .manual_seed(p.numel()))
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        step = (FusedScanTrainStep(tm, opt, fused_head=True) if fused
                else TrainStep(tm, lambda m, x, y: m.loss(x, y), opt))
        out.append(([float(step(ids, labels)) for _ in range(3)],
                    [p.detach().clone() for p in tm.draft_heads.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=2e-5, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

SKW = dict(max_slots=4, max_len=96, page_size=16, chunk_size=16)
SPEC_COUNTERS = ("spec_dispatches", "spec_proposed", "spec_accepted",
                 "spec_emitted", "spec_accept_rate",
                 "spec_tokens_per_dispatch", "decode_steps", "preemptions")


def _requests(seed=8, lens=(5, 11, 23, 8, 14, 30)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, (n,)).astype(np.int32) for n in lens]


def _serve(eng, prompts, n=12):
    hs = []
    for p in prompts:
        hs.append(eng.submit(p, n))
        eng.step()
    eng.run()
    return [list(h.output_tokens) for h in hs]


@pytest.mark.parametrize("draft,opts", [
    ("weak", dict()), ("strong", dict()), ("weak", dict(kv_quant="int8")),
    ("weak", dict(kv_quant="int4", num_pages=5)),
    ("self", dict(kv_quant="int8"))],
    ids=["weak", "strong", "weak_int8", "weak_int4_preempt", "self_int8"])
def test_serving_spec_matches_the_reference(models, draft, opts):
    """Greedy traffic with mid-flight admission through both engines:
    identical tokens and spec counters, every page and slot back."""
    tgt = {"strong": "strong", "self": "heads"}.get(draft, "target")
    jm, tm = models[tgt]
    jd, td = ({"weak": models["weak"], "strong": models["strong_draft"]}
              [draft] if draft != "self" else ("self", "self"))
    prompts = _requests()
    je = JServing(jm, draft_model=jd, spec_k=K, **SKW, **opts)
    te = ServingEngine(tm, draft_model=td, spec_k=K, device="cpu", **SKW,
                       **opts)
    assert te.scheduler.token_lookahead == K + 1
    jt, tt = _serve(je, prompts), _serve(te, prompts)
    assert tt == jt
    plain = _serve(ServingEngine(tm, device="cpu", **SKW,
                                 **{k: v for k, v in opts.items()}), prompts)
    assert tt == plain
    js, ts = je.metrics_snapshot(), te.metrics_snapshot()
    assert {k: ts[k] for k in SPEC_COUNTERS} == \
        {k: js[k] for k in SPEC_COUNTERS}
    assert ts["spec_dispatches"] > 0
    if draft == "strong":
        assert ts["spec_accept_rate"] == 1.0
    if "num_pages" in opts:
        assert ts["preemptions"] > 0
    text = te.metrics_text()
    assert "serving_spec_accept_rate" in text
    lk = te.leak_check()
    assert lk["free_pages"] == lk["total_pages"]
    assert lk["free_slots"] == lk["total_slots"]
    st = te.cache.pool_stats()
    assert st["used_pages"] == 0
    if te.draft_cache is not None:
        dst = te.draft_cache.pool_stats()
        assert dst["used_pages"] + dst["free_pages"] == dst["total_pages"]
        assert te.draft_cache.quant is None


@pytest.mark.parametrize("opts", [dict(), dict(kv_quant="int4",
                                                num_pages=5)],
                         ids=["fp", "int4_preempt"])
def test_serving_spec_positions_come_from_the_bookkeeping(models, opts):
    """A dispatch takes its pre-dispatch lengths and caps from the
    scheduler, not from the device: they equal the cache's lengths on
    every slot (prefilling, preempted and resumed ones too), a slot that
    does not take part caps at its length, and the lengths the step is
    handed stay on the device between dispatches (no copy back)."""
    _, tm = models["target"]
    _, tw = models["weak"]
    te = ServingEngine(tm, draft_model=tw, spec_k=K, device="cpu", **SKW,
                       **opts)
    step, seen = te.spec_step, {"device_lens": 0, "calls": 0}

    def spy(buffers, meta, tokens, seeds, caps, positions=None):
        lens = meta["seq_lens"]
        seen["device_lens"] += isinstance(lens, torch.Tensor)
        seen["calls"] += 1
        np.testing.assert_array_equal(positions, np.asarray(lens))
        live = set(te.scheduler.decode_slots())
        for slot in range(te.max_slots):
            if slot in live:
                assert 1 <= caps[slot] - positions[slot] <= K + 1
            else:
                assert caps[slot] == positions[slot]
        return step(buffers, meta, tokens, seeds, caps, positions=positions)

    te.spec_step = spy
    out = _serve(te, _requests())
    plain = _serve(ServingEngine(tm, device="cpu", **SKW, **opts),
                   _requests())
    assert out == plain
    assert seen["calls"] > 0 and seen["device_lens"] > seen["calls"] // 2
    if "num_pages" in opts:
        assert te.metrics_snapshot()["preemptions"] > 0


def test_serving_spec_surface(models):
    _, tm = models["target"]
    _, tw = models["weak"]
    e = ServingEngine(tm, draft_model=tw, spec_k=2, device="cpu", **SKW)
    with pytest.raises(ValueError, match="spec_k"):
        e.set_decode_burst(4)
    e.set_decode_burst(1)                   # unchanged: accepted
    e.warmup()
    counts = e.compile_counts()
    assert counts["decode_traces"] == e.spec_step.trace_count > 0
    sampled = []
    for _ in range(2):
        se = ServingEngine(tm, draft_model=tw, spec_k=2, device="cpu",
                           do_sample=True, temperature=0.8, top_k=16,
                           **SKW)
        hs = [se.submit(p, 10, seed=50 + i)
              for i, p in enumerate(_requests(9, (6, 14)))]
        se.run()
        sampled.append([list(h.output_tokens) for h in hs])
    assert sampled[0] == sampled[1]
    e._recover()
    assert e.draft_cache is not None
    h = e.submit(_requests(3, (7,))[0], 5)
    e.run()
    assert h.done and len(h.output_tokens) == 5


@pytest.mark.parametrize("bad,match", [
    (dict(draft_model="typo"), "unknown draft_model"),
    (dict(draft_model="self"), "num_draft_heads"),
    (dict(draft_model="weak", spec_k=0), "spec_k"),
    (dict(draft_model="vocab"), "vocab")])
def test_spec_options_are_validated(models, bad, match):
    _, tm = models["target"]
    d = {"weak": models["weak"][1],
         "vocab": GPTForCausalLM(GPTConfig(**dict(WEAK, vocab_size=31)),
                                 device="cpu")}
    kw = dict(bad, draft_model=d.get(bad["draft_model"],
                                     bad["draft_model"]))
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tm, kind="paged", max_len=64, **kw)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tm, device="cpu", **SKW, **kw)
    _, th = models["heads"]
    with pytest.raises(ValueError, match="num_draft_heads"):
        GenerationEngine(th, kind="paged", max_len=64, draft_model="self",
                         spec_k=K + 1)


# ---------------------------------------------------------------------------
# the CUDA-graph path's control flow, with a stand-in graph on the CPU
# ---------------------------------------------------------------------------

class _StandInGraph:
    """Runs the captured body again at each replay, writing its results
    into the first run's outputs, after checking that the cache still
    binds the tensors the capture saw."""

    def __init__(self, fn, cache):
        self.fn, self.cache = fn, cache
        self.bound = self._bound()
        self.out = fn()
        self.launches = {}

    def _bound(self):
        c = self.cache
        if c.kind == "dense":
            return [t.data_ptr() for t in (c.pos, c.layers[0])]
        return [t.data_ptr() for t in (c.page_tables, c.seq_lens, c.active,
                                       c.k_layers[0])]

    def replay(self):
        assert self._bound() == self.bound, "a replay reads other tensors"
        out = self.fn()
        for d, s in zip(self.out if isinstance(self.out, tuple)
                        else (self.out,),
                        out if isinstance(out, tuple) else (out,)):
            if d is not None:
                d.copy_(s)
        return self.out


@pytest.fixture
def stand_in_graphs(monkeypatch):
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


@pytest.mark.parametrize("cache,draft,sample", [
    ("dense", "weak", False), ("paged", "weak", False),
    ("paged", "self", False), ("dense", "self", False),
    ("paged", "weak", True), ("dense", "self", True)])
def test_spec_graph_path_matches_eager(models, stand_in_graphs, cache,
                                       draft, sample):
    """Speculative ``generate()`` through the graphs (greedy: one graph a
    dispatch; sampled: the draft's graph a draft iteration and the
    verify's) gives the eager steps' tokens and logits over two calls."""
    tm = models["heads" if draft == "self" else "target"][1]
    d = "self" if draft == "self" else models["weak"][1]
    opts = dict(do_sample=True, top_k=20) if sample else {}
    out = {}
    for compiled in (True, False):
        eng = _engine(tm, cache, None, draft_model=d, spec_k=K,
                      compiled=compiled, **opts)
        out[compiled] = (eng.generate(_ids(), 14, return_logits=True, seed=3)
                         + (eng.generate(_ids(seed=4), 9, seed=4),))
        if compiled:
            keys = ([("spec", K, True)] if not sample else
                    [("spec_self",) if draft == "self" else ("spec_draft",),
                     ("spec_verify", K)])
            assert eng.spec_step.cache_size() == len(keys)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    assert [k for k in stand_in_graphs if k[0].startswith("spec")] == keys


def test_serving_spec_graph_path_matches_eager(models, stand_in_graphs):
    _, tm = models["target"]
    _, tw = models["weak"]
    runs = {}
    for compiled in (True, False):
        e = ServingEngine(tm, draft_model=tw, spec_k=K, device="cpu",
                          compiled=compiled, kv_quant="int8", **SKW)
        runs[compiled] = (e, _serve(e, _requests(10)))
    (ge, gt), (_, et) = runs[True], runs[False]
    assert gt == et
    counts = ge.compile_counts()
    assert counts["decode_traces"] == counts["decode_executables"] == 1


def test_selftest_probe_and_constructions_on_the_cpu():
    """The probe that the card smoke run drives passes here; the strong
    pair accepts everything by construction, as does the zero target."""
    from paddle_tpu_torch.inference.spec_decode_selftest import run_probe

    rec = run_probe("cpu")
    assert rec["check"] == "pass", {k: v for k, v in rec.items()
                                    if k != "tokens"}
    tgt, drf = strong_pair(device="cpu")
    assert drf.config.num_layers == 1
    z = zero_self_target(spec_k=2, device="cpu")
    assert len(z.draft_heads) == 2
    assert all((p == 0).all() for p in z.parameters())
