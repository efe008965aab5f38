"""`GPTForCausalLM.generate` of the PyTorch port against the JAX reference.

Both models hold the same numpy weights (`convert.state_dict_from_jax`);
the port runs on the CPU, where the splash prefill and the paged
attention take their kernels' plain versions. Greedy tokens must be
identical for the dense cache, the fp paged cache and the int8 / int4
paged caches, and the logits behind them within 2e-4 (the reference's
own bar for a cached step against the full forward pass).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu_torch import convert
from paddle_tpu_torch.jit import GenerationEngine
from paddle_tpu_torch.jit.decode_step import split_state
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=128)
LOGIT_ATOL = 2e-4
CACHES = [("dense", None), ("paged", None), ("paged", "int8"),
          ("paged", "int4")]


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


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 64, (b, s)) \
        .astype(np.int32)


def _kw(cache, quant):
    return dict(use_cache=cache, **({} if quant is None
                                    else {"kv_quant": quant}))


@pytest.mark.parametrize("cache,quant", CACHES)
def test_greedy_tokens_and_logits_match_reference(models, cache, quant):
    jm, tm = models
    ids = _ids(3, 11)
    jt, jl = jm.generate(ids, 9, return_logits=True, **_kw(cache, quant))
    tt, tl = tm.generate(ids, 9, return_logits=True, **_kw(cache, quant))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 9)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt._data))
    assert tuple(tl.shape) == (3, 9, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_ragged_prompts_on_the_paged_cache(models, quant):
    """Right-padded prompts with their true lengths: each row continues
    its own prompt, as in the reference, and as a row generated alone."""
    jm, tm = models
    ids = _ids(3, 20, seed=1)
    lens = np.asarray([20, 7, 13], np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    kw = _kw("paged", quant)
    want = np.asarray(jm.generate(ids, 8, seq_lens=lens, **kw)._data)
    got = tm.generate(ids, 8, seq_lens=lens, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    alone = tm.generate(ids[1:2, :7], 8, **kw).numpy()
    np.testing.assert_array_equal(got[1:2], alone)


@pytest.mark.parametrize("cache,quant", CACHES)
def test_engine_reuse_is_bit_identical(models, cache, quant):
    """Three calls on one cached engine give the same tokens: slots come
    back in order and the cache carries nothing over between calls."""
    _, tm = models
    tm.__dict__.pop("_generation_engines", None)
    ids = _ids(2, 9, seed=2)
    outs = [tm.generate(ids, 12, **_kw(cache, quant)) for _ in range(3)]
    engines = list(tm._generation_engines.values())
    assert len(engines) == 1
    assert (engines[0].kind, engines[0].kv_quant) == (cache, quant)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_engines_are_keyed_and_bounded(models):
    _, tm = models
    tm.__dict__.pop("_generation_engines", None)
    ids = _ids(1, 5)
    tm.generate(ids, 3, use_cache="paged")
    tm.generate(ids, 3, use_cache="paged")          # same key: reused
    assert len(tm._generation_engines) == 1
    tm.generate(ids, 3, use_cache="paged", kv_quant="int8")
    tm.generate(_ids(2, 5), 3, use_cache="paged")
    tm.generate(ids, 80, use_cache="paged")         # capacity 128, not 64
    tm.generate(ids, 3, use_cache="dense")
    engines = tm._generation_engines
    assert len(engines) == 4                        # oldest evicted
    assert [e.max_len for e in engines.values()] == [64, 64, 128, 64]


def test_kv_quant_needs_the_paged_cache(models):
    jm, tm = models
    ids = _ids(1, 5)
    with pytest.raises(ValueError, match="paged"):
        jm.generate(ids, 3, use_cache="dense", kv_quant="int8")
    with pytest.raises(ValueError, match="paged"):
        tm.generate(ids, 3, use_cache="dense", kv_quant="int8")
    with pytest.raises(ValueError, match="aligned"):
        tm.generate(_ids(2, 6), 3, seq_lens=[6, 4])
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(ids, 200)


@pytest.mark.parametrize("cache,quant", [("dense", None),
                                         ("paged", "int4")])
def test_seeded_sampling_repeats_itself(models, cache, quant):
    """Sampling draws from one generator seeded with ``seed``: the same
    seed repeats the tokens, another seed gives others."""
    _, tm = models
    ids = _ids(2, 6, seed=3)
    kw = dict(do_sample=True, top_k=20, top_p=0.9, temperature=1.5,
              **_kw(cache, quant))
    a = tm.generate(ids, 16, seed=7, **kw)
    b = tm.generate(ids, 16, seed=7, **kw)
    c = tm.generate(ids, 16, seed=8, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < CFG["vocab_size"]


def test_eos_fills_the_rest_of_the_row(models):
    jm, tm = models
    ids = _ids(2, 8, seed=4)
    free = tm.generate(ids, 10, use_cache="paged").numpy()
    eos = int(free[0, 3])
    want = np.asarray(jm.generate(ids, 10, use_cache="paged",
                                  eos_token_id=eos)._data)
    got = tm.generate(ids, 10, use_cache="paged", eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0] == eos))
    assert (got[0, first:] == eos).all()


def test_later_slices_raise(models):
    _, tm = models
    # speculative decoding is ported: a draft model constructs and runs
    # (greedy: the plain tokens), "self" without draft heads raises the
    # reference's ValueError
    spec = GenerationEngine(tm, kind="paged", draft_model=tm, spec_k=2,
                            batch=2, max_len=32)
    plain = GenerationEngine(tm, kind="paged", batch=2, max_len=32)
    np.testing.assert_array_equal(spec.generate(_ids(2, 4), 5).numpy(),
                                  plain.generate(_ids(2, 4), 5).numpy())
    with pytest.raises(ValueError, match="num_draft_heads"):
        GenerationEngine(tm, kind="paged", draft_model="self")
    with pytest.raises(ValueError, match="cache kind"):
        GenerationEngine(tm, kind="ring")
    eng = GenerationEngine(tm, kind="paged", kv_quant="int4", batch=2,
                           max_len=32, compiled=False)
    with pytest.raises(ValueError, match="engine batch"):
        eng.generate(_ids(1, 4), 3)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(_ids(2, 30), 3)
    from paddle_tpu_torch.inference import kv_cache as tkv
    with pytest.raises(NotImplementedError, match="A8"):
        eng.cache.export_slot(0)
    with pytest.raises(NotImplementedError, match="A8"):
        tkv.blob_checksum({})


def test_failed_step_rebuilds_the_cache(models, monkeypatch):
    """A step that raises leaves a fresh cache behind, and the next call
    gives the undisturbed tokens."""
    _, tm = models
    ids = _ids(2, 6, seed=5)
    eng = GenerationEngine(tm, kind="paged", kv_quant="int8", batch=2,
                           max_len=32)
    want = eng.generate(ids, 6)
    step = eng.decode_step
    monkeypatch.setattr(eng, "decode_step", lambda *a: 1 / 0)
    broken = eng.cache
    with pytest.raises(ZeroDivisionError):
        eng.generate(ids, 6)
    assert eng.cache is not broken and not eng.cache._slot_pages
    monkeypatch.setattr(eng, "decode_step", step)
    assert torch.equal(eng.generate(ids, 6), want)


def test_masked_multihead_attention_matches_reference():
    """The dense decode step's attention: the token's K/V land at the
    shared position, and q attends the cache up to it, as in the
    reference; arguments the dense step does not pass are refused."""
    from paddle_tpu.incubate.nn import functional as jif
    from paddle_tpu_torch.incubate.nn import functional as tif

    rng = np.random.default_rng(6)
    b, nh, ms, d, pos = 3, 4, 12, 8, 5
    x = rng.standard_normal((b, 3 * nh * d)).astype(np.float32)
    cache = rng.standard_normal((2, b, nh, ms, d)).astype(np.float32)
    jo, jc = jif.masked_multihead_attention(
        paddle.to_tensor(x), paddle.to_tensor(cache), sequence_lengths=pos)
    tc = torch.from_numpy(cache.copy())
    to, tc_out = tif.masked_multihead_attention(
        torch.from_numpy(x), tc, sequence_lengths=torch.tensor(pos))
    assert tc_out is tc                       # written in place
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), rtol=0,
                               atol=1e-5)
    # a src_mask and ragged positions, which the dense step does not
    # pass, as the reference takes them (tests/test_torch_quant.py holds
    # every combination)
    tx = torch.from_numpy(x)
    mask = rng.standard_normal((b, 1, 1, ms)).astype(np.float32)
    ragged = np.asarray([1, 2, 3], np.int32)
    jo, jc = jif.masked_multihead_attention(
        paddle.to_tensor(x), jc, sequence_lengths=paddle.to_tensor(ragged),
        src_mask=paddle.to_tensor(mask))
    to, _ = tif.masked_multihead_attention(
        tx, tc, sequence_lengths=torch.from_numpy(ragged),
        src_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="sequence_lengths"):
        tif.masked_multihead_attention(tx, tc)


# ---------------------------------------------------------------------------
# the dense cache's position on the device, and weight-only int8 decoding
# ---------------------------------------------------------------------------

def test_dense_steps_read_nothing_back_to_the_host(models, monkeypatch):
    """The dense cache's write position is a device int32 scalar, as the
    reference's is: the prompt pass sets it and each decode step advances
    it without a host read (``item``, ``int()`` and ``tolist`` of a tensor
    raise here), and the tokens are `generate()`'s."""
    _, tm = models
    eng = GenerationEngine(tm, kind="dense", batch=2, max_len=32)
    assert eng.cache.pos.dtype == torch.int32 and eng.cache.pos.dim() == 0
    ids = _ids(2, 5, seed=6)
    want = eng.generate(ids, 4)
    buffers, meta = split_state("dense", eng.cache.state())
    meta["pos"].fill_(9)                    # a stale position: reset

    def host_read(*args, **kwargs):
        raise AssertionError("a dense step read a tensor back to the host")

    for name in ("item", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    padded = np.concatenate([ids, np.zeros((2, 11), ids.dtype)], axis=1)
    tok, _, buffers, meta = eng.prefill_step(
        buffers, meta, padded, np.full((2,), 5, np.int32),
        np.arange(2, dtype=np.int32))
    toks = [tok]
    for _ in range(3):
        tok, _, buffers, meta = eng.decode_step(buffers, meta, tok)
        toks.append(tok)
    monkeypatch.undo()
    pos = meta["pos"]
    assert isinstance(pos, torch.Tensor) and pos.dtype == torch.int32
    assert pos.dim() == 0 and int(pos) == 5 + 3
    assert torch.equal(torch.stack(toks, 1).int(), want)


QCFG = dict(CFG, tie_word_embeddings=False)


@pytest.fixture(scope="module")
def quant_models():
    """(reference, port) untied GPTs holding the same numpy weights, both
    through `quantize_for_decode` (its default names: every projection
    and the LM head)."""
    from paddle_tpu.nn.quant import quantize_for_decode as jquant
    from paddle_tpu_torch.nn.quant import quantize_for_decode as tquant

    paddle.seed(0)
    jm = JModel(JConfig(**QCFG))
    jm.eval()
    rng = np.random.default_rng(1)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = (0.1 * a if name.endswith("bias")
             else 1.0 + 0.1 * a if p.ndim == 1 else 0.3 * a)
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**QCFG), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named))
    return jquant(jm), tquant(tm)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_weights_match_reference(quant_models, cache):
    """Greedy tokens through the int8 weight-only model equal the
    reference's quantized model's, the logits within 2e-4, and the swap
    builds a new engine (the parameters' names changed)."""
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear

    jm, tm = quant_models
    assert isinstance(tm.lm_head, WeightOnlyLinear)
    assert isinstance(tm.gpt.blocks[1].mlp.fc2, WeightOnlyLinear)
    ids = _ids(3, 10, seed=7)
    jt, jl = jm.generate(ids, 8, return_logits=True, use_cache=cache)
    tt, tl = tm.generate(ids, 8, return_logits=True, use_cache=cache)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt._data))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), rtol=0,
                               atol=LOGIT_ATOL)


def test_quantize_for_decode_makes_a_new_engine():
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    tm = GPTForCausalLM(GPTConfig(**QCFG), device="cpu")
    ids = _ids(2, 6, seed=8)
    fp = tm.generate(ids, 5)
    (before,) = tm._generation_engines.values()
    quantize_for_decode(tm)
    q = tm.generate(ids, 5)
    assert len(tm._generation_engines) == 2
    assert tm._generation_engines[list(tm._generation_engines)[-1]] \
        is not before
    assert q.shape == fp.shape
