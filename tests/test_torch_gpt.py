"""GPT of the PyTorch port against the JAX reference, same weights.

Weights are drawn with numpy from a seed, set on the reference model
and carried into the port by `convert.state_dict_from_jax`. The full
forward, the chunked prefill and three decode steps over the paged
cache must give the reference's logits within 2e-4 (fp32; the bar of
the reference's own chunked-prefill test), and the converter's round
trip must be bit-exact.
"""
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

ATOL = 2e-4
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=96)


def make_models(seed=0, **over):
    """(reference model, port model) holding the same numpy weights."""
    cfg = {**CFG, **over}
    paddle.seed(0)
    jm = JModel(JConfig(**cfg))
    jm.eval()
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if name.endswith("bias"):
            a *= 0.1
        elif p.ndim == 1:                        # LayerNorm scale
            a = 1.0 + 0.1 * a
        else:
            a *= 0.3
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named))
    return jm, tm, named


@pytest.fixture(scope="module")
def models():
    return make_models()


def test_parameter_names_match(models):
    jm, tm, _ = models
    assert [n for n, _ in jm.named_parameters()] == \
        [n for n, _ in tm.named_parameters()]


def test_convert_round_trip_is_bit_exact(models):
    _, tm, named = models
    back = convert.state_dict_to_jax(tm.state_dict())
    assert back.keys() == named.keys()
    for name, a in named.items():
        assert back[name].dtype == a.dtype
        np.testing.assert_array_equal(back[name], a)
    # Linear weights change layout, nothing else does
    sd = tm.state_dict()
    assert tuple(sd["gpt.blocks.0.attn.qkv.weight"].shape) == (96, 32)
    assert torch.equal(sd["gpt.wte.weight"],
                       torch.from_numpy(named["gpt.wte.weight"]))


def test_convert_round_trip_bf16():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(3)
    named = {
        "gpt.wte.weight": rng.standard_normal((5, 4)),
        "gpt.blocks.0.mlp.fc1.weight": rng.standard_normal((4, 6)),
    }
    named = {k: v.astype(ml_dtypes.bfloat16) for k, v in named.items()}
    sd = convert.state_dict_from_jax(named)
    assert sd["gpt.blocks.0.mlp.fc1.weight"].dtype == torch.bfloat16
    back = convert.state_dict_to_jax(sd)
    for k, v in named.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k].view(np.uint16),
                                      v.view(np.uint16))


def test_forward_logits_match(models):
    jm, tm, _ = models
    ids = np.random.default_rng(1).integers(0, 64, (2, 21))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int64)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_prefill_chunks_then_decode_logits_match(models):
    """Two prompts chunk-prefilled together (8-token chunks, the second
    prompt ends mid-chunk), then three decode steps: every step's logits
    equal the reference's, and the last prefill logits equal the full
    forward's."""
    jm, tm, _ = models
    kw = dict(max_slots=2, max_len=64, page_size=8, chunk_size=8,
              prefill_batch=2)
    je = JEngine(jm, **kw)
    te = ServingEngine(tm, device="cpu", **kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32)
               for n in (19, 13)]
    slots = []
    for p in prompts:
        js, ts = je.cache.allocate(len(p)), te.cache.allocate(len(p))
        assert js == ts
        slots.append(js)
    for start in range(0, 24, 8):
        ids = np.zeros((2, 8), np.int32)
        lens = np.zeros(2, np.int32)
        for j, p in enumerate(prompts):
            chunk = p[start:start + 8]
            ids[j, :len(chunk)] = chunk
            lens[j] = min(len(p), start + 8)
        st = np.minimum(start, lens)
        args = (ids, np.asarray(slots, np.int32), st.astype(np.int32),
                lens, np.zeros(2, np.uint32))
        jt, jl, jb, jmeta = je.prefill_step(
            je._param_data(), je._buffers, je._meta(), *args)
        je._commit(jb, jmeta)
        tt, tl, tb, tmeta = te.prefill_step(te._buffers, te._meta(), *args)
        te._commit(tb, tmeta)
        done = [start < len(p) <= start + 8 for p in prompts]
        got, want = tl.numpy(), np.asarray(jl)
        np.testing.assert_allclose(got[done], want[done], rtol=0,
                                   atol=ATOL)
    with torch.no_grad():
        full = tm(torch.from_numpy(prompts[0][None].astype(np.int64)))
    np.testing.assert_allclose(tl.numpy()[0], full.numpy()[0, -1],
                               rtol=0, atol=ATOL)
    for eng in (je, te):
        for s in slots:
            eng.cache.set_active(s, True)
    tokens = np.asarray(tt.numpy(), np.int32)
    seeds = np.zeros(2, np.uint32)
    for _ in range(3):
        jo, jl, jb, jmeta = je.decode_step(
            je._param_data(), je._buffers, je._meta(), tokens, seeds)
        je._commit(jb, jmeta)
        to, tl, tb, tmeta = te.decode_step(te._buffers, te._meta(),
                                           tokens, seeds)
        te._commit(tb, tmeta)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        tokens = to.numpy()[-1]
    np.testing.assert_array_equal(np.asarray(te.cache.seq_lens),
                                  np.asarray(je.cache.seq_lens))


def test_init_from_seed_is_reproducible():
    cfg = GPTConfig(**CFG)
    a = GPTForCausalLM(cfg, device="cpu", seed=5).state_dict()
    b = GPTForCausalLM(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["gpt.blocks.0.attn.qkv.bias"] == 0)
    assert torch.all(a["gpt.ln_f.weight"] == 1)


def test_full_attention_refuses_the_card():
    """Full-sequence attention off the CPU at ``FLAGS_pallas_flash_min_seqlen``
    tokens and above goes to the splash kernel and nowhere else: on
    ``meta`` tensors (neither CPU nor CUDA) the splash wrapper's device
    check raises, so no plain attention runs there. Below it the dense
    attention runs on any device, as in the reference."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    q = torch.zeros(1, 1024, 4, 8, device="meta")
    with pytest.raises(ValueError, match="splash_attention: no kernel for "
                                         "meta"):
        scaled_dot_product_attention(q, q, q, is_causal=True)
    q3 = torch.zeros(1, 3, 4, 8, device="meta")
    out = scaled_dot_product_attention(q3, q3, q3, is_causal=True)
    assert out.device.type == "meta" and out.shape == q3.shape
