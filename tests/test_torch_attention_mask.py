"""Masked attention and attention dropout of the PyTorch port against the
JAX package: the dense path of ``scaled_dot_product_attention`` (which
the card runs as aten ops, as the reference runs its XLA ``_sdpa_ref``),
``flash_attn_unpadded``, ``flash_attn_varlen_qkvpacked`` and
``flash_attention_with_sparse_mask``.

Inputs are numpy arrays from a seed, handed to both. Bars: fp32 forward
within 1e-5, bf16 within 2e-2 (one bf16 rounding of the scores and of
the probabilities, in the same places on both sides), fp32 gradients of
q, k and v within 1e-4 of the reference's largest gradient element
(fp32 sums in another order).

Dropout is held to its contract, not bit for bit (torch generators and
JAX's threefry never agree): the kept share of the probabilities within
4 sigma of ``1 - p``, kept values scaled by ``1 / (1 - p)``, the same
generator seed giving the same output and another seed another output,
and ``training=False`` equal to ``dropout_p=0`` bit for bit.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch
from paddle_tpu_torch.nn import functional as PF

FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_REL = 1e-4
B, S, H, D = 2, 16, 4, 8


@pytest.fixture
def splash_off():
    """The splash flag off in both packages (segments take the dense
    mask), restored after the test."""
    saved = paddle_tpu_torch.get_flags("FLAGS_splash_attn")
    jsaved = paddle.get_flags(["FLAGS_splash_attn"])
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": False})
    paddle.set_flags({"FLAGS_splash_attn": False})
    yield
    paddle_tpu_torch.set_flags(saved)
    paddle.set_flags(jsaved)


def _qkv(shape_q, shape_kv=None, seed=0):
    rng = np.random.default_rng(seed)
    shape_kv = shape_kv or shape_q
    return [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


def _masks(seed=1):
    """name -> (numpy mask, needs causal)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((B, H, S, S)) > 0.4
    keep[..., np.arange(S), np.arange(S)] = True   # no row fully masked
    additive = rng.standard_normal((B, H, S, S)).astype(np.float32)
    additive[~keep] = -1e9
    lengths = np.array([S, 9])
    padding = np.where(np.arange(S)[None] < lengths[:, None], 0.0,
                       -1e9).astype(np.float32)[:, None, None, :]
    return {"bool": (keep, False), "additive": (additive, False),
            "padding [b, 1, 1, s]": (padding, False),
            "causal + bool": (keep, True)}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(fn_jax, fn_port, arrays, dtype, grads=True, seed=99):
    """The reference's and the port's outputs on ``arrays`` (q, k, v
    first, the rest as given); with ``grads`` (fp32), their q/k/v
    gradients under one random cotangent."""
    jin = [paddle.to_tensor(a, stop_gradient=i >= 3)
           for i, a in enumerate(arrays)]
    tin = [torch.tensor(a, requires_grad=i < 3) if i < 3
           else torch.from_numpy(a) for i, a in enumerate(arrays)]
    if dtype == torch.bfloat16:
        jin = [x.astype("bfloat16") if i < 3 else x
               for i, x in enumerate(jin)]
        tin = [x.bfloat16() if i < 3 else x for i, x in enumerate(tin)]
        grads = False
    jout, tout = fn_jax(*jin), fn_port(*tin)
    want = np.asarray(jout._data.astype("float32"))
    got = tout.detach().float().numpy()
    assert got.shape == want.shape
    out = {"forward": np.abs(got - want).max()}
    if grads:
        c = np.random.default_rng(seed).standard_normal(want.shape).astype(
            np.float32)
        (jout * paddle.to_tensor(c)).sum().backward()
        (tout * torch.from_numpy(c)).sum().backward()
        out["grads"] = max(_rel(t.grad.numpy(), np.asarray(j.grad._data))
                           for j, t in zip(jin[:3], tin[:3]))
    return out


def _assert(errs, dtype):
    assert errs["forward"] <= FWD_TOL[dtype], errs
    if "grads" in errs:
        assert errs["grads"] <= GRAD_REL, errs


# ---------------------------------------------------------------------------
# scaled_dot_product_attention's dense path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_masks()))
def test_sdpa_with_a_mask_matches_jax(case, dtype):
    mask, causal = _masks()[case]
    q, k, v = _qkv((B, S, H, D))
    errs = _both(
        lambda q, k, v, m: JF.scaled_dot_product_attention(
            q, k, v, attn_mask=m, is_causal=causal),
        lambda q, k, v, m: PF.scaled_dot_product_attention(
            q, k, v, attn_mask=m, is_causal=causal),
        [q, k, v, mask], dtype)
    _assert(errs, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_gqa_with_a_mask_equals_jax_over_repeated_kv(dtype):
    """Two KV heads for four query heads: the port repeats each KV head
    for its group, and the mask broadcasts over the repeated heads; the
    reference's dense path takes one head count, so it gets K/V with the
    heads repeated."""
    mask, _ = _masks()["additive"]
    q, k, v = _qkv((B, S, H, D), (B, S, 2, D))
    rep = [np.repeat(a, 2, axis=2) for a in (k, v)]
    jin = [paddle.to_tensor(a) for a in (q, *rep, mask)]
    tin = [torch.from_numpy(a) for a in (q, k, v, mask)]
    if dtype == torch.bfloat16:
        jin = [x.astype("bfloat16") for x in jin[:3]] + jin[3:]
        tin = [x.bfloat16() for x in tin[:3]] + tin[3:]
    want = np.asarray(JF.scaled_dot_product_attention(
        *jin[:3], attn_mask=jin[3])._data.astype("float32"))
    got = PF.scaled_dot_product_attention(*tin[:3], attn_mask=tin[3])
    assert np.abs(got.float().numpy() - want).max() <= FWD_TOL[dtype]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_dense_segment_mask_with_splash_off(causal, dtype, splash_off):
    q, k, v = _qkv((B, S, H, D))
    seg = np.repeat(np.array([[0, 1, 2, 3], [5, 5, 6, 6]]), S // 4,
                    axis=1).astype(np.int32)
    errs = _both(
        lambda q, k, v, s: JF.scaled_dot_product_attention(
            q, k, v, is_causal=causal, segment_ids=s),
        lambda q, k, v, s: PF.scaled_dot_product_attention(
            q, k, v, is_causal=causal, segment_ids=s),
        [q, k, v, seg], dtype)
    _assert(errs, dtype)


def test_a_fully_masked_row_is_nan_in_both_packages():
    """A bool mask that hides every key of a row gives NaN there, in the
    reference and in the port: neither adds a guard."""
    q, k, v = _qkv((1, 4, 1, 8))
    mask = np.ones((1, 1, 4, 4), bool)
    mask[0, 0, 2] = False
    want = np.asarray(JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        attn_mask=paddle.to_tensor(mask))._data)
    got = PF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask)).numpy()
    assert np.isnan(want[0, 2]).all() and np.isnan(got[0, 2]).all()
    np.testing.assert_allclose(np.delete(got, 2, axis=1),
                               np.delete(want, 2, axis=1), atol=1e-5)


def test_bf16_padding_mask_gives_padded_keys_zero_probability():
    """-1e9 cast to bf16 is finite: a padded key's probability is exactly
    0, so the padded values cannot reach the output."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, S, 2, D)))
    mask = torch.zeros(1, 1, 1, S)
    mask[..., 10:] = -1e9
    v2 = v.clone()
    v2[:, 10:] = 1e4
    a = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    b = PF.scaled_dot_product_attention(q, k, v2, attn_mask=mask)
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the varlen and sparse-mask functionals
# ---------------------------------------------------------------------------

CU_Q = np.array([0, 5, 14, 16], np.int32)
CU_K = {"same": CU_Q, "shorter keys": np.array([0, 3, 12, 12], np.int32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("keys", list(CU_K))
def test_flash_attn_unpadded_matches_jax(keys, causal, dtype):
    """Three packed sequences; with "shorter keys" the last query
    sequence has no key: the empty-row guard gives 0 there."""
    cu_k = CU_K[keys]
    q, k, v = _qkv((16, H, D), (int(cu_k[-1]), H, D))
    scale = 1.0 / D ** 0.5

    def run(F):
        def fn(q, k, v, cq, ck):
            return F.flash_attn_unpadded(q, k, v, cq, ck, 9, 9, scale,
                                         causal=causal)[0]
        return fn

    errs = _both(run(JF), run(PF), [q, k, v, CU_Q, cu_k], dtype)
    _assert(errs, dtype)
    if keys == "shorter keys":
        out = PF.flash_attn_unpadded(*(torch.from_numpy(a) for a in (q, k, v)),
                                     CU_Q, cu_k, 9, 9, scale)[0]
        assert torch.equal(out[14:], torch.zeros_like(out[14:]))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_varlen_qkvpacked_matches_jax(causal):
    qkv = np.random.default_rng(3).standard_normal((16, 3, H, D)).astype(
        np.float32)
    scale = 1.0 / D ** 0.5
    want = np.asarray(JF.flash_attn_varlen_qkvpacked(
        paddle.to_tensor(qkv), paddle.to_tensor(CU_Q), paddle.to_tensor(CU_Q),
        9, 9, scale, causal=causal)[0]._data)
    got = PF.flash_attn_varlen_qkvpacked(
        torch.from_numpy(qkv), torch.from_numpy(CU_Q),
        torch.from_numpy(CU_Q), 9, 9, scale, causal=causal)[0]
    assert np.abs(got.numpy() - want).max() <= FWD_TOL[torch.float32]


@pytest.mark.parametrize("heads", [1, H])
def test_flash_attention_with_sparse_mask_matches_jax(heads):
    q, k, v = _qkv((B, S, H, D))
    rows = np.random.default_rng(4).integers(1, S + 1, (B, heads, S)) \
        .astype(np.int32)
    errs = _both(
        lambda q, k, v, r: JF.flash_attention_with_sparse_mask(q, k, v, r),
        lambda q, k, v, r: PF.flash_attention_with_sparse_mask(q, k, v, r),
        [q, k, v, rows], torch.float32)
    _assert(errs, torch.float32)


# ---------------------------------------------------------------------------
# the dropout contract
# ---------------------------------------------------------------------------

def _dropout_probe(p, seed, s=64, heads=4, b=4, **kw):
    """SDPA over zero q and k (every probability ``1 / s``) and V the
    identity over the keys, so each output element is one key's
    probability after dropout: ``1 / (s (1 - p))`` kept, 0 dropped."""
    q = torch.zeros(b, s, heads, s)
    v = torch.eye(s)[None, :, None, :].expand(b, s, heads, s).contiguous()
    g = torch.Generator().manual_seed(seed)
    return PF.scaled_dot_product_attention(q, q, v, dropout_p=p,
                                           generator=g, **kw)


def test_dropout_keep_rate_and_scaling():
    p, s = 0.1, 64
    out = _dropout_probe(p, seed=0, s=s)
    kept = out > 0
    share = float(kept.float().mean())
    sigma = (p * (1 - p) / out.numel()) ** 0.5
    assert abs(share - (1 - p)) < 4 * sigma, (share, sigma)
    torch.testing.assert_close(out[kept], torch.full_like(
        out[kept], 1.0 / (s * (1 - p))), rtol=1e-6, atol=0)


def test_dropout_generator_determinism_and_eval():
    a, b = _dropout_probe(0.1, seed=7), _dropout_probe(0.1, seed=7)
    assert torch.equal(a, b)
    assert not torch.equal(a, _dropout_probe(0.1, seed=8))
    assert torch.equal(_dropout_probe(0.1, seed=7, training=False),
                       _dropout_probe(0.0, seed=7))
    # flash_attention and the packed form thread the generator too
    qkv = torch.randn(2, 16, 3, 2, 8, generator=torch.Generator()
                      .manual_seed(0))
    outs = [PF.flash_attn_qkvpacked(qkv, dropout=0.5, generator=torch
                                    .Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    ref = PF.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             dropout=0.5, generator=torch.Generator()
                             .manual_seed(1))[0]
    assert torch.equal(ref, outs[0])


def test_varlen_dropout_follows_its_generator():
    q, k, v = (torch.from_numpy(a) for a in _qkv((16, H, D)))
    run = [PF.flash_attn_unpadded(q, k, v, CU_Q, CU_Q, 9, 9, 0.3,
                                  dropout=0.2, generator=torch.Generator()
                                  .manual_seed(s))[0] for s in (3, 3, 4)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
    off = PF.flash_attn_unpadded(q, k, v, CU_Q, CU_Q, 9, 9, 0.3, dropout=0.2,
                                 training=False)[0]
    assert torch.equal(off, PF.flash_attn_unpadded(q, k, v, CU_Q, CU_Q, 9, 9,
                                                   0.3)[0])
